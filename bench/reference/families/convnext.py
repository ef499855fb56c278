"""ConvNeXt (Liu et al., "A ConvNet for the 2020s", arXiv:2201.03545,
section 2 and Fig. 4): a ``stem_kernel`` / ``stem_stride`` conv and a
LayerNorm; per stage after the first a LayerNorm and a ``down_kernel`` /
``down_stride`` conv; ``depths[s]`` blocks of a ``dw_kernel`` depthwise
conv, a LayerNorm over the channels, a 1x1 conv to ``mlp_ratio`` times the
width, the exact (erf) GELU, a 1x1 conv back, a per-channel layer scale
``gamma`` and the residual add; then a global average pool, a LayerNorm
and the dense head.  Every LayerNorm takes ``ln_eps``.

The activations are signed, so every requantization keeps the sign: the
stem's output, each LayerNorm's output before a conv down, each conv
down's output, and in each block the LayerNorm's and the GELU's outputs
and the residual stream after the add.  The convs are named ``stem``,
``stages.<s>.down`` and ``stages.<s>.blocks.<i>.{dw,pw1,pw2}``; the
LayerNorms ``stem_norm``, ``stages.<s>.down_norm``,
``stages.<s>.blocks.<i>.norm`` and ``head_norm``, each with a scale ``g``
and a shift ``b``."""

from __future__ import annotations

import torch.nn.functional as F

NORM_SCALE = (1.0, 0.1)    # a LayerNorm's g: (mean, std)
LAYER_SCALE = (0.5, 0.1)   # a block's gamma: (mean, std)


def _layers(config):
    """Each weighted layer in the plan's order: ("conv", name, K, cin,
    cout, stride, depthwise), ("norm", name, width) or ("gamma", name,
    width)."""
    dims, c = config["dims"], config["in_channels"]
    yield "conv", "stem", config["stem_kernel"], c, dims[0], \
        config["stem_stride"], False
    yield "norm", "stem_norm", dims[0]
    for s, (depth, d) in enumerate(zip(config["depths"], dims)):
        if s > 0:
            yield "norm", f"stages.{s}.down_norm", dims[s - 1]
            yield "conv", f"stages.{s}.down", config["down_kernel"], \
                dims[s - 1], d, config["down_stride"], False
        for i in range(depth):
            pre, wide = f"stages.{s}.blocks.{i}", config["mlp_ratio"] * d
            yield "conv", pre + ".dw", config["dw_kernel"], d, d, 1, True
            yield "norm", pre + ".norm", d
            yield "conv", pre + ".pw1", 1, d, wide, 1, False
            yield "conv", pre + ".pw2", 1, wide, d, 1, False
            yield "gamma", pre + ".gamma", d
    yield "norm", "head_norm", dims[-1]


def conv_layers(config: dict) -> list[tuple[str, int, int, int, int]]:
    return [layer[1:6] for layer in _layers(config) if layer[0] == "conv"]


def head_width(config: dict) -> int:
    return config["dims"][-1]


def weight_shapes(config: dict) -> dict[str, tuple[int, ...]]:
    """Each conv's HWIO kernel (K x K x 1 x C for a depthwise one) and
    bias, each LayerNorm's g and b and each block's gamma, in the plan's
    order, then the dense head."""
    shapes = {}
    for kind, name, *rest in _layers(config):
        if kind == "conv":
            K, cin, cout, _, depthwise = rest
            shapes[name + ".w"] = (K, K, 1 if depthwise else cin, cout)
            shapes[name + ".b"] = (cout,)
        elif kind == "norm":
            shapes[name + ".g"] = shapes[name + ".b"] = (rest[0],)
        else:
            shapes[name] = (rest[0],)
    shapes["head.w"] = (head_width(config), config["n_classes"])
    shapes["head.b"] = (config["n_classes"],)
    return shapes


def weight_init(name: str, shape) -> tuple[float, float] | None:
    """LayerNorm scales around 1 and layer scales around 0.5; the rest
    keep the benchmark's default draw."""
    if name.endswith(".g"):
        return NORM_SCALE
    if name.endswith(".gamma"):
        return LAYER_SCALE
    return None


def forward(config: dict, weights: dict, images, conv, requant):
    b, eps = weights, config["ln_eps"]

    def ln(name, x):
        return F.layer_norm(x, x.shape[-1:], b[name + ".g"], b[name + ".b"],
                            eps)

    def q(x):
        return requant(x, relu=False)

    x = q(ln("stem_norm", conv("stem", images, config["stem_stride"])
             + b["stem.b"]))
    for s, depth in enumerate(config["depths"]):
        if s > 0:
            down = f"stages.{s}.down"
            x = q(ln(down + "_norm", x))
            x = q(conv(down, x, config["down_stride"]) + b[down + ".b"])
        for i in range(depth):
            pre = f"stages.{s}.blocks.{i}"
            h = conv(pre + ".dw", x, 1) + b[pre + ".dw.b"]
            h = q(ln(pre + ".norm", h))
            h = q(F.gelu(conv(pre + ".pw1", h, 1) + b[pre + ".pw1.b"]))
            h = conv(pre + ".pw2", h, 1) + b[pre + ".pw2.b"]
            x = q(x + b[pre + ".gamma"] * h)
    return ln("head_norm", x.mean(dim=(1, 2))) @ b["head.w"] + b["head.b"]
