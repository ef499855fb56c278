"""The configurations' networks in plain PyTorch: NHWC activations, HWIO
weights, SAME padding on XLA's convention (the low side gets the smaller
half), VALID max pools, a global average pool and a dense head.

`forward` walks a configuration's layer plan and leaves each conv and each
requantization to the caller, so that one walk serves the plain forward,
the forward that follows the program stage by stage (`check`), and the
shape walk of the cost model (`bench/costs.py`).  Layers are named by the
path of their weights, ``convs.3`` or ``stages.1.0.0.c2``: the names under
which the benchmark draws the weights that it hands to both sides.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, stride: int):
    """SAME conv of NHWC ``x`` with an HWIO kernel, NHWC out."""
    K = w_hwio.shape[0]
    (h0, h1), (w0, w1) = (same_pads(x.shape[1], K, stride),
                          same_pads(x.shape[2], K, stride))
    xn = F.pad(x.permute(0, 3, 1, 2), (w0, w1, h0, h1))
    y = F.conv2d(xn, w_hwio.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def maxpool(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    if min(x.shape[1], x.shape[2]) < 2:  # the plan pools only a 2x2 map up
        return x
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def conv_layers(config: dict) -> list[tuple[str, int, int, int, int]]:
    """(name, K, cin, cout, stride) of every conv, in the plan's order."""
    c = config["in_channels"]
    out = []
    if config["family"] == "vgg":
        for i, (cout, _) in enumerate(config["convs"]):
            out.append((f"convs.{i}", config["conv_kernel"], c, cout,
                        config["conv_stride"]))
            c = cout
        return out
    if config["family"] != "resnet":
        raise ValueError(f"unknown family {config['family']!r}")
    out.append(("stem", config["stem_kernel"], c, config["stem_channels"],
                config["stem_stride"]))
    c, K = config["stem_channels"], config["conv_kernel"]
    for s, (cout, blocks, first) in enumerate(config["stages"]):
        for b in range(blocks):
            st, pre = (first if b == 0 else 1), f"stages.{s}.{b}.0"
            out += [(f"{pre}.c1", K, c, cout, st), (f"{pre}.c2", K, cout, cout, 1)]
            if st != 1 or c != cout:
                out.append((f"{pre}.proj", 1, c, cout, st))
            c = cout
    return out


def head_width(config: dict) -> int:
    return conv_layers(config)[-1][3]


def forward(config: dict, weights: dict, images: torch.Tensor, conv,
            requant) -> torch.Tensor:
    """Logits of ``images`` [B, H, W, C].  ``conv(name, x, stride)`` gives
    the conv's output before its bias; ``requant(x)`` is ReLU and the
    activations' quantize-dequantize."""
    b = weights
    if config["family"] == "vgg":
        x = images
        for i, (_, pool) in enumerate(config["convs"]):
            name = f"convs.{i}"
            x = requant(conv(name, x, config["conv_stride"]) + b[name + ".b"])
            if pool:
                x = maxpool(x, config["pool_kernel"], config["pool_stride"])
    else:
        x = requant(conv("stem", images, config["stem_stride"]) + b["stem.b"])
        x = maxpool(x, config["stem_pool_kernel"], config["stem_pool_stride"])
        c = config["stem_channels"]
        for s, (cout, blocks, first) in enumerate(config["stages"]):
            for i in range(blocks):
                st, pre = (first if i == 0 else 1), f"stages.{s}.{i}.0"
                y = requant(conv(pre + ".c1", x, st) + b[pre + ".c1.b"])
                y = conv(pre + ".c2", y, 1) + b[pre + ".c2.b"]
                if st != 1 or c != cout:
                    x = y + (conv(pre + ".proj", x, st) + b[pre + ".proj.b"])
                else:
                    x = y + x
                x = requant(x)
                c = cout
    x = x.mean(dim=(1, 2))
    return x @ b["head.w"] + b["head.b"]


def weight_shapes(config: dict) -> dict[str, tuple[int, ...]]:
    """Every weight the plan reads, by name, in the order the benchmark
    draws them: each conv's HWIO kernel and bias, then the dense head."""
    shapes = {}
    for name, K, cin, cout, _ in conv_layers(config):
        shapes[name + ".w"] = (K, K, cin, cout)
        shapes[name + ".b"] = (cout,)
    shapes["head.w"] = (head_width(config), config["n_classes"])
    shapes["head.b"] = (config["n_classes"],)
    return shapes
