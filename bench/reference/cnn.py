"""The configurations' networks in plain PyTorch: NHWC activations, HWIO
weights, SAME padding on XLA's convention (the low side gets the smaller
half), VALID max pools, a global average pool and a dense head.

Each family's layer plan is a module of its own,
``families/<config["family"]>.py``, found by its file name as the harness
finds a metric, so that a later family is a new file.  It gives
``conv_layers(config)`` (name, K, cin, cout, stride of every conv, in the
plan's order), ``weight_shapes(config)`` (every weight the plan reads, by
name, in the order the benchmark draws them), ``head_width(config)``, and
``forward(config, weights, images, conv, requant)``; it may give
``weight_init(name, shape)``, a weight's (mean, std) where the benchmark's
default draw does not fit it.

`forward` walks the plan and leaves each conv and each requantization to
the caller, so that one walk serves the plain forward, the forward that
follows the program stage by stage (`check`), and the shape walk of the
cost model (`bench/costs.py`).  Layers are named by the path of their
weights: the names under which the benchmark draws the weights that it
hands to both sides.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import torch
import torch.nn.functional as F

FAMILIES = Path(__file__).resolve().parent / "families"


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_groups(x: torch.Tensor, w_hwio: torch.Tensor) -> int:
    """The input's channels over the kernel's: 1 for a dense kernel, C for
    a depthwise one (K x K x 1 x C)."""
    return x.shape[-1] // w_hwio.shape[2]


def conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, stride: int):
    """SAME conv of NHWC ``x`` with an HWIO kernel, NHWC out, in
    `conv_groups` groups."""
    K = w_hwio.shape[0]
    (h0, h1), (w0, w1) = (same_pads(x.shape[1], K, stride),
                          same_pads(x.shape[2], K, stride))
    xn = F.pad(x.permute(0, 3, 1, 2), (w0, w1, h0, h1))
    y = F.conv2d(xn, w_hwio.permute(3, 2, 0, 1), stride=stride,
                 groups=conv_groups(x, w_hwio))
    return y.permute(0, 2, 3, 1)


def maxpool(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    if min(x.shape[1], x.shape[2]) < 2:  # the plan pools only a 2x2 map up
        return x
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def dense_head(x: torch.Tensor, weights: dict) -> torch.Tensor:
    """Global average pool and the dense ``head``."""
    return x.mean(dim=(1, 2)) @ weights["head.w"] + weights["head.b"]


def biased_conv_shapes(config: dict, layers, width: int) -> dict:
    """Each conv's HWIO kernel and bias, then the dense head: the weights
    of a plan whose every conv is dense and carries a bias."""
    shapes = {}
    for name, K, cin, cout, _ in layers:
        shapes[name + ".w"] = (K, K, cin, cout)
        shapes[name + ".b"] = (cout,)
    shapes["head.w"] = (width, config["n_classes"])
    shapes["head.b"] = (config["n_classes"],)
    return shapes


def family(config: dict):
    """The plan module of ``config["family"]``."""
    path = FAMILIES / f"{config['family']}.py"
    if not path.is_file():
        raise ValueError(f"unknown family {config['family']!r}: no {path}")
    return _load(path)


@functools.cache
def _load(path: Path):
    # named inside this package, so that the plan imports its primitives
    # from here (``from .. import cnn``)
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.families.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def conv_layers(config: dict) -> list[tuple[str, int, int, int, int]]:
    """(name, K, cin, cout, stride) of every conv, in the plan's order."""
    return family(config).conv_layers(config)


def head_width(config: dict) -> int:
    return family(config).head_width(config)


def weight_shapes(config: dict) -> dict[str, tuple[int, ...]]:
    """Every weight the plan reads, by name, in the order the benchmark
    draws them."""
    return family(config).weight_shapes(config)


def weight_init(config: dict, name: str, shape) -> tuple[float, float] | None:
    """The family's (mean, std) for one weight, or None where it keeps the
    benchmark's default draw."""
    own = getattr(family(config), "weight_init", None)
    return None if own is None else own(name, tuple(shape))


def forward(config: dict, weights: dict, images: torch.Tensor, conv,
            requant) -> torch.Tensor:
    """Logits of ``images`` [B, H, W, C].  ``conv(name, x, stride)`` gives
    the conv's output before its bias; ``requant(x, relu=True)`` is the
    activations' quantize-dequantize, after a ReLU unless ``relu`` is
    false."""
    return family(config).forward(config, weights, images, conv, requant)
