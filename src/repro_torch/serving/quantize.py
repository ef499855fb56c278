"""Serving-time weight packing (counterpart of `repro.serving.quantize`).

`quantize_params` packs a transformer's matmul kernels, and
`quantize_cnn_params` a CNN's 4-D conv kernels, into 6-bit(+sign) base-√2
`QuantizedTensor`s once at load, so every dense layer dispatches straight
onto `kernels/ops.log_matmul` and every conv onto `kernels/ops.conv2d` with
no per-call packing.  The codes and scales equal the JAX package's byte for
byte.
"""

from __future__ import annotations

import torch

from repro_torch.core.logquant import (LogQuantConfig, QuantizedTensor,
                                       _scale_for, log_quantize,
                                       quantize_tensor)
from repro_torch.kernels.log_conv2d import lane_pack_codes, lane_pack_geometry


def _map_tree(fn, tree, name=None):
    """Apply ``fn(name, leaf)`` to every leaf of a tree of dicts, lists and
    tuples; ``name`` is the key of the innermost dict holding the leaf."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, name) for v in tree)
    return fn(name, tree)


# matmul kernels eligible for packed serving weights (2D [in, out] layout, or
# stacked [n_rep, in, out]); embeddings stay fp — gathers don't go through
# log_matmul
QUANT_LEAVES = frozenset(
    {"wq", "wk", "wv", "wo", "w1", "w2", "w3",
     "ck", "cv", "cr", "wg", "wr"})


def quantize_params(params, qcfg: LogQuantConfig = LogQuantConfig()):
    """Pack every eligible kernel of a `models/transformer.py` parameter
    tree.  A stacked ``[n_rep, K, N]`` leaf keeps its stack and gets one
    scale per (rep, channel): the layer loop slices codes and scales along
    axis 0, and each slice is quantized on the grid of its own ``[K, N]``."""

    def leaf(name, x):
        if name not in QUANT_LEAVES or not isinstance(x, torch.Tensor) \
                or x.ndim < 2:
            return x
        if x.ndim >= 3:
            axis = tuple(range(1, x.ndim - 1)) if qcfg.per_channel \
                else tuple(range(1, x.ndim))
            packed, scale = log_quantize(x, qcfg,
                                         scale=_scale_for(x, qcfg, axis))
            return QuantizedTensor(packed, scale, qcfg, x.shape)
        return quantize_tensor(x, qcfg)

    return _map_tree(leaf, params)


def quantize_cnn_params(params, qcfg: LogQuantConfig = LogQuantConfig(),
                        conv_layout: str | None = None):
    """Pack every conv kernel (4-D ``w`` leaf [K, K, Cin_g, Cout]) of a
    `models/cnn.py` parameter tree into a `QuantizedTensor` with
    per-output-channel scales.  Biases and the dense head stay fp.

    ``conv_layout="conv_taps"`` stores each code array tap-major as
    ``[K*K, Cin_g, Cout]``.  ``conv_layout="lane_packed"`` goes further for
    depthwise kernels: a ``[K, K, 1, Cout]`` leaf is taken to be a
    ``groups=Cout`` conv and its codes are arranged into the superblock
    layout ``[n_sb, K*K, g_b*cin_lane, 1]`` (``layout_meta=(g_b, cin_lane,
    groups)``), which the CUDA kernel reads as stored.  Other leaves fall
    back to ``conv_taps``."""
    if conv_layout not in (None, "conv_taps", "lane_packed"):
        raise ValueError(f"unknown conv_layout {conv_layout!r}")

    def leaf(name, x):
        if name != "w" or not isinstance(x, torch.Tensor) or x.ndim != 4:
            return x
        qt = quantize_tensor(x, qcfg)
        K1, K2, cin_g, cout = x.shape
        if conv_layout == "lane_packed" and cin_g == 1:
            lp = lane_pack_geometry(cout, cin_g)
            if lp["g_b"] > 1:
                codes = lane_pack_codes(qt.packed, cout, lp["g_b"],
                                        lp["cin_lane"])
                return QuantizedTensor(
                    codes, qt.scale.reshape(-1), qcfg, x.shape,
                    layout="lane_packed",
                    layout_meta=(lp["g_b"], lp["cin_lane"], cout))
        if conv_layout in ("conv_taps", "lane_packed"):
            return QuantizedTensor(
                qt.packed.reshape(K1 * K2, cin_g, cout),
                qt.scale.reshape(1, 1, -1), qcfg, x.shape,
                layout="conv_taps")
        return qt

    return _map_tree(leaf, params)


def quantized_fraction(params) -> float:
    """Fraction of parameter bytes now stored as 1-byte codes."""
    total = packed = 0

    def visit(name, x):
        nonlocal total, packed
        leaves = (x.packed, x.scale) if isinstance(x, QuantizedTensor) \
            else (x,)
        for t in leaves:
            if isinstance(t, torch.Tensor):  # python-int strides are skipped
                n = t.numel() * t.element_size()
                total += n
                packed += n if t.dtype == torch.int8 else 0
        return x

    _map_tree(visit, params)
    return packed / max(total, 1)
