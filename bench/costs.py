"""The benchmark's frozen cost arithmetic and the card's peaks.

A conv's operations are 2 * B * Ho * Wo * Cout * K^2 * Cin / groups; its
bytes are each input read once and each output written once, at the
dtypes the call sees (float32 activations in and out, int8 codes, one
float32 scale per output channel).  Its bound is the larger of operations
over the bf16 dense peak (the rate of the conv kernel's tensor-core
planes) and bytes over the HBM bandwidth.  The shapes come from the
configuration's plan (`reference.cnn`), walked on the ``meta`` device.
"""

from __future__ import annotations

import torch

from reference import cnn

# NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
PEAK_FLOPS = 989e12      # bf16 / fp16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
ACT_BYTES, CODE_BYTES, SCALE_BYTES = 4, 1, 4


def conv_shapes(config: dict, batch: int) -> list[dict]:
    """Each conv of one forward at ``batch``: B, H, W, C, K, Cout, stride,
    groups, Ho, Wo, in the plan's order."""
    shapes = []
    meta = {k: torch.empty(v, device="meta")
            for k, v in cnn.weight_shapes(config).items()}

    def conv(name, x, stride):
        w = meta[name + ".w"]
        y = cnn.conv_nhwc(x, w, stride)
        B, H, W, C = x.shape
        shapes.append(dict(name=name, B=B, H=H, W=W, C=C, K=w.shape[0],
                           Cout=w.shape[-1], stride=stride,
                           groups=cnn.conv_groups(x, w),
                           Ho=y.shape[1], Wo=y.shape[2]))
        return y

    s = config["image_size"]
    cnn.forward(config, meta, torch.empty(
        (batch, s, s, config["in_channels"]), device="meta"), conv,
        lambda x, relu=True: x)
    return shapes


def conv_flops(c: dict) -> int:
    return (2 * c["B"] * c["Ho"] * c["Wo"] * c["Cout"] * c["K"] * c["K"]
            * (c["C"] // c["groups"]))


def conv_bytes(c: dict) -> int:
    return (c["B"] * c["H"] * c["W"] * c["C"] * ACT_BYTES
            + c["K"] * c["K"] * (c["C"] // c["groups"]) * c["Cout"]
            * CODE_BYTES + c["Cout"] * SCALE_BYTES
            + c["B"] * c["Ho"] * c["Wo"] * c["Cout"] * ACT_BYTES)


def conv_bound_s(c: dict) -> float:
    return max(conv_flops(c) / PEAK_FLOPS, conv_bytes(c) / HBM_BYTES_PER_S)


def head_flops(config: dict) -> int:
    """One image's dense head."""
    return 2 * cnn.head_width(config) * config["n_classes"]


def model_flops_per_image(config: dict) -> int:
    return (sum(conv_flops(c) for c in conv_shapes(config, 1))
            + head_flops(config))
