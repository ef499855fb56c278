"""The activation maps that a configuration's plan requantizes in one
forward, from a walk of the plan (`reference.cnn.forward`) on the ``meta``
device with a requantization that records each map: nothing is
allocated."""

from __future__ import annotations

import torch

from reference import cnn


def requant_elements(config: dict, batch: int) -> int:
    """Elements of every map requantized in one forward at ``batch``."""
    meta = {k: torch.empty(v, device="meta")
            for k, v in cnn.weight_shapes(config).items()}
    seen = []

    def conv(name, x, stride):
        return cnn.conv_nhwc(x, meta[name + ".w"], stride)

    def requant(x, relu=True):
        seen.append(x.numel())
        return x

    s = config["image_size"]
    cnn.forward(config, meta, torch.empty(
        (batch, s, s, config["in_channels"]), device="meta"), conv, requant)
    return sum(seen)
