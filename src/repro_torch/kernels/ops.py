"""The kernel-call surface of the port (counterpart of `repro.kernels.ops`,
conv slice).

`conv2d` takes the dispatch knob ``impl=``, resolved by `resolve_impl`:

  "cuda"      — the hand-written CUDA kernel (`log_conv2d.log_conv2d_fused`);
                on a CPU tensor its wrapper runs the plain blockwise version
  "blockwise" — decode, then `F.conv2d`
  "ref"       — explicit im2col × decode-then-matmul oracle (tests)
  "auto"      — "cuda" for a CUDA tensor, "blockwise" for a CPU tensor

and ``config=ConvConfig(lane_pack=...)`` for the grouped-conv layout.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.logquant import (LogQuantConfig, QuantizedTensor,
                                       quantize_tensor)
from .log_conv2d import (lane_unpack_codes, log_conv2d_blockwise,
                         log_conv2d_fused, log_conv2d_ref)

_OP_IMPLS = {
    "conv2d": ("cuda", "blockwise", "ref"),
}


def resolve_impl(op: str, impl: str = "auto", device=None) -> str:
    """An explicit ``impl`` (validated against the op's implementations)
    beats ``"auto"``, which picks "cuda" when the operands lie on a CUDA
    device and "blockwise" otherwise.  It never asks whether a card exists:
    the tensors' device decides."""
    choices = _OP_IMPLS[op]
    if impl == "auto":
        dev = torch.device(device) if device is not None else None
        impl = "cuda" if dev is not None and dev.type == "cuda" else "blockwise"
    if impl not in choices:
        raise ValueError(f"unknown {op} impl {impl!r}; expected "
                         f"{'|'.join(choices)}|auto")
    return impl


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    """Layout spec for `conv2d`.

    ``lane_pack`` says whether a `QuantizedTensor`'s baked ``"lane_packed"``
    layout may ride onto the kernel: ``None`` (or the baked factor) uses it
    as stored; any other value (``1`` = off) unpacks it to HWIO first.  An
    explicit value beats the baked layout.  The CUDA kernel reads natural
    HWIO codes as well as packed ones, so HWIO codes are never packed per
    call."""
    lane_pack: int | None = None


def _lane_pack(config) -> int | None:
    if config is None:
        return None
    if isinstance(config, ConvConfig):
        return config.lane_pack
    return dict(config).get("lane_pack")


def conv2d(x, qt, *, stride: int = 1, padding="SAME", groups: int = 1,
           impl: str = "auto", out_dtype=None,
           qcfg: LogQuantConfig | None = None,
           config: ConvConfig | dict | None = None):
    """x: [B, H, W, Cin] ⊛ dequant(qt [K, K, Cin//groups, Cout]) → NHWC out.

    `qt` is a `QuantizedTensor` of packed log codes in any of its layouts
    (natural, ``conv_taps``, ``lane_packed``); a plain float kernel is
    packed on the fly (inference only).  Supports stride,
    SAME/VALID/int/explicit padding and grouped/depthwise convs."""
    if impl == "pallas_im2col":
        raise ValueError("conv2d impl 'pallas_im2col' runs on the log_matmul "
                         "kernel, which the port does not have yet (ROADMAP.md "
                         "queue A, item 11)")
    if not isinstance(qt, QuantizedTensor):
        qt = quantize_tensor(torch.as_tensor(qt, device=x.device),
                             qcfg or LogQuantConfig())
    impl = resolve_impl("conv2d", impl, x.device)
    packed, lane = qt.packed, None
    if qt.layout == "conv_taps":
        packed = packed.reshape(qt.shape)  # [taps, cin_g, Cout] → HWIO view
    elif qt.layout == "lane_packed":
        # the baked layout rides onto the kernel when it matches this call;
        # any disagreement (other groups, a conflicting explicit lane_pack,
        # a plain impl) unpacks the codes to HWIO, which is always correct
        g_b, cin_lane, meta_groups = qt.layout_meta
        want = _lane_pack(config)
        if impl == "cuda" and meta_groups == groups and want in (None, g_b):
            lane = (g_b, cin_lane)
        else:
            packed = lane_unpack_codes(packed, qt.shape, meta_groups, g_b,
                                       cin_lane)
    kw = dict(stride=stride, padding=padding, groups=groups)
    if impl == "cuda":
        y = log_conv2d_fused(x, packed, qt.scale, qt.cfg, lane=lane, **kw)
    elif impl == "ref":
        y = log_conv2d_ref(x, packed, qt.scale, qt.cfg, **kw)
    else:
        y = log_conv2d_blockwise(x, packed, qt.scale, qt.cfg, **kw)
    return y if out_dtype is None else y.to(out_dtype)
