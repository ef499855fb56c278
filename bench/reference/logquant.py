"""Frozen copy of the 6-bit + sign base-sqrt(2) log quantizer (NeuroMAX
section 3, eqs. 3-4): sign * 2^(code / steps) * scale, with one scale per
trailing channel taken as the largest magnitude, codes in
[-(2^bits - 2), 0], and exact zero kept as zero.

The operations follow the order in which the program's quantizer applies
them, so that the same float32 input gives the same float32 output bit for
bit; ``dtype`` computes the whole of it in a lower precision instead (the
control of the output check).
"""

from __future__ import annotations

import torch


def quantize(x: torch.Tensor, bits: int = 6, frac_bits: int = 1,
             per_channel: bool = True):
    """x -> (code, sign, nonzero, scale), code as a float tensor."""
    steps = 1 << frac_bits
    code_min = -((1 << bits) - 2)
    a = x.abs()
    if per_channel and x.ndim >= 2:
        s = a.amax(dim=tuple(range(x.ndim - 1)), keepdim=True)
    else:
        s = a.amax()
    scale = torch.where(s > 0, s, torch.ones_like(s))
    mag = a / scale
    code = torch.round(torch.log2(torch.clamp(mag, min=1e-38)) * steps)
    code = torch.clamp(code, code_min, 0)
    return code, torch.where(x < 0, -1.0, 1.0).to(x.dtype), x != 0, scale


def fake_quant(x: torch.Tensor, bits: int = 6, frac_bits: int = 1,
               per_channel: bool = True, dtype=None) -> torch.Tensor:
    """Quantize then dequantize, in ``dtype`` (default: x's) and back."""
    out_dtype = x.dtype
    if dtype is not None:
        x = x.to(dtype)
    code, sign, nonzero, scale = quantize(x, bits, frac_bits, per_channel)
    mag = torch.exp2(code / (1 << frac_bits))
    out = sign * torch.where(nonzero, mag, torch.zeros_like(mag))
    return (out * scale).to(out_dtype)
