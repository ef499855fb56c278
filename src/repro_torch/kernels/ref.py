"""Plain PyTorch oracles for the kernels of this package.

Counterpart of `repro.kernels.ref`; this slice carries `ref_log_matmul`
only (the attention and RWKV oracles come with their kernels).
"""

from __future__ import annotations

import torch

from repro_torch.core.logquant import LogQuantConfig, log_dequantize


def ref_log_matmul(x, packed, scale, cfg: LogQuantConfig = LogQuantConfig(),
                   out_dtype=None):
    """x: [M, K] float; packed: [K, N] int8 log codes; scale: [1, N] or
    scalar.  fp32 matmul (no TF32 unless the caller enabled it)."""
    w = log_dequantize(packed, scale, cfg, dtype=torch.float32)
    out = torch.matmul(x.to(torch.float32), w)
    return out.to(out_dtype or x.dtype)
