"""Log-quantized gradient compression with error feedback — the paper's
6-bit base-√2 codes applied beyond the paper, to the data-parallel
all-reduce.

Counterpart of `repro.training.grad_compress`, on the port's
`core.logquant.log_quantize` / `log_dequantize`, so the codes and the
error state equal JAX's for the same gradients.

Mechanism (EF-SGD style):
    acc   = grad + error                       # fold in residual
    q     = log_dequantize(log_quantize(acc))  # 7-bit wire format (6+sign)
    error = acc - q                            # kept locally, fp32
    return q                                   # what crosses the network

The all-reduce would then move 7-bit codes (+ one fp32 scale per channel)
instead of 32/16-bit floats; `wire_bytes_fraction` gives the cut.  On one
card nothing crosses a network: the round trip runs so that training sees
the compressed gradients.  A leaf of fewer than ``min_size`` elements (norm
scales) goes uncompressed and keeps a 0-d fp32 error, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.logquant import (DEFAULT, LogQuantConfig,
                                       log_dequantize, log_quantize)
from .optimizer import tree_map


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    enabled: bool = True
    qcfg: LogQuantConfig = DEFAULT
    min_size: int = 1024     # tiny tensors (norm scales) go uncompressed


CompressorState = dict  # {"error": tree of fp32 residuals}


def _compressible(leaf, cfg: CompressorConfig) -> bool:
    return leaf.numel() >= cfg.min_size


def compressor_init(params, cfg: CompressorConfig = CompressorConfig()) \
        -> CompressorState:
    def zeros(p):
        shape = p.shape if _compressible(p, cfg) else ()
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    return {"error": tree_map(zeros, params)}


def compress_decompress(g, cfg: LogQuantConfig = DEFAULT):
    """Round-trip one tensor through the wire format (fp32 in/out)."""
    packed, scale = log_quantize(g.to(torch.float32), cfg)
    return log_dequantize(packed, scale, cfg, dtype=torch.float32)


@torch.no_grad()
def log_compress_gradients(grads, state: CompressorState,
                           cfg: CompressorConfig = CompressorConfig()):
    """Apply EF log-compression leaf-wise.  Returns (grads', state'); the
    error tensors are updated in place."""
    if not cfg.enabled:
        return grads, state

    def leaf(g, e):
        if not _compressible(g, cfg):
            return g.to(torch.float32)
        acc = g.to(torch.float32) + e
        q = compress_decompress(acc, cfg.qcfg)
        e.copy_(acc.sub_(q))
        return q

    return tree_map(leaf, grads, state["error"]), state


def make_compressor(params, enabled: bool = True,
                    qcfg: LogQuantConfig = DEFAULT, min_size: int = 1024):
    cfg = CompressorConfig(enabled=enabled, qcfg=qcfg, min_size=min_size)
    return compressor_init(params, cfg), \
        lambda g, s: log_compress_gradients(g, s, cfg)


def wire_bytes_fraction(qcfg: LogQuantConfig = DEFAULT,
                        ref_bits: int = 32) -> float:
    """Fraction of all-reduce bytes left on the wire after compression."""
    return (qcfg.storage_bits) / ref_bits
