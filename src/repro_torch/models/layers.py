"""Primitive layers: norms, dense (+ optional log-quantized weights),
rotary embeddings (incl. M-RoPE), FFNs, embedding table.

Counterpart of `repro.models.layers`.  Parameters are plain nested dicts of
tensors; every dense weight has the canonical ``[in, out]`` layout.  A
layer's init takes a ``lead`` shape that prefixes every leaf, so a group of
``n_rep`` layers is made as one stacked ``[n_rep, ...]`` tree, the layout of
the JAX package's scanned parameters.  A dense weight that the serving
quantizer left as a `QuantizedTensor` goes to `kernels.ops.log_matmul`;
with ``cfg.quant == "logq6"`` a float weight is fake-quantized first (QAT).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core.logquant import (LogQuantConfig, QuantizedTensor,
                                       fake_log_quant)
from repro_torch.kernels import ops
from . import sharding


def _init(gen, shape, scale=None, *, lead=(), device=None):
    """Normal init ``* scale`` (default ``1/sqrt(shape[0])``, the fan-in),
    of shape ``lead + shape``."""
    scale = scale if scale is not None else 1.0 / (shape[0] ** 0.5)
    return torch.randn(tuple(lead) + tuple(shape), generator=gen,
                       device=device) * scale


def _matmul_input(x, cfg):
    """A matmul's input ``x`` split on its batch and last dims only: a
    split sequence or a strided split gathered, a partial sum reduced.
    DTensor's cost model may split a sequence after a partial sum (a
    reduce-scatter, cheaper than an all-reduce); the matmul's view of batch
    × sequence as one dim then takes a strided shard, and for strided
    shards and partial inputs DTensor weighs candidate layouts by a graph
    search that takes minutes a layer on the 2×16×16 mesh.  The §Perf
    variants that split the sequence on purpose keep it split."""
    if not sharding.is_sharded(x) or x.ndim < 3 or (
            cfg is not None and "seq" in (cfg.attn_shard, cfg.residual_shard)):
        return x
    pl = [q if type(q) is Shard and q.dim in (0, x.ndim - 1)
          else Replicate() for q in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def dense(p, x, cfg=None):
    """x @ w (+ b).  A `QuantizedTensor` weight runs on `ops.log_matmul`;
    otherwise ``cfg.quant == "logq6"`` fake-quantizes the float weight."""
    w = p["w"]
    if isinstance(w, QuantizedTensor):
        y = ops.log_matmul(x, w)
    else:
        if cfg is not None and cfg.quant == "logq6":
            w = sharding.channelwise(
                lambda t: fake_log_quant(t, LogQuantConfig()), w)
        y = _matmul_input(x, cfg) @ w.to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(p, x, eps=1e-6):
    """``x / rms(x) * scale`` in fp32 (the scale multiplies, not 1 + scale)."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def layernorm(p, x, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def norm_init(cfg, *, lead=(), device=None):
    shape = tuple(lead) + (cfg.d_model,)
    p = {"scale": torch.ones(shape, device=device)}
    if cfg.norm != "rmsnorm":
        p["bias"] = torch.zeros(shape, device=device)
    return p


def norm(cfg, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# rotary position embeddings (+ M-RoPE for qwen2-vl)
# ---------------------------------------------------------------------------


def apply_rope(x, positions, theta=10_000.0, mrope_sections=None):
    """x: [B, T, H, D]; positions: [B, T] (or [3, B, T] for M-RoPE).

    Rotates halves (``x[..., :D/2]`` against ``x[..., D/2:]``), not
    interleaved pairs, with ``freq = theta^(-i / (D/2))``.  M-RoPE
    (Qwen2-VL): the D/2 frequency channels are split into (t, h, w)
    sections, each rotated by its own position stream."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if mrope_sections is None:
        ang = positions[..., None].to(torch.float32) * freq
    else:
        if sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not sum "
                             f"to head_dim/2 = {half}")
        if positions.ndim == 2:  # text-only: reuse the same stream
            positions = positions[None].expand((3,) + tuple(positions.shape))
        angs, start = [], 0
        for i, sec in enumerate(mrope_sections):
            f = freq[start:start + sec]
            angs.append(positions[i][..., None].to(torch.float32) * f)
            start += sec
        ang = torch.cat(angs, dim=-1)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# FFN (dense path; the MoE FFN is `models/moe.py`)
# ---------------------------------------------------------------------------


def ffn_init(gen, cfg, *, lead=(), device=None):
    D, Fd = cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, device=device)
    if cfg.ffn in ("swiglu", "geglu"):
        return {"w1": _init(gen, (D, Fd), **kw), "w3": _init(gen, (D, Fd), **kw),
                "w2": _init(gen, (Fd, D), **kw)}
    return {"w1": _init(gen, (D, Fd), **kw), "w2": _init(gen, (Fd, D), **kw)}


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def ffn(p, x, cfg):
    if cfg.ffn == "swiglu":
        h = F.silu(dense({"w": p["w1"]}, x, cfg)) * \
            dense({"w": p["w3"]}, x, cfg)
    elif cfg.ffn == "geglu":
        h = _gelu(dense({"w": p["w1"]}, x, cfg)) * \
            dense({"w": p["w3"]}, x, cfg)
    else:
        h = _gelu(dense({"w": p["w1"]}, x, cfg))
    return dense({"w": p["w2"]}, h, cfg)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen, cfg, device=None):
    # 1/√d keeps tied-unembed logits O(1) at init; cfg.embed_scale (gemma)
    # restores O(1) embeddings at the input side.
    p = {"table": _init(gen, (cfg.vocab, cfg.d_model),
                        scale=cfg.d_model ** -0.5, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _init(gen, (cfg.d_model, cfg.vocab), device=device)
    return p


def _one_batch_split(tokens):
    """Token ids split on dim 0 over one mesh dim at most: over the
    innermost of several (the 2×16×16 mesh's ``data`` of ``("pod",
    "data")``), gathered over the others.  torch 2.11's DTensor has no
    index rule for an index split over two mesh dims; the residual stream's
    constraint splits the rows again."""
    if not sharding.is_sharded(tokens):
        return tokens
    dims = [i for i, q in enumerate(tokens.placements) if q == Shard(0)]
    if len(dims) < 2:
        return tokens
    pl = [Replicate() if i in dims[:-1] else q
          for i, q in enumerate(tokens.placements)]
    return tokens.redistribute(tokens.device_mesh, pl)


def embed(p, tokens, cfg):
    # gather first, then cast: equal to casting the table first, without
    # converting the whole table every call
    h = p["table"][_one_batch_split(tokens)].to(cfg.act_dtype)
    if cfg.embed_scale:
        # the factor is rounded to the activation dtype before the multiply
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                             device=h.device)
    return h


def unembed(p, h, cfg):
    if cfg.tie_embeddings:
        # a plain product outside any kernel, as in the JAX package; the
        # table is cast to the activation dtype on every call
        return _matmul_input(h, cfg) @ p["table"].to(h.dtype).T
    return dense({"w": p["lm_head"]}, h, cfg)
