"""Plain PyTorch oracles for the kernels of this package.

Counterpart of `repro.kernels.ref`: `ref_log_matmul` (kernel B2's plain
version), `ref_attention` (kernel B3's) and `ref_wkv6` (kernel B4's).
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


def positions(n: int, offset, device) -> torch.Tensor:
    """Absolute positions ``arange(n) + offset`` as ``[1, n]`` for an int
    offset, or ``[B, n]`` for an int tensor of per-row offsets ``[B]``."""
    off = torch.as_tensor(offset, device=device).reshape(-1, 1)
    return torch.arange(n, device=device)[None] + off


def attention_mask(Tq: int, Tk: int, *, causal: bool, window, q_offset,
                   k_offset, device) -> torch.Tensor:
    """Boolean ``[B or 1, Tq, Tk]``: keys at absolute position < 0 (ring
    slots never written) are masked, then causal and window masks."""
    qpos = positions(Tq, q_offset, device)[:, :, None]
    kpos = positions(Tk, k_offset, device)[:, None, :]
    mask = kpos >= 0
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    return mask


def ref_attention(q, k, v, *, causal=True, window=None, scale=None,
                  q_offset=0, k_offset=0):
    """q: [B, Tq, H, D]; k, v: [B, Tk, Hkv, D] (GQA: H multiple of Hkv).

    window: sliding-window size (keys with q_pos - k_pos >= window masked).
    q_offset: absolute position of q[0] (for decode: q_offset = Tk - Tq).
    k_offset: absolute position of k[0] (ring-buffer caches; keys with
    absolute position < 0 are masked as never-written slots).  Each offset
    is an int, or an int tensor ``[B]`` with one offset per batch row.
    A fully masked row gets uniform weights, as the JAX oracle's softmax
    gives it.
    """
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / D ** 0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    mask = attention_mask(Tq, k.shape[1], causal=causal, window=window,
                          q_offset=q_offset, k_offset=k_offset,
                          device=q.device)
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def ref_wkv6(r, k, v, logw, u, state=None):
    """Sequential RWKV6 (Finch) WKV recurrence with data-dependent decay:
    the spec, one token at a time in fp32.

    r, k, logw: [B, T, H, K]; v: [B, T, H, V]; u: [H, K] (the bonus of the
    current token); state: [B, H, K, V] or None (zeros).

        o_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
        S_t = diag(exp(logw_t)) S_{t-1} + k_t v_tᵀ

    Returns (o [B, T, H, V], S_T [B, H, K, V]), both fp32 as in the JAX
    oracle."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    r, k, v, logw = (a.to(f32) for a in (r, k, v, logw))
    u = u.to(f32)[None, :, :, None]
    S = (torch.zeros((B, H, K, V), dtype=f32, device=r.device)
         if state is None else state.to(f32))
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # [B, H, K, V]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u * kv))
        S = torch.exp(logw[:, t])[..., None] * S + kv
    return torch.stack(outs, 1), S
