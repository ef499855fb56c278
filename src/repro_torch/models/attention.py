"""GQA/MQA attention mixer with RoPE/M-RoPE, QKV bias, windows and KV cache.

Counterpart of `repro.models.attention` (the JAX package's sharding
constraints are dropped: on one card they change no number).

Cache layouts:
  * global ('attn') layers: [B, max_len, Hkv, hd], written at the index.
  * 'local' layers: ring buffer of size `window` — decode writes at
    index % window and attends with key-position offsets so never-written
    slots (absolute position < 0) are masked.

The cache is written in place: prefill and decode update the tensors they
are given (views into the engine's stacked cache) and return them.
``index`` may be an int or an int tensor ``[B]`` with one position per
batch row; the batched decode of the engine passes the latter.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from .layers import _init, apply_rope, dense


def attn_init(gen, cfg, *, lead=(), device=None):
    D = cfg.d_model
    kw = dict(lead=lead, device=device)
    p = {"wq": _init(gen, (D, cfg.q_dim), **kw),
         "wk": _init(gen, (D, cfg.kv_dim), **kw),
         "wv": _init(gen, (D, cfg.kv_dim), **kw),
         "wo": _init(gen, (cfg.q_dim, D), **kw)}
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros(tuple(lead) + (n,), device=device)
    return p


def kv_cache_len(cfg, kind, max_len):
    if kind == "local" and cfg.attn_window is not None:
        return min(max_len, cfg.attn_window)
    return max_len


def init_kv_cache(cfg, kind, batch, max_len, dtype=torch.bfloat16, *,
                  lead=(), device=None):
    S = kv_cache_len(cfg, kind, max_len)
    shape = tuple(lead) + (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _qkv(p, h, cfg, positions):
    B, T, _ = h.shape

    def proj(w, b):
        return dense({"w": p[w], **({"b": p[b]} if b in p else {})}, h, cfg)

    q = proj("wq", "bq").reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = proj("wk", "bk").reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = proj("wv", "bv").reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def attention_mixer(p, h, cfg, *, kind="attn", positions, cache=None,
                    index=None):
    """h: [B, T, D] → (out [B, T, D], cache).

    Modes: cache=None (no cache); T>1 + cache (prefill: attend within the
    chunk, then write the chunk into the cache); T==1 + cache (decode at
    `index`, an int or one position per batch row)."""
    window = cfg.attn_window if kind == "local" else None
    q, k, v = _qkv(p, h, cfg, positions)
    B, T = h.shape[:2]
    acfg = ops.AttentionConfig(block_k=cfg.attn_block_k,
                               acc_dtype=cfg.attn_acc_dtype,
                               gqa_broadcast=cfg.gqa_broadcast)

    if cache is None or T > 1:
        out = ops.attention(q, k, v, causal=True, window=window,
                            impl=cfg.attn_impl, config=acfg)
        if cache is not None:  # prefill
            S = cache["k"].shape[1]
            if S >= T:  # cache holds the whole chunk
                cache["k"][:, :T] = k
                cache["v"][:, :T] = v
            else:
                # ring smaller than the chunk: keep the last S tokens, the
                # token at position p in slot p % S, where decode looks for
                # it (the JAX package writes them at slots 0..S-1, which
                # decode misreads unless S divides T; ROADMAP.md C)
                slots = (torch.arange(T - S, T, device=h.device)) % S
                cache["k"][:, slots] = k[:, T - S:].to(cache["k"].dtype)
                cache["v"][:, slots] = v[:, T - S:].to(cache["v"].dtype)

    else:        # decode one token at absolute position `index`
        S = cache["k"].shape[1]
        is_ring = window is not None and S <= window
        index = torch.as_tensor(index, device=h.device).reshape(-1).expand(B)
        # a write past the end lands on the last slot, as JAX's
        # dynamic_update_slice clamps its start
        slot = index % S if is_ring else index.clamp(0, S - 1)
        rows = torch.arange(B, device=h.device)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        dcfg = dataclasses.replace(acfg, block_k=min(cfg.attn_block_k, S))
        if is_ring:
            # unroll the ring into logical order (oldest first): the key at
            # array slot j has absolute position index - S + 1 + j after a
            # roll by -(slot+1); never-written slots land at positions < 0
            # and are masked by k_offset semantics.
            order = (torch.arange(S, device=h.device)[None]
                     + slot[:, None] + 1) % S
            gather = order[:, :, None, None].expand(B, S, cfg.n_kv_heads,
                                                    cfg.head_dim)
            ck = torch.gather(cache["k"], 1, gather)
            cv = torch.gather(cache["v"], 1, gather)
            out = ops.attention(q, ck, cv, causal=True, window=window,
                                q_offset=index, k_offset=index - S + 1,
                                impl=cfg.attn_impl, config=dcfg)
        else:
            out = ops.attention(q, cache["k"], cache["v"], causal=True,
                                window=window, q_offset=index,
                                impl=cfg.attn_impl, config=dcfg)

    out = out.reshape(B, T, cfg.q_dim)
    return dense({"w": p["wo"]}, out, cfg), cache
