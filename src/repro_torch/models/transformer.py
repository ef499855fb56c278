"""Decoder assembly: stacked layer groups, prefill and decode.

Counterpart of the serving half of `repro.models.transformer`.  Layers are
grouped into segments of repeating units (``cfg.segments``); each segment's
parameters and cache are stacked with a leading ``n_rep`` dimension, as
the JAX package stacks them for its layer scan, so a JAX tree maps onto
this one leaf by leaf (`params_from_numpy`).  Where JAX scans, `forward`
loops over the reps in Python and slices the stacked tensors; a slice of a
contiguous stack is a contiguous view, so no weight is copied.

Layer kinds: attention ("attn", "local") and Griffin's RG-LRU ("rec"),
each a mixer then an FFN, the FFN a top-k MoE when ``cfg.is_moe``; and
RWKV6 ("rwkv": time-mix then channel-mix, no FFN).

Cache: ``{"index": int or int tensor [B], "segments": {seg: stacked
per-layer state}}``; the layers write it in place (attention: K/V at the
index; RG-LRU: ``h`` and the conv window; RWKV: ``x_prev_t``, ``x_prev_c``
and the WKV state).

Not ported yet: frontend-stub archs fed with embeddings and the training
loss (`chunked_xent`, `lm_loss`: ROADMAP.md queue A, item 14).
"""

from __future__ import annotations

import torch

from repro_torch.core.logquant import QuantizedTensor
from repro_torch.kernels.ref import positions as _positions
from .attention import attention_mixer, attn_init, init_kv_cache
from .cnn import params_from_numpy, resolve_device  # noqa: F401
from .griffin import griffin_init, griffin_mixer, griffin_state_init
from .layers import (embed, embed_init, ffn, ffn_init, norm, norm_init,
                     unembed)
from .moe import moe_ffn, moe_init
from .rwkv import (rwkv_channel_mix, rwkv_init, rwkv_state_init,
                   rwkv_time_mix)


def check_supported(cfg) -> None:
    """Raise for what this slice of the port does not run."""
    if not cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: embedding inputs (frontend stubs) are not ported "
            f"yet (ROADMAP.md queue A, item 14)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def layer_init(gen, cfg, kind: str, *, lead=(), device=None):
    """One layer (``kind`` "attn", "local", "rec" or "rwkv"), every leaf
    prefixed by ``lead``."""
    kw = dict(lead=lead, device=device)
    norms = {"norm1": norm_init(cfg, **kw), "norm2": norm_init(cfg, **kw)}
    if kind == "rwkv":
        return {**norms, "rwkv": rwkv_init(gen, cfg, **kw)}
    mixer = {"rec": griffin_init(gen, cfg, **kw)} if kind == "rec" \
        else {"attn": attn_init(gen, cfg, **kw)}
    ffn_p = moe_init(gen, cfg, **kw) if cfg.is_moe \
        else ffn_init(gen, cfg, **kw)
    return {**norms, **mixer, "ffn": ffn_p}


def unit_init(gen, cfg, unit, *, lead=(), device=None):
    return {f"l{i}": layer_init(gen, cfg, kind, lead=lead, device=device)
            for i, kind in enumerate(unit)}


def init_params(cfg, seed: int = 0, *, device=None):
    """Random parameters from ``seed`` on ``device`` (default: the card;
    raises without one unless ``device="cpu"``).  The values differ from
    the JAX package's for the same seed; tests bridge a JAX tree with
    `params_from_numpy` instead."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    segs = {f"seg{si}": unit_init(gen, cfg, unit, lead=(n_rep,),
                                  device=device)
            for si, (unit, n_rep) in enumerate(cfg.segments)}
    return {"embed": embed_init(gen, cfg, device=device),
            "segments": segs,
            "final_norm": norm_init(cfg, device=device)}


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def layer_cache(cfg, kind, batch, max_len, dtype, *, lead=(), device=None):
    """One layer's cache: K/V for attention (in ``dtype``), the fp32
    recurrent state for RG-LRU and RWKV (whatever ``dtype`` and
    ``max_len``)."""
    if kind == "rwkv":
        return rwkv_state_init(cfg, batch, lead=lead, device=device)
    if kind == "rec":
        return griffin_state_init(cfg, batch, lead=lead, device=device)
    return init_kv_cache(cfg, kind, batch, max_len, dtype, lead=lead,
                         device=device)


def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, *, device=None):
    check_supported(cfg)
    device = resolve_device(device)
    segs = {f"seg{si}": {f"l{i}": layer_cache(cfg, kind, batch, max_len,
                                              dtype, lead=(n_rep,),
                                              device=device)
                         for i, kind in enumerate(unit)}
            for si, (unit, n_rep) in enumerate(cfg.segments)}
    return {"index": 0, "segments": segs}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _rep(tree, r: int):
    """Rep ``r`` of a stacked tree: every tensor and `QuantizedTensor`
    sliced along its leading axis (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _rep(v, r) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(tree.packed[r], tree.scale[r], tree.cfg,
                               tree.shape[1:])
    return tree[r]


def _apply_layer(lp, h, cfg, kind, positions, lcache, index):
    """One pre-norm residual layer → (h, cache, aux): ``aux`` is the MoE
    router loss, 0.0 without MoE."""
    if kind == "rwkv":
        o, lcache = rwkv_time_mix(lp["rwkv"], norm(cfg, lp["norm1"], h), cfg,
                                  lcache)
        h = h + o
        o, lcache = rwkv_channel_mix(lp["rwkv"], norm(cfg, lp["norm2"], h),
                                     cfg, lcache)
        return h + o, lcache, 0.0
    if kind == "rec":
        o, lcache = griffin_mixer(lp["rec"], norm(cfg, lp["norm1"], h), cfg,
                                  lcache)
    else:
        o, lcache = attention_mixer(lp["attn"], norm(cfg, lp["norm1"], h),
                                    cfg, kind=kind, positions=positions,
                                    cache=lcache, index=index)
    h = h + o
    hn = norm(cfg, lp["norm2"], h)
    if cfg.is_moe:
        o, aux = moe_ffn(lp["ffn"], hn, cfg)
        return h + o, lcache, aux
    return h + ffn(lp["ffn"], hn, cfg), lcache, 0.0


def forward(params, inputs, cfg, *, positions=None, cache=None):
    """inputs: tokens [B, T] int.  Returns (hidden [B, T, D], cache, aux).

    With a cache, ``cache["index"]`` (an int or an int tensor [B]) is the
    absolute position of inputs[:, 0]; the cache is updated in place and
    returned with the index advanced by T.  ``aux`` is the MoE router loss
    summed over the layers (a 0-d fp32 tensor), 0.0 for archs without
    MoE."""
    check_supported(cfg)
    h = embed(params["embed"], inputs, cfg)
    B, T = inputs.shape[:2]
    index = cache["index"] if cache is not None else 0
    if positions is None:
        positions = _positions(T, index, h.device).expand(B, T)

    aux = 0.0
    for si, (unit, n_rep) in enumerate(cfg.segments):
        seg_p = params["segments"][f"seg{si}"]
        seg_c = None if cache is None else cache["segments"][f"seg{si}"]
        for r in range(n_rep):
            up = _rep(seg_p, r)
            uc = None if seg_c is None else _rep(seg_c, r)
            for i, kind in enumerate(unit):
                h, _, a = _apply_layer(up[f"l{i}"], h, cfg, kind, positions,
                                       None if uc is None else uc[f"l{i}"],
                                       index)
                aux = aux + a
    h = norm(cfg, params["final_norm"], h)
    new_cache = None
    if cache is not None:
        new_cache = {"index": index + T, "segments": cache["segments"]}
    return h, new_cache, aux


def logits_fn(params, h, cfg):
    return unembed(params["embed"], h, cfg)


def prefill(params, inputs, cfg, cache, positions=None):
    """Run the prompt, fill the cache, return last-token hidden state."""
    h, new_cache, _ = forward(params, inputs, cfg, positions=positions,
                              cache=cache)
    return h[:, -1:], new_cache


def decode_step(params, inputs, cfg, cache, positions=None):
    """One token per sequence.  inputs: [B, 1] tokens."""
    h, new_cache, _ = forward(params, inputs, cfg, positions=positions,
                              cache=cache)
    return logits_fn(params, h, cfg), new_cache
