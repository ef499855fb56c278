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

Inputs are tokens [B, T], or, for the frontend-stub archs
(``cfg.embed_inputs`` false: musicgen-large, qwen2-vl-2b), embeddings
[B, T, D] with qwen2-vl's M-RoPE positions [3, B, T].

Training: `lm_loss` (`chunked_xent` over the tied or untied head) is
differentiated by autograd.  With ``cfg.remat`` each repeated unit runs
under `torch.utils.checkpoint` (non-reentrant) while grad mode is on and
no cache is given, so its activations are recomputed in the backward pass
(JAX's ``nothing_saveable`` remat of the scan body).  A stacked leaf is
split into its reps once a forward (`torch.unbind`), whose backward stacks
the reps' gradients in one tensor.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

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


def _unstack(tree, n_rep: int) -> list:
    """The ``n_rep`` reps of a stacked parameter tree, as `_rep` gives them,
    but a tensor split by one `torch.unbind`, whose backward stacks the
    reps' gradients once (a slice a rep would add a full-size gradient a
    rep)."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v, n_rep) for k, v in tree.items()}
        return [{k: c[r] for k, c in cols.items()} for r in range(n_rep)]
    if isinstance(tree, QuantizedTensor):
        return [_rep(tree, r) for r in range(n_rep)]
    return list(tree.unbind(0))


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


def _apply_unit(up, h, cfg, unit, positions, ucache, index):
    """One repeated unit (the layers of the pattern) → (h, aux)."""
    aux = 0.0
    for i, kind in enumerate(unit):
        h, _, a = _apply_layer(up[f"l{i}"], h, cfg, kind, positions,
                               None if ucache is None else ucache[f"l{i}"],
                               index)
        aux = aux + a
    return h, aux


def forward(params, inputs, cfg, *, positions=None, cache=None):
    """inputs: tokens [B, T] int, or embeddings [B, T, D] when
    ``cfg.embed_inputs`` is false.  Returns (hidden [B, T, D], cache, aux).

    With a cache, ``cache["index"]`` (an int or an int tensor [B]) is the
    absolute position of inputs[:, 0]; the cache is updated in place and
    returned with the index advanced by T.  ``positions`` defaults to
    index + arange(T); qwen2-vl's M-RoPE takes [3, B, T].  ``aux`` is the
    MoE router loss summed over the layers (a 0-d fp32 tensor), 0.0 for
    archs without MoE."""
    if cfg.embed_inputs:
        h = embed(params["embed"], inputs, cfg)
    else:
        h = inputs.to(cfg.act_dtype)
    B, T = inputs.shape[:2]
    index = cache["index"] if cache is not None else 0
    if positions is None:
        positions = _positions(T, index, h.device).expand(B, T)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()

    aux = 0.0
    for si, (unit, n_rep) in enumerate(cfg.segments):
        seg_c = None if cache is None else cache["segments"][f"seg{si}"]
        for r, up in enumerate(_unstack(params["segments"][f"seg{si}"],
                                        n_rep)):
            uc = None if seg_c is None else _rep(seg_c, r)
            if remat:
                h, a = torch.utils.checkpoint.checkpoint(
                    _apply_unit, up, h, cfg, unit, positions, None, index,
                    use_reentrant=False)
            else:
                h, a = _apply_unit(up, h, cfg, unit, positions, uc, index)
            aux = aux + a
    h = norm(cfg, params["final_norm"], h)
    new_cache = None
    if cache is not None:
        new_cache = {"index": index + T, "segments": cache["segments"]}
    return h, new_cache, aux


def logits_fn(params, h, cfg):
    return unembed(params["embed"], h, cfg)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def chunked_xent(params, h, labels, mask, cfg, chunk: int = 512):
    """Masked mean cross-entropy of the head's logits, ``chunk`` positions
    at a time, so the forward holds one [B, chunk, V] block of logits at
    once (JAX scans over the same chunks; the last one is shorter here
    where JAX pads it with masked positions).

    Under autograd each chunk's fp32 logits and, with tied embeddings, the
    table cast to the activation dtype (`layers.unembed`) are kept for the
    backward pass: for gemma-2b's 256,128 × 2048 table that cast is about
    1 GB in bf16 a chunk.  At T ≤ chunk there is one chunk."""
    T = h.shape[1]
    labels = labels.to(torch.int64)
    mask = mask.to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, T, chunk):
        ll, mm = labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk]
        logits = logits_fn(params, h[:, c0:c0 + chunk], cfg).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, ll[..., None])[..., 0]
        tot = tot + ((logz - gold) * mm).sum()
        cnt = cnt + mm.sum()
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, batch, cfg, xent_chunk: int = 512):
    """batch: {"tokens" or "embeds", "labels", optional "mask",
    "positions"}, tensors on the params' device.  Returns
    (xent + aux, {"xent", "aux"}), every value a 0-d fp32 tensor."""
    inputs = batch["tokens"] if cfg.embed_inputs else batch["embeds"]
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    h, _, aux = forward(params, inputs, cfg, positions=batch.get("positions"))
    loss = chunked_xent(params, h, labels, mask, cfg, chunk=xent_chunk)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def prefill(params, inputs, cfg, cache, positions=None):
    """Run the prompt, fill the cache, return last-token hidden state."""
    h, new_cache, _ = forward(params, inputs, cfg, positions=positions,
                              cache=cache)
    return h[:, -1:], new_cache


def decode_step(params, inputs, cfg, cache, positions=None):
    """One token per sequence.  inputs: [B, 1] tokens (or [B, 1, D]
    embeddings)."""
    h, new_cache, _ = forward(params, inputs, cfg, positions=positions,
                              cache=cache)
    return logits_fn(params, h, cfg), new_cache
