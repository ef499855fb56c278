"""GShard-style top-k Mixture-of-Experts FFN with grouped capacity-factor
dispatch.

Counterpart of `repro.models.moe`.  Tokens are routed within **groups** of
``DEFAULT_GROUP`` tokens (one global group when that does not divide the
token count); each expert takes at most C = cf·G·K/E tokens of a group,
in queue order (token-major, then k), and a token past its expert's
capacity contributes nothing through that expert.  Dispatch and combine
are dense einsums against one-hots, as in the JAX package; the expert
products are plain einsums too (no Pallas kernel computes them there, and
no kernel of the port here).  The expert weights stay fp32 (their names are
not in `serving.quantize.QUANT_LEAVES`) and are cast to the activation
dtype on every call, as JAX does.  The sharding constraints are JAX's:
groups over the batch axes, experts over ``model`` (expert parallelism);
`models.sharding.constrain` is a no-op on plain tensors.

Router aux loss = load-balancing loss of Switch/GShard
(E · Σ_e fraction_tokens_e · mean_prob_e), computed globally.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from . import sharding
from .layers import _gelu, _init

# per-group token block for routing; must divide the token count (falls
# back to one global group otherwise, e.g. a serving batch)
DEFAULT_GROUP = 4096


def moe_init(gen, cfg, *, lead=(), device=None):
    """Router and stacked expert weights, every leaf prefixed by
    ``lead``.  As in JAX, an expert leaf [E, ...] is scaled by 1/√E."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(lead=lead, device=device)
    p = {"router": _init(gen, (D, E), scale=0.02, **kw),
         "moe_w1": _init(gen, (E, D, Fd), **kw)}
    if cfg.ffn in ("swiglu", "geglu"):
        p["moe_w3"] = _init(gen, (E, D, Fd), **kw)
    p["moe_w2"] = _init(gen, (E, Fd, D), **kw)
    return p


def _group_size(N: int) -> int:
    if N % DEFAULT_GROUP == 0:
        return DEFAULT_GROUP
    return N  # one group


def _one_hot(idx, n):
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def route(p, xt, cfg, T: int, capacity: int | None = None) -> dict:
    """Top-k routing of tokens xt [N, D] (T of them a sequence) to expert
    slots, as `repro.models.moe.moe_ffn` computes it: ``probs`` [N, E];
    per group ``onehot`` [n_g, G, K, E], ``pos`` and ``keep`` [n_g, G, K]
    (queue position of each (token, k) and whether it is under the
    capacity C), and the ``dispatch`` and ``combine`` tensors
    [n_g, G, E, C]."""
    N, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    f32 = torch.float32
    logits = xt.to(f32) @ p["router"].to(f32)                    # [N, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    G = _group_size(N)
    n_g = N // G
    if capacity is None:
        if T == 1:   # decode: no capacity drops (every token must route)
            capacity = G
        else:
            capacity = int(cfg.capacity_factor * G * K / E) or 1
    C = max(1, min(capacity, G))

    # group the token axis: [n_g, G, ...]
    onehot = _one_hot(gate_idx, E).reshape(n_g, G, K, E)
    # position of each (token, k) within its expert's per-group queue
    flat = onehot.reshape(n_g, G * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(n_g, G, K, E)
    pos = (pos * onehot).sum(-1)                                 # [n_g,G,K]
    keep = pos < C
    gate = gate_vals.reshape(n_g, G, K) * keep.to(f32)

    slot_oh = _one_hot(pos.to(torch.int64), C)
    dispatch = torch.einsum("gnke,gnkc->gnec", onehot,
                            slot_oh * keep[..., None].to(f32))
    combine = torch.einsum("gnke,gnkc,gnk->gnec", onehot, slot_oh, gate)
    return {"probs": probs, "onehot": onehot, "pos": pos, "keep": keep,
            "dispatch": dispatch, "combine": combine}


def _experts(xe, w1, w3, w2, cfg):
    """The expert FFNs: xe [n_g, E, C, D] → [n_g, E, C, D].  On DTensors
    each rank runs its own groups and experts (`local_map`), the weights
    gathered over the batch axes: DTensor's own einsum backward views a
    transposed local shard that cannot be viewed (granite-moe's train_4k
    on the 16×16 mesh; ROADMAP.md C)."""
    def fn(xe, w1, w3, w2):
        if w3 is not None:
            act = F.silu if cfg.ffn == "swiglu" else _gelu
            h = act(torch.einsum("gecd,edf->gecf", xe, w1))
            h = h * torch.einsum("gecd,edf->gecf", xe, w3)
        else:
            h = _gelu(torch.einsum("gecd,edf->gecf", xe, w1))
        return torch.einsum("gecf,efd->gecd", h, w2)
    if not sharding.is_sharded(xe, w1):
        return fn(xe, w1, w3, w2)
    mesh = next(t.device_mesh for t in (xe, w1) if sharding.is_sharded(t))
    xe, w1, w3, w2 = (sharding.replicated(t, mesh) for t in (xe, w1, w3, w2))
    pl_x = list(xe.placements)
    pl_w = [Shard(0) if p == Shard(1) else Replicate() for p in pl_x]
    # a weight gathered over the groups' split: each rank's gradient is a
    # partial sum over it
    pl_g = [Partial() if p == Shard(0) else q for p, q in zip(pl_x, pl_w)]
    return local_map(fn, out_placements=pl_x,
                     in_placements=(pl_x, pl_w, None if w3 is None else pl_w,
                                    pl_w),
                     in_grad_placements=(pl_x, pl_g,
                                         None if w3 is None else pl_g, pl_g),
                     redistribute_inputs=True)(xe, w1, w3, w2)


def _combine(combine, ye):
    """y [n_g, G, D] = Σ over (e, c) of combine [n_g, G, E, C] · ye
    [n_g, E, C, D].  On DTensors as one batched matmul over (e, c)
    flattened expert-major, so that the experts' split over ``model``
    stays a plain split: `torch.einsum` may flatten (c, e), a strided
    split, for which DTensor weighs layouts by a graph search of about a
    second each (granite-moe's train_4k on 2×16×16; ROADMAP.md C)."""
    if not sharding.is_sharded(combine, ye):
        return torch.einsum("gnec,gecd->gnd", combine, ye)
    g, n, E, C = combine.shape
    return torch.matmul(combine.reshape(g, n, E * C),
                        ye.reshape(g, E * C, ye.shape[-1]))


def moe_ffn(p, x, cfg, capacity: int | None = None):
    """x: [B, T, D] → (y [B, T, D], aux_loss: a 0-d fp32 tensor)."""
    B, T, D = x.shape
    E, N = cfg.n_experts, B * T
    rt = route(p, x.reshape(N, D), cfg, T, capacity)
    xg = x.reshape(rt["onehot"].shape[0], -1, D)
    xg = sharding.constrain(xg, ("batch", None, None))

    # dispatch: [n_g, E, C, D]; groups shard over batch, experts over model
    xe = torch.einsum("gnec,gnd->gecd", rt["dispatch"].to(x.dtype), xg)
    xe = sharding.constrain(xe, ("batch", "tensor", None, None))
    w3 = p["moe_w3"].to(x.dtype) if cfg.ffn in ("swiglu", "geglu") else None
    ye = _experts(xe, p["moe_w1"].to(x.dtype), w3,
                  p["moe_w2"].to(x.dtype), cfg)
    ye = sharding.constrain(ye, ("batch", "tensor", None, None))
    y = _combine(rt["combine"].to(x.dtype), ye)

    # load-balancing aux loss (global)
    frac = rt["onehot"].sum(dim=2).reshape(N, E).mean(dim=0)
    mprob = rt["probs"].mean(dim=0)
    aux = E * (frac * mprob).sum() * cfg.router_aux_weight
    return y.reshape(B, T, D), aux.to(torch.float32)
