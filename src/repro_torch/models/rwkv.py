"""RWKV6 ("Finch") layer: time-mix with data-dependent decay + channel-mix.

Counterpart of `repro.models.rwkv` (arXiv:2404.05892): static token-shift
interpolation μ_{r,k,v,w,g}, projections r/k/v/g, a low-rank data-dependent
decay ``log w_t = −exp(w0 + tanh(x_w A) B)`` (≤ 0 per channel), a per-head
bonus u for the current token, the WKV recurrence (`kernels/ops.wkv6`),
per-head group norm and an output gate; channel-mix is RWKV's squared-ReLU
gated MLP.

The eight projections go through `layers.dense`, so packed leaves reach
`ops.log_matmul`; the decay's low-rank product stays a plain fp32 matmul,
as in the JAX package.  The WKV call follows the config's sequence-mixer
dispatch, ``cfg.attn_impl``: "blockwise" (JAX's default, which the trainer
sets, and which the JAX package pins for the WKV) runs the chunked plain
`wkv6_chunked` with JAX's chunk rule, which autograd differentiates; any
other value resolves ``impl="auto"``, the CUDA kernel on the card (which
has no backward and refuses inputs that require grad) and `wkv6_chunked`
on the CPU.

State per layer: ``x_prev_t`` and ``x_prev_c`` [B, D] fp32 and ``wkv``
[B, H, K, V] fp32.  A given state is updated in place (``copy_`` into the
tensors, which are views of the engine's stacked cache) and returned.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .layers import _init, dense


def _mm(x, w):
    """x @ w via `layers.dense` (no cfg: no fake-quant, as in JAX); a packed
    `QuantizedTensor` goes to `ops.log_matmul`."""
    return dense({"w": w}, x)


def rwkv_init(gen, cfg, *, lead=(), device=None):
    """One RWKV layer's time-mix and channel-mix parameters, every leaf
    prefixed by ``lead``."""
    D, hs = cfg.d_model, cfg.rwkv_head_size
    H, L, Fd = D // hs, cfg.rwkv_decay_lora, cfg.d_ff
    kw = dict(lead=lead, device=device)

    def full(shape, value):
        return torch.full(tuple(lead) + shape, value, device=device)

    return {
        # time-mix
        "mu": full((5, D), 0.5),                   # r, k, v, w, g shifts
        "wr": _init(gen, (D, D), **kw), "wk": _init(gen, (D, D), **kw),
        "wv": _init(gen, (D, D), **kw), "wg": _init(gen, (D, D), **kw),
        "wo": _init(gen, (D, D), **kw),
        "w0": full((D,), -0.6),                    # base decay
        "wA": _init(gen, (D, L), scale=0.01, **kw),
        "wB": _init(gen, (L, D), scale=0.01, **kw),
        "u": _init(gen, (H, hs), scale=0.5, **kw),
        "ln_x": full((D,), 1.0),                   # per-head group norm scale
        # channel-mix
        "mu_c": full((2, D), 0.5),                 # k, r shifts
        "ck": _init(gen, (D, Fd), **kw),
        "cv": _init(gen, (Fd, D), **kw),
        "cr": _init(gen, (D, D), **kw),
    }


def _token_shift(x, x_prev):
    """[B, T, D] → the previous token's features (x_prev fills t = 0)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def rwkv_state_init(cfg, batch, *, lead=(), device=None):
    D, hs = cfg.d_model, cfg.rwkv_head_size
    lead = tuple(lead)
    f32 = torch.float32
    return {"x_prev_t": torch.zeros(lead + (batch, D), dtype=f32,
                                    device=device),
            "x_prev_c": torch.zeros(lead + (batch, D), dtype=f32,
                                    device=device),
            "wkv": torch.zeros(lead + (batch, D // hs, hs, hs), dtype=f32,
                               device=device)}


def _prev(state, name, x):
    B, _, D = x.shape
    if state is None:
        return torch.zeros((B, D), dtype=x.dtype, device=x.device)
    return state[name].to(x.dtype)


def rwkv_time_mix(p, x, cfg, state=None):
    """x: [B, T, D] → (out [B, T, D], state): ``x_prev_t`` and ``wkv`` of a
    given state are overwritten in place."""
    B, T, D = x.shape
    hs = cfg.rwkv_head_size
    H = D // hs
    xx = _token_shift(x, _prev(state, "x_prev_t", x)) - x
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + xx * mu[i] for i in range(5))

    r = _mm(xr, p["wr"]).reshape(B, T, H, hs)
    k = _mm(xk, p["wk"]).reshape(B, T, H, hs)
    v = _mm(xv, p["wv"]).reshape(B, T, H, hs)
    g = F.silu(_mm(xg, p["wg"]))

    # data-dependent decay (Finch): logw = -exp(w0 + tanh(xw A) B), in fp32
    lora = torch.tanh(xw.to(torch.float32) @ p["wA"]) @ p["wB"]
    logw = -torch.exp(torch.clamp(p["w0"] + lora, -8.0, 2.0))
    logw = logw.reshape(B, T, H, hs)

    o, new_wkv = ops.wkv6(r, k, v, logw, p["u"],
                          state=None if state is None else state["wkv"],
                          impl="blockwise" if cfg.attn_impl == "blockwise"
                          else "auto", chunk=min(64, max(16, T)))

    # per-head group norm (population variance, as jnp.var)
    o32 = o.to(torch.float32).reshape(B, T, H, hs)
    mean = o32.mean(-1, keepdim=True)
    var = o32.var(-1, keepdim=True, correction=0)
    o = ((o32 - mean) * torch.rsqrt(var + 1e-5)).reshape(B, T, D)
    o = (o * p["ln_x"]).to(x.dtype)

    out = _mm(o * g, p["wo"])
    if state is not None:
        state["x_prev_t"].copy_(x[:, -1])
        state["wkv"].copy_(new_wkv)
    return out, state


def rwkv_channel_mix(p, x, cfg, state=None):
    """x: [B, T, D] → (out [B, T, D], state): ``x_prev_c`` of a given
    state is overwritten in place."""
    xx = _token_shift(x, _prev(state, "x_prev_c", x)) - x
    mu = p["mu_c"].to(x.dtype)
    xk = x + xx * mu[0]
    xr = x + xx * mu[1]
    k = torch.square(F.relu(_mm(xk, p["ck"])))
    out = torch.sigmoid(_mm(xr, p["cr"])) * _mm(k, p["cv"])
    if state is not None:
        state["x_prev_c"].copy_(x[:, -1])
    return out, state
