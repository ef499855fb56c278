"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of `repro.models.griffin`:

    x → (gelu gate branch) ⊙ (proj → causal conv1d(w=4) → RG-LRU) → out

RG-LRU:  r_t = σ(W_r u_t),  i_t = σ(W_i u_t)
         log a_t = −c · softplus(Λ) ⊙ r_t           (c = 8)
         h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ u_t)

The projections are plain matmuls on the float weights cast to the
activation dtype, as in the JAX package: none of these leaves is packed
(their names are not in `serving.quantize.QUANT_LEAVES`), so no kernel of
the port runs here.  The recurrence is a doubling scan in fp32 (log2(T)
elementwise steps, no step at T = 1) where JAX runs
`jax.lax.associative_scan`; products of ``a`` only shrink, so it cannot
overflow.

State per layer: ``h`` [B, W] and ``conv`` [B, K−1, W], both fp32.  A
given state is updated in place (``copy_`` into the tensors, which are
views of the engine's stacked cache) and returned.
"""

from __future__ import annotations

import torch

from .layers import _gelu, _init

C_RGLRU = 8.0


def griffin_init(gen, cfg, *, lead=(), device=None):
    """One Griffin mixer's parameters, every leaf prefixed by ``lead``."""
    D = cfg.d_model
    W = cfg.lru_width or D
    kw = dict(lead=lead, device=device)
    lead = tuple(lead)
    return {
        "w_gate": _init(gen, (D, W), **kw),     # gelu branch
        "w_x": _init(gen, (D, W), **kw),        # recurrent branch input
        "conv_w": _init(gen, (cfg.conv1d_width, W), scale=0.3, **kw),
        "conv_b": torch.zeros(lead + (W,), device=device),
        "w_r": _init(gen, (W, W), scale=0.01, **kw),
        "w_i": _init(gen, (W, W), scale=0.01, **kw),
        "lam": torch.full(lead + (W,), 2.0, device=device),
        "w_out": _init(gen, (W, D), **kw),
    }


def griffin_state_init(cfg, batch, *, lead=(), device=None):
    W = cfg.lru_width or cfg.d_model
    lead = tuple(lead)
    return {"h": torch.zeros(lead + (batch, W), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv1d_width - 1, W),
                                dtype=torch.float32, device=device)}


def _causal_conv1d(x, w, b, prev=None):
    """x: [B, T, W]; w: [K, W] depthwise; prev: [B, K−1, W] carried
    context → (out [B, T, W], the last K−1 inputs [B, K−1, W])."""
    K = w.shape[0]
    B, T, Wd = x.shape
    if prev is None:
        prev = torch.zeros((B, K - 1, Wd), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + T] * w[i].to(x.dtype) for i in range(K))
    return out + b.to(x.dtype), xp[:, -(K - 1):]


def _rglru(x, loga, h0=None):
    """Diagonal linear recurrence ``h_t = a_t h_{t−1} + sqrt(1 − a_t²) x_t``
    in fp32.  x: [B, T, W] already gated by i_t; loga: [B, T, W] (≤ 0);
    h0: [B, W] or None → h [B, T, W]."""
    f32 = torch.float32
    a = torch.exp(loga.to(f32))
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    b = mult * x.to(f32)
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat([b[:, :1] + (a[:, 0] * h0.to(f32))[:, None],
                       b[:, 1:]], dim=1)
    # doubling scan of (a, b) pairs under (l, r) → (a_l a_r, a_r b_l + b_r):
    # after the step of span s, position t holds the pair of (t − 2s, t]
    T, s = b.shape[1], 1
    while s < T:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        if 2 * s < T:
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def griffin_mixer(p, x, cfg, state=None):
    """x: [B, T, D] → (out [B, T, D], state): ``h`` and ``conv`` of a given
    state are overwritten in place."""
    gate = _gelu(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_x"].to(x.dtype)
    prev = state["conv"] if state is not None else None
    u, conv_carry = _causal_conv1d(u, p["conv_w"], p["conv_b"], prev)

    u32 = u.to(torch.float32)
    r = torch.sigmoid(u32 @ p["w_r"])
    i = torch.sigmoid(u32 @ p["w_i"])
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    loga = -C_RGLRU * softplus * r
    h = _rglru(i * u32, loga, None if state is None else state["h"])

    out = (gate * h.to(x.dtype)) @ p["w_out"].to(x.dtype)
    if state is not None:
        state["h"].copy_(h[:, -1])
        state["conv"].copy_(conv_carry)
    return out, state
