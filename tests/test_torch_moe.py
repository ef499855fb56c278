"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
`repro.models.moe`, mirroring the six tests of `tests/test_moe.py` on the
same weights (a JAX `moe_init` tree bridged with `params_from_numpy`).

The config is granite-moe-1b-a400m `reduced()` (d 64, 8 experts, top-2,
expert width 32, fp32).  `reduced()` raises the capacity factor to 8, so
no token drops there; the drop path the full config serves is held at
``capacity_factor=1.25`` and at explicit capacities.  Outputs agree within
1e-5·(max|y|+1), aux losses within 1e-6 relative, and the routing (top-k
sets, queue positions, kept masks) is equal.  In bf16 activations a
rounding can turn a near-tie of the router, in both packages alike
(`test_bf16_gap_comes_from_routing_flips_in_both_packages`).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
import repro_torch.models.moe as tmoe  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCH = "granite-moe-1b-a400m"
REL = 1e-5


def _close(got, want, rel=REL, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want,
                               rtol=rel, atol=rel * (np.abs(want).max() + 1),
                               err_msg=msg)


def _cfgs(**over):
    return jget(ARCH).reduced(**over), tget(ARCH).reduced(**over)


def _params(seed, cfg_j):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cfg_j)
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(jp, tp, x, cfgs, **kw):
    """(JAX's y, aux), (the port's y, aux) on the same x."""
    yj, aj = jmoe.moe_ffn(jp, jnp.asarray(x), cfgs[0], **kw)
    yt, at = tmoe.moe_ffn(tp, torch.from_numpy(x), cfgs[1], **kw)
    return (yj, aj), (yt, at)


def _dense_ref(p, x, cfg):
    """`tests/test_moe.py`'s reference: every token to its top-k experts,
    no capacity."""
    B, T, D = x.shape
    xt = np.asarray(x, np.float32).reshape(-1, D)
    logits = xt @ np.asarray(p["router"], np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[:, :cfg.top_k]
    out = np.zeros_like(xt)
    w1, w3, w2 = (np.asarray(p[k], np.float32)
                  for k in ("moe_w1", "moe_w3", "moe_w2"))
    for n in range(xt.shape[0]):
        gv = probs[n, idx[n]]
        gv = gv / gv.sum()
        for j, ex in enumerate(idx[n]):
            h = xt[n] @ w1[ex]
            h = h / (1 + np.exp(-h)) * (xt[n] @ w3[ex])  # silu gate
            out[n] += gv[j] * (h @ w2[ex])
    return out.reshape(B, T, D)


def _jax_routing(p, x, cfg, G, C):
    """JAX's dispatch of `moe_ffn`, step by step (as
    `tests/test_moe.py::test_grouped_dispatch_every_kept_token_one_slot`
    reproduces it): queue positions, kept mask and dispatch."""
    B, T, D = x.shape
    N, E, K = B * T, cfg.n_experts, cfg.top_k
    xt = jnp.asarray(x).reshape(N, D)
    probs = jax.nn.softmax(xt @ p["router"], -1)
    _, gate_idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx, E).reshape(N // G, G, K, E)
    flat = onehot.reshape(N // G, G * K, E)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(N // G, G, K, E)
    pos = jnp.sum(pos * onehot, axis=-1)
    keep = pos < C
    slot_oh = jax.nn.one_hot(pos.astype(jnp.int32), C)
    dispatch = jnp.einsum("gnke,gnkc->gnec", onehot,
                          slot_oh * keep[..., None])
    return {"onehot": onehot, "pos": pos, "keep": keep, "dispatch": dispatch}


def test_moe_matches_dense_reference_when_capacity_large():
    cfgs = _cfgs()
    jp, tp = _params(0, cfgs[0])
    x = _x(0, 2, 6, 64)
    (yj, aj), (yt, at) = _both(jp, tp, x, cfgs, capacity=12)
    _close(yt, yj)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    np.testing.assert_allclose(yt.numpy(), _dense_ref(jp, x, cfgs[0]),
                               rtol=2e-3, atol=2e-3)
    assert at.dtype == torch.float32 and at.ndim == 0 and float(at) > 0


def test_capacity_drops_tokens():
    cfgs = _cfgs()
    jp, tp = _params(1, cfgs[0])
    x = _x(1, 4, 8, 64)
    (yj_full, _), (yt_full, _) = _both(jp, tp, x, cfgs, capacity=32)
    (yj_tight, _), (yt_tight, _) = _both(jp, tp, x, cfgs, capacity=1)
    _close(yt_full, yj_full)
    _close(yt_tight, yj_tight)
    # tight capacity changes (drops) some outputs, and dropped tokens
    # contribute zero rather than garbage
    assert not torch.allclose(yt_full, yt_tight)
    assert bool(torch.isfinite(yt_tight).all())


def test_aux_loss_prefers_balance():
    cfgs = _cfgs()
    jp, tp = _params(2, cfgs[0])
    skew = np.zeros(tuple(tp["router"].shape), np.float32)
    skew[:, 0] = 5.0
    jp_skew = dict(jp, router=jp["router"] + jnp.asarray(skew))
    tp_skew = dict(tp, router=tp["router"] + torch.from_numpy(skew))
    x = _x(3, 2, 16, 64)
    (_, aj_bal), (_, at_bal) = _both(jp, tp, x, cfgs)
    (_, aj_skew), (_, at_skew) = _both(jp_skew, tp_skew, x, cfgs)
    np.testing.assert_allclose(float(at_bal), float(aj_bal), rtol=1e-6)
    np.testing.assert_allclose(float(at_skew), float(aj_skew), rtol=1e-6)
    assert float(at_skew) > float(at_bal)


def test_decode_capacity_is_lossless():
    """T == 1: the capacity is the group (every token routes), in both."""
    cfgs = _cfgs()
    jp, tp = _params(4, cfgs[0])
    x = _x(4, 8, 1, 64)
    (yj, _), (yt, _) = _both(jp, tp, x, cfgs)
    _close(yt, yj)
    assert bool(tmoe.route(tp, torch.from_numpy(x).reshape(8, 64), cfgs[1],
                           1)["keep"].all())
    np.testing.assert_allclose(yt.numpy(), _dense_ref(jp, x, cfgs[0]),
                               rtol=2e-3, atol=2e-3)


def test_grouped_dispatch_matches_global(monkeypatch):
    """Grouped routing (G < N) equals one global group when nothing drops,
    with `DEFAULT_GROUP` patched alike in both packages; each grouping also
    matches JAX's."""
    cfgs = _cfgs(n_layers=2, n_experts=4, top_k=2, capacity_factor=8.0)
    jp, tp = _params(0, cfgs[0])
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 8, 64)))
    out = {}
    for group in (8, 16):          # N = 16: two groups, then one
        monkeypatch.setattr(jmoe, "DEFAULT_GROUP", group)
        monkeypatch.setattr(tmoe, "DEFAULT_GROUP", group)
        assert tmoe._group_size(16) == group
        (yj, aj), (yt, at) = _both(jp, tp, x, cfgs)
        _close(yt, yj, msg=f"group {group}")
        np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
        out[group] = (yt, at)
    np.testing.assert_allclose(out[8][0].numpy(), out[16][0].numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(out[8][1]), float(out[16][1]),
                               rtol=1e-5)


def test_grouped_dispatch_every_kept_token_one_slot(monkeypatch):
    """Within a group each expert slot holds ≤ 1 token and each kept
    (token, k) choice fills exactly one slot; the port's routing equals
    JAX's (positions, kept mask, dispatch)."""
    cfgs = _cfgs(n_layers=2, n_experts=4, top_k=2, capacity_factor=1.0)
    jp, tp = _params(2, cfgs[0])
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (2, 8, 64)))
    monkeypatch.setattr(tmoe, "DEFAULT_GROUP", 8)
    rt = tmoe.route(tp, torch.from_numpy(x).reshape(16, 64), cfgs[1], 8)
    C = max(1, int(1.0 * 8 * 2 / 4))
    want = _jax_routing(jp, x, cfgs[0], 8, C)
    assert tuple(rt["dispatch"].shape) == (2, 8, 4, C)
    for name in ("onehot", "pos", "keep", "dispatch"):
        np.testing.assert_array_equal(rt[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    per_slot = rt["dispatch"].sum(dim=1)                  # [n_g, E, C]
    assert float(per_slot.max()) <= 1.0
    filled = rt["dispatch"].sum(dim=(2, 3))               # [n_g, G]
    assert torch.equal(filled, rt["keep"].sum(dim=2).float())


def test_capacity_factor_125_drops_tokens_as_jax_does():
    """The full config's capacity factor 1.25 at T = 16 (C = int(1.25 · 16 ·
    2 / 8) = 5 for 32 choices over 8 experts): tokens drop, the drop masks
    equal JAX's, and outputs and aux agree; the rows of fully dropped
    tokens are 0."""
    cfgs = _cfgs(capacity_factor=1.25)
    jp, tp = _params(5, cfgs[0])
    x = _x(5, 1, 16, 64)
    (yj, aj), (yt, at) = _both(jp, tp, x, cfgs)
    _close(yt, yj)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    rt = tmoe.route(tp, torch.from_numpy(x).reshape(16, 64), cfgs[1], 16)
    want = _jax_routing(jp, x, cfgs[0], 16, 5)
    np.testing.assert_array_equal(rt["keep"].numpy(), np.asarray(want["keep"]))
    np.testing.assert_array_equal(rt["pos"].numpy(), np.asarray(want["pos"]))
    kept = rt["keep"][0]
    assert 0 < int((~kept).sum()) and int(kept.sum()) <= 5 * 8
    gone = ~kept.any(dim=1)
    assert bool((yt[0][gone] == 0).all())
    # with room for every choice, the same tokens would not drop
    (yj_big, _), (yt_big, _) = _both(jp, tp, x, cfgs, capacity=16)
    _close(yt_big, yj_big)
    assert not torch.allclose(yt, yt_big)


@pytest.mark.parametrize("ffn", ["geglu", "gelu"])
def test_other_expert_ffns_match_jax(ffn):
    """GeGLU and plain GELU experts (granite uses SwiGLU)."""
    cfgs = tuple(dataclasses.replace(c, ffn=ffn) for c in _cfgs())
    jp, tp = _params(6, cfgs[0])
    assert ("moe_w3" in tp) == (ffn == "geglu")
    x = _x(6, 2, 5, 64)
    (yj, aj), (yt, at) = _both(jp, tp, x, cfgs)
    _close(yt, yj)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


def test_bf16_gap_comes_from_routing_flips_in_both_packages(monkeypatch):
    """Why granite's plain-engine logit check is held in fp32 activations.
    Both packages' reduced granite-moe-1b-a400m forward on the same weights
    and 16 sequences of 12 tokens, in fp32 and in bf16 activations, with
    each MoE layer's top-k expert sets recorded.  In fp32 the packages
    agree within 1e-4·(max|l|+1).  In each package, bf16 moves the routing
    of some tokens off its fp32 routing (a rounding of the router input
    turns a near-tie), and the logits of exactly those sequences jump by
    O(max|l|) (1.6–5.0 on max|l| 4.5 on a CPU; at least 0.2·(max|l|+1)
    here), while every sequence whose routing never moves stays within
    0.05·(max|l|+1) (at most 0.126 on a CPU).  So the bf16 gap is the
    random-weight MoE's, in both packages, not a fault of the port."""
    cfg_j, cfg_t = _cfgs()
    jp = jt.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(1, 512, size=(16, 12))
    K = cfg_j.top_k

    def sets(probs):
        return np.sort(np.argsort(-np.asarray(probs), -1)[:, :K], -1)

    run = {}
    for name, jd, td in (("fp32", jnp.float32, torch.float32),
                         ("bf16", jnp.bfloat16, torch.bfloat16)):
        cj = dataclasses.replace(cfg_j, act_dtype=jd)
        ct = dataclasses.replace(cfg_t, act_dtype=td)
        jrec, trec = [], []
        jffn, troute = jt.moe_ffn, tmoe.route

        def jspy(p, x, cfg, capacity=None):
            probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(
                jnp.float32) @ p["router"].astype(jnp.float32), -1)
            jax.debug.callback(lambda a: jrec.append(sets(a)), probs,
                               ordered=True)
            return jffn(p, x, cfg, capacity)

        def tspy(p, xt, cfg, T, capacity=None):
            rt = troute(p, xt, cfg, T, capacity)
            trec.append(sets(rt["probs"]))
            return rt
        monkeypatch.setattr(jt, "moe_ffn", jspy)
        monkeypatch.setattr(tmoe, "route", tspy)
        hj, _, _ = jax.jit(lambda p, t, c=cj: jt.forward(p, t, c))(
            jp, jnp.asarray(toks, jnp.int32))
        ht, _, _ = tt.forward(tp, torch.from_numpy(toks), ct)
        monkeypatch.setattr(jt, "moe_ffn", jffn)
        monkeypatch.setattr(tmoe, "route", troute)
        assert len(jrec) == len(trec) == cfg_j.n_layers
        run[name] = {
            "jax": (np.asarray(jt.logits_fn(jp, hj, cj), np.float32), jrec),
            "port": (tt.logits_fn(tp, ht, ct).float().numpy(), trec)}
    _close(torch.from_numpy(run["fp32"]["port"][0]), run["fp32"]["jax"][0],
           rel=1e-4)
    for pkg in ("jax", "port"):
        (l32, s32), (l16, s16) = run["fp32"][pkg], run["bf16"][pkg]
        moved = np.zeros(toks.size, bool)
        for a, b in zip(s32, s16):
            moved |= (a != b).any(-1)
        moved = moved.reshape(toks.shape).any(-1)
        gap = np.abs(l16 - l32).max(axis=(1, 2))
        scale = np.abs(l32).max() + 1
        assert 0 < moved.sum() < len(moved), pkg
        assert gap[~moved].max() <= 0.05 * scale, (pkg, gap[~moved].max())
        assert gap[moved].max() >= 0.2 * scale, (pkg, gap[moved])
        assert gap.argmax() in np.flatnonzero(moved), pkg
