"""The port's RWKV6 model and its serving (`repro_torch.models.rwkv`, the
"rwkv" layers of `repro_torch.models.transformer`, `ServeEngine` on
rwkv6-1.6b) against the JAX package's, on the same weights (a JAX parameter
tree bridged with `transformer.params_from_numpy`).

The config is `rwkv6-1.6b` reduced (2 layers, d 64, head size 16, fp32
activations).  Hidden states and logits agree within 1e-4·(max|h|+1), with
fp weights and with weights packed by `quantize_params`, whose codes equal
JAX's byte for byte.  On the CPU the WKV call of the port's layer resolves
to the chunked plain version with JAX's chunk rule, which is what the JAX
layer runs.  Greedy outputs of the port's engine equal JAX's engine.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import rwkv as jr  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import engine as je  # noqa: E402
from repro.serving import quantize as jq  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core.logquant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import rwkv as tr  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import quantize as tq  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServeEngine)

ARCH = "rwkv6-1.6b"
PROMPT = np.array([5, 17, 42, 7, 99], np.int32)
PACKED_LEAVES = {"wr", "wk", "wv", "wg", "wo", "ck", "cv", "cr"}


def _close(got, want, rel=1e-4, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want,
                               rtol=rel, atol=rel * (np.abs(want).max() + 1),
                               err_msg=msg)


def _cfgs():
    return jget(ARCH).reduced(), tget(ARCH).reduced()


@functools.lru_cache(maxsize=None)
def _params(packed=False):
    """The reduced config's JAX params and the same weights in the port,
    packed by each package's `quantize_params` when ``packed``."""
    jp = jt.init_params(_cfgs()[0], jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    if packed:
        return jq.quantize_params(jp), tq.quantize_params(tp)
    return jp, tp


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(1, 512, size=shape)


def test_rwkv_is_served_and_the_rest_of_item_13_is_refused():
    """rwkv6-1.6b passes `check_supported`, as do the Griffin and MoE archs
    that closed item 13; embedding inputs (item 14) still raise, naming
    the roadmap."""
    for arch in (ARCH, "recurrentgemma-2b", "granite-moe-1b-a400m"):
        tt.check_supported(tget(arch))
    for arch in ("musicgen-large", "qwen2-vl-2b"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
            tt.check_supported(tget(arch))


def test_init_params_tree_matches_jax():
    """The port's stacked tree has JAX's keys and shapes leaf by leaf, so
    `params_from_numpy` maps one onto the other."""
    cfg_j, cfg_t = _cfgs()
    shapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda k: jt.init_params(cfg_j, k), jax.random.PRNGKey(0)))

    def tshapes(tree):
        if isinstance(tree, dict):
            return {k: tshapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert tshapes(tt.init_params(cfg_t, 0, device="cpu")) == shapes
    lp = tt.init_params(cfg_t, 0, device="cpu")["segments"]["seg0"]["l0"]
    assert "ffn" not in lp and "attn" not in lp
    assert float(lp["rwkv"]["w0"].max()) == pytest.approx(-0.6)


def test_init_cache_matches_jax():
    """Per layer ``x_prev_t``, ``x_prev_c`` [n_rep, B, D] and ``wkv``
    [n_rep, B, H, K, V], all fp32 whatever the cache dtype (as in JAX)."""
    cfg_j, cfg_t = _cfgs()
    jc = jt.init_cache(cfg_j, 3, 16, jnp.bfloat16)["segments"]["seg0"]["l0"]
    tc = tt.init_cache(cfg_t, 3, 16, torch.bfloat16,
                       device="cpu")["segments"]["seg0"]["l0"]
    assert set(tc) == set(jc) == {"x_prev_t", "x_prev_c", "wkv"}
    for name, t in tc.items():
        assert tuple(t.shape) == jc[name].shape, name
        assert t.dtype == torch.float32 and jc[name].dtype == jnp.float32


def test_quantize_params_matches_jax():
    """The eight projections of each layer pack to codes and scales
    byte-equal to JAX's; `lm_head`, the decay LoRA, u, the shifts, w0 and
    ln_x stay fp32, as in JAX."""
    jpk, tpk = _params(packed=True)
    jleaves = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_leaves_with_path(
                   jpk, is_leaf=lambda x: hasattr(x, "packed"))}
    seen = set()

    def walk(tree, path, name=None):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + f"[{k!r}]", k)
            return
        want = jleaves[path]
        if isinstance(tree, QuantizedTensor):
            seen.add(name)
            assert tree.shape == tuple(want.shape)
            np.testing.assert_array_equal(tree.scale.numpy(),
                                          np.asarray(want.scale))
            np.testing.assert_array_equal(tree.packed.numpy(),
                                          np.asarray(want.packed))
        else:
            assert not hasattr(want, "packed"), path
            assert tree.dtype == torch.float32, path
    walk(tpk, "")
    assert seen == PACKED_LEAVES


@pytest.mark.parametrize("packed", [False, True])
def test_forward_matches_jax(packed):
    """Hidden states and logits of a 12-token batch of 2, fp and packed
    weights, on the kernel route (the plain version on the CPU)."""
    jp, tp = _params(packed)
    cfg_j, cfg_t = _cfgs()
    toks = _tokens(1, (2, 12))
    hj, _, _ = jax.jit(lambda p, t: jt.forward(p, t, cfg_j))(
        jp, jnp.asarray(toks, jnp.int32))
    ht, cache, aux = tt.forward(tp, torch.from_numpy(toks), cfg_t)
    assert cache is None and aux == 0.0 and ht.shape == (2, 12, 64)
    _close(ht, hj)
    _close(tt.logits_fn(tp, ht, cfg_t), jt.logits_fn(jp, hj, cfg_j))


@pytest.mark.parametrize("T", [1, 5, 20])
def test_layer_with_state_matches_jax(T):
    """Time-mix then channel-mix of one layer on a random carried state:
    outputs and every part of the new state against JAX's, and the state
    tensors are written in place (views of a stacked cache)."""
    cfg_j, cfg_t = _cfgs()
    jp, tp = _params()
    lj = jax.tree.map(lambda a: a[1], jp["segments"]["seg0"]["l0"]["rwkv"])
    lt = tt._rep(tp["segments"]["seg0"], 1)["l0"]["rwkv"]
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T, 64)).astype(np.float32)
    state = {"x_prev_t": rng.normal(size=(2, 64)),
             "x_prev_c": rng.normal(size=(2, 64)),
             "wkv": rng.normal(size=(2, 4, 16, 16)) * 0.3}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    oj, sj = jr.rwkv_time_mix(lj, jnp.asarray(x), cfg_j,
                              jax.tree.map(jnp.asarray, state))
    oj2, sj2 = jr.rwkv_channel_mix(lj, jnp.asarray(x), cfg_j,
                                   jax.tree.map(jnp.asarray, state))
    stack = {k: torch.from_numpy(np.stack([v, v]))
             for k, v in state.items()}                   # [2 reps, ...]
    st = {k: v[1] for k, v in stack.items()}              # views
    ot, st_out = tr.rwkv_time_mix(lt, torch.from_numpy(x), cfg_t, st)
    ot2, _ = tr.rwkv_channel_mix(lt, torch.from_numpy(x), cfg_t, st)
    assert st_out is st
    _close(ot, oj)
    _close(ot2, oj2)
    for name, want in {**sj, **sj2}.items():
        _close(stack[name][1], want, msg=name)
        _close(stack[name][0], state[name], rel=0, msg=f"{name} rep 0")


def test_prefill_then_decode_equals_the_full_forward():
    """Prefill 9 tokens, then decode 3 one at a time: each step's logits
    equal the full forward's at that position and JAX's prefill/decode."""
    cfg_j, cfg_t = _cfgs()
    jp, tp = _params()
    toks = _tokens(2, (1, 12))
    h_full, _, _ = tt.forward(tp, torch.from_numpy(toks), cfg_t)
    cache = tt.init_cache(cfg_t, 1, 24, torch.float32, device="cpu")
    jc = jt.init_cache(cfg_j, 1, 24, jnp.float32)
    ht, cache = tt.prefill(tp, torch.from_numpy(toks[:, :9]), cfg_t, cache)
    hj, jc = jax.jit(lambda p, t, c: jt.prefill(p, t, cfg_j, c))(
        jp, jnp.asarray(toks[:, :9], jnp.int32), jc)
    _close(ht, h_full[:, 8:9])
    _close(ht, hj)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, t, cfg_j, c))
    for i in (9, 10, 11):
        lt, cache = tt.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                   cfg_t, cache)
        lj, jc = step(jp, jnp.asarray(toks[:, i:i + 1], jnp.int32), jc)
        _close(lt, tt.logits_fn(tp, h_full[:, i:i + 1], cfg_t),
               msg=f"decode at {i} vs full forward")
        _close(lt, lj, msg=f"decode at {i} vs JAX")


def test_bf16_activations_keep_an_fp32_state():
    """At the full model's bf16 activations the state stays fp32, the WKV
    output comes back in bf16, and the forward stays within bf16 reach of
    the fp32 one."""
    cfg = dataclasses.replace(tget(ARCH).reduced(), act_dtype=torch.bfloat16)
    tp = _params()[1]
    toks = torch.from_numpy(_tokens(3, (2, 6)))
    cache = tt.init_cache(cfg, 2, 16, torch.bfloat16, device="cpu")
    h, _, _ = tt.forward(tp, toks, cfg, cache=cache)
    assert h.dtype == torch.bfloat16
    for t in cache["segments"]["seg0"]["l0"].values():
        assert t.dtype == torch.float32 and bool(t.abs().sum() > 0)
    h32, _, _ = tt.forward(tp, toks, tget(ARCH).reduced())
    _close(h, h32.numpy(), rel=0.1)


def _jax_engine(packed, prompts, n_new):
    jeng = je.ServeEngine(jget(ARCH).reduced(), _params(packed)[0],
                          je.EngineConfig(max_batch=2, max_prompt=16,
                                          max_len=32))
    for i, p in enumerate(prompts):
        jeng.submit(je.Request(uid=i, prompt=p, max_new_tokens=n_new))
    return {r.uid: r.output for r in jeng.run()}


def _serve(eng, prompts, n_new):
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=n_new))
    return {r.uid: r.output for r in eng.run()}


def _engine(packed=False):
    return ServeEngine(tget(ARCH).reduced(), _params(packed)[1],
                       EngineConfig(max_batch=2, max_prompt=16, max_len=32))


@pytest.mark.parametrize("packed", [False, True])
def test_engine_matches_jax_engine(packed):
    want = _jax_engine(packed, [PROMPT], 6)[0]
    assert _serve(_engine(packed), [PROMPT], 6)[0] == want
    assert len(set(want)) > 1   # the untied head does not echo one token


def _naive_greedy(prompt, n_new):
    """Reference: rerun the port's full forward on the growing sequence."""
    cfg, tp = tget(ARCH).reduced(), _params()[1]
    toks = list(prompt)
    for _ in range(n_new):
        h, _, _ = tt.forward(tp, torch.tensor([toks]), cfg)
        toks.append(int(tt.logits_fn(tp, h[:, -1:], cfg)[0, 0].argmax()))
    return toks[len(prompt):]


def test_engine_continuous_batching_refill():
    """More requests than slots (5 prompts of 3 to 7 tokens on 2 slots, as
    `tests/test_serving.py` runs rwkv6): slots are refilled, every output
    equals JAX's engine and the port's solo full-forward reference, so no
    recurrent state leaks between requests or slots."""
    prompts = [np.arange(1, 4 + i, dtype=np.int32) for i in range(5)]
    eng = _engine()
    done = _serve(eng, prompts, 4)
    want = _jax_engine(False, prompts, 4)
    assert len(done) == 5 and eng.stats["prefill_calls"] == 5
    for i, p in enumerate(prompts):
        assert done[i] == want[i], f"request {i} vs JAX"
        assert done[i] == _naive_greedy(p, 4), f"request {i} vs solo"


def test_engine_prefills_recurrent_archs_at_exact_length(monkeypatch):
    """A 5-token prompt runs as 5 tokens for rwkv6 (a pad token would enter
    the state) and as an 8-token bucket for an attention-only arch."""
    lengths = []
    fwd = tt.forward

    def spy(params, inputs, cfg, **kw):
        lengths.append(inputs.shape[1])
        return fwd(params, inputs, cfg, **kw)

    monkeypatch.setattr(teng.transformer, "forward", spy)
    _engine()._prefill(0, PROMPT)
    gcfg = tget("gemma-2b").reduced()
    ServeEngine(gcfg, tt.init_params(gcfg, 0, device="cpu"),
                EngineConfig(max_batch=1, max_prompt=16,
                             max_len=32))._prefill(0, PROMPT)
    assert lengths == [5, 8]


def test_engine_runs_dense_layers_and_wkv_through_ops(monkeypatch):
    """Packed weights: 8 dense layers and one WKV call per layer per
    forward go through `ops.log_matmul` and `ops.wkv6` (what the chip run
    counts as kernel launches: 192 and 24 at full depth)."""
    calls = {"log_matmul": 0, "wkv6": 0, "attention": 0}
    for op in calls:
        orig = getattr(tops, op)

        def counted(*a, _orig=orig, _op=op, **kw):
            calls[_op] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tops, op, counted)
    eng = _engine(packed=True)
    _serve(eng, [PROMPT, PROMPT[:3]], 4)
    fwd = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    n_layers = tget(ARCH).reduced().n_layers
    assert calls == {"log_matmul": 8 * n_layers * fwd,
                     "wkv6": n_layers * fwd, "attention": 0}


def test_serve_main_runs_rwkv(capsys):
    done = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--requests", "3", "--max-new", "4"])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_bf16_gap_is_the_models_not_the_ports():
    """Both packages' reduced rwkv6-1.6b on the same weights and tokens, in
    bf16 and in fp32 activations: the logits of each package move between
    its fp32 and its bf16 forward, and the port's move is no larger than
    JAX's (root mean square over 8 sequences of 12 tokens: 0.0284 against
    0.0315 on a CPU; the largest moves 0.283 and 0.345 on max|l| 4.49).
    The tolerance is 1.25 x JAX's: the packages round to bf16 in
    different places, so their gaps are alike in size, not equal.
    In fp32 the two agree within 1e-4, so the bf16 gap is a property of
    the model's bf16 activations (a bf16 rounding grows through the
    recurrent stack), not a fault of the port."""
    cfg_j, cfg_t = _cfgs()
    jp, tp = _params()
    toks = _tokens(4, (8, 12))
    logits = {}
    for name, jd, td in (("fp32", jnp.float32, torch.float32),
                         ("bf16", jnp.bfloat16, torch.bfloat16)):
        cj = dataclasses.replace(cfg_j, act_dtype=jd)
        ct = dataclasses.replace(cfg_t, act_dtype=td)
        hj, _, _ = jax.jit(lambda p, t, c=cj: jt.forward(p, t, c))(
            jp, jnp.asarray(toks, jnp.int32))
        ht, _, _ = tt.forward(tp, torch.from_numpy(toks), ct)
        logits[name] = (np.asarray(jt.logits_fn(jp, hj, cj), np.float32),
                        tt.logits_fn(tp, ht, ct).float().numpy())
    _close(torch.from_numpy(logits["fp32"][1]), logits["fp32"][0])
    gap_j, gap_t = (float(np.sqrt(np.mean(
        (logits["bf16"][i] - logits["fp32"][i]) ** 2))) for i in (0, 1))
    assert gap_j > 1e-3  # bf16 activations move JAX's logits too
    assert gap_t <= 1.25 * gap_j, (gap_t, gap_j)
