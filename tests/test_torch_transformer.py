"""The port's LM configs, layers, weight packing and transformer
(`repro_torch.configs`, `repro_torch.models`, `repro_torch.serving.quantize`)
against the JAX package's, on the same weights (a JAX parameter tree
bridged with `transformer.params_from_numpy`).

The configs are `reduced()` (fp32 activations): gemma-2b (MQA, GeGLU, tied
embeddings with `embed_scale`), gemma3-1b (local ring layers), qwen1.5-4b
(MHA with QKV bias, an untied head), recurrentgemma-2b (RG-LRU layers and
local attention, pattern rec, rec, local) and granite-moe-1b-a400m (GQA
with top-k MoE FFNs).  Hidden states agree within 1e-4·(max|h|+1), with fp
weights and with weights packed by `quantize_params`, whose codes and scales
equal JAX's byte for byte (the Griffin and expert weights stay fp32, as in
JAX).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import REGISTRY as JREGISTRY  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import quantize as jq  # noqa: E402
from repro_torch.configs.registry import REGISTRY as TREGISTRY  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core.logquant import QuantizedTensor  # noqa: E402
from repro_torch.kernels.ops import resolve_impl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import quantize as tq  # noqa: E402

ARCHS = ["gemma-2b", "gemma3-1b", "qwen1.5-4b", "recurrentgemma-2b",
         "granite-moe-1b-a400m"]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _close(got, want, rel=1e-5, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want,
                               rtol=rel, atol=rel * (np.abs(want).max() + 1),
                               err_msg=msg)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0):
    """A reduced config's JAX params and the same weights in the port."""
    cfg = jget(arch).reduced()
    jp = jt.init_params(cfg, jax.random.PRNGKey(seed))
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def test_configs_match_jax():
    """Every arch is ported as data: the same names and the same values in
    every field the port keeps, full size and reduced.  The attention
    dispatch defaults to "auto", which follows the tensors' device and so
    resolves to JAX's default, "blockwise", on the CPU."""
    assert list(TREGISTRY) == list(JREGISTRY)
    for name, tc in TREGISTRY.items():
        for jc, rc in ((JREGISTRY[name], tc),
                       (JREGISTRY[name].reduced(), tc.reduced())):
            for f in dataclasses.fields(rc):
                jv, tv = getattr(jc, f.name), getattr(rc, f.name)
                if f.name == "attn_impl":
                    assert tv == "auto", name
                    tv = resolve_impl("attention", tv, "cpu")
                assert DTYPES.get(jv, jv) == tv, (name, f.name)
            assert (rc.segments, rc.q_dim, rc.kv_dim, rc.param_count()) == \
                (jc.segments, jc.q_dim, jc.kv_dim, jc.param_count())
    assert tget("gemma-2b").act_dtype is torch.bfloat16
    assert tget("gemma-2b").reduced().act_dtype is torch.float32
    with pytest.raises(KeyError, match="unknown arch"):
        tget("nope")


def test_default_dispatch_follows_device():
    """With a config's defaults, a forward on the card reaches both CUDA
    kernels and a forward on the CPU their plain versions."""
    cfg = tget("gemma-2b")
    for dev, want in (("cuda", "cuda"), ("cpu", "blockwise")):
        assert resolve_impl("attention", cfg.attn_impl, dev) == want
        assert resolve_impl("log_matmul", "auto", dev) == want


def test_norms_match_jax():
    x = _x(0, 2, 5, 64) * 3 + 1
    scale, bias = _x(1, 64), _x(2, 64)
    p_r = {"scale": scale}
    p_l = {"scale": scale, "bias": bias}
    _close(tl.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jl.rmsnorm(p_r, jnp.asarray(x)))
    _close(tl.layernorm({k: torch.from_numpy(v) for k, v in p_l.items()},
                        torch.from_numpy(x)),
           jl.layernorm(p_l, jnp.asarray(x)))


@pytest.mark.parametrize("mrope,pos3", [(None, False), ((2, 3, 3), False),
                                        ((2, 3, 3), True)])
def test_apply_rope_matches_jax(mrope, pos3):
    x = _x(3, 2, 7, 4, 16)
    rng = np.random.default_rng(4)
    shape = (3, 2, 7) if pos3 else (2, 7)
    pos = rng.integers(0, 500, size=shape)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, mrope)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0,
                        mrope)
    _close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_ffn_matches_jax(kind):
    cfg_j = dataclasses.replace(jget("gemma-2b").reduced(), ffn=kind)
    cfg_t = dataclasses.replace(tget("gemma-2b").reduced(), ffn=kind)
    p = {"w1": _x(5, 64, 128) / 8, "w3": _x(6, 64, 128) / 8,
         "w2": _x(7, 128, 64) / 11}
    x = _x(8, 2, 3, 64)
    want = jl.ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  cfg_j)
    got = tl.ffn({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), cfg_t)
    _close(got, want)


def test_embed_scale_is_rounded_to_the_activation_dtype():
    cfg_j = dataclasses.replace(jget("gemma-2b").reduced(),
                                act_dtype=jnp.bfloat16)
    cfg_t = dataclasses.replace(tget("gemma-2b").reduced(),
                                act_dtype=torch.bfloat16)
    table = _x(9, 512, 64)
    toks = np.array([[3, 500, 7]])
    want = jl.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), cfg_j)
    got = tl.embed({"table": torch.from_numpy(table)}, torch.from_numpy(toks),
                   cfg_t)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's stacked tree has JAX's keys and shapes leaf by leaf, so
    `params_from_numpy` maps one onto the other."""
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    shapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda k: jt.init_params(cfg_j, k), jax.random.PRNGKey(0)))

    def tshapes(tree):
        if isinstance(tree, dict):
            return {k: tshapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert tshapes(tt.init_params(cfg_t, 0, device="cpu")) == shapes


def _packed_per_layer(cfg, kind) -> int:
    """Leaves `quantize_params` packs in one layer: the attention
    projections and a dense FFN's matrices; the RG-LRU's and the experts'
    weights and the router stay fp."""
    ffn = 0 if cfg.is_moe else 3 if cfg.ffn in ("swiglu", "geglu") else 2
    return ffn + (4 if kind in ("attn", "local") else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_matches_jax(arch):
    """Codes and scales byte-equal to JAX's, stacked [n_rep, K, N] leaves
    with per-(rep, channel) scales included; every leaf JAX leaves fp
    (Griffin's ``w_*``, ``conv_*`` and ``lam``; ``router`` and
    ``moe_w*``) stays fp32 here."""
    jp, tp = _params(arch)
    jpk, tpk = jq.quantize_params(jp), tq.quantize_params(tp)
    jleaves = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_leaves_with_path(
                   jpk, is_leaf=lambda x: hasattr(x, "packed"))}
    n = 0

    def walk(tree, path):
        nonlocal n
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + f"[{k!r}]")
            return
        want = jleaves[path]
        if isinstance(tree, QuantizedTensor):
            n += 1
            assert tree.shape == tuple(want.shape)
            np.testing.assert_array_equal(tree.scale.numpy(),
                                          np.asarray(want.scale))
            np.testing.assert_array_equal(tree.packed.numpy(),
                                          np.asarray(want.packed))
        else:
            assert not hasattr(want, "packed"), path
            assert tree.dtype == torch.float32, path
    walk(tpk, "")
    cfg = jget(arch).reduced()
    assert n == sum(_packed_per_layer(cfg, kind)
                    for unit, _ in cfg.segments for kind in unit)
    assert n > 0


def test_quant_leaves_are_jaxs_so_griffin_and_experts_stay_fp():
    """The port packs exactly JAX's leaf names: none of the RG-LRU block's
    leaves and none of the MoE router's or experts' are among them."""
    assert tq.QUANT_LEAVES == jq.QUANT_LEAVES
    griffin = {"w_gate", "w_x", "conv_w", "conv_b", "w_r", "w_i", "lam",
               "w_out"}
    moe = {"router", "moe_w1", "moe_w2", "moe_w3"}
    assert not (griffin | moe) & tq.QUANT_LEAVES


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, packed):
    jp, tp = _params(arch)
    if packed:
        jp, tp = jq.quantize_params(jp), tq.quantize_params(tp)
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    toks = np.random.default_rng(1).integers(1, 512, size=(2, 12))
    hj, _, aj = jax.jit(lambda p, t: jt.forward(p, t, cfg_j))(
        jp, jnp.asarray(toks, jnp.int32))
    for impl in ("cuda", "blockwise"):
        ht, cache, aux = tt.forward(tp, torch.from_numpy(toks),
                                    dataclasses.replace(cfg_t,
                                                        attn_impl=impl))
        assert cache is None and ht.shape == (2, 12, 64)
        _close(ht, hj, rel=1e-4, msg=impl)
        # the summed MoE router loss (0 without MoE, in both)
        _close(torch.as_tensor(aux), aj, rel=1e-5, msg=f"aux, {impl}")
        assert (float(aux) > 0) == cfg_t.is_moe
    lj = jt.logits_fn(jp, hj, cfg_j)
    _close(tt.logits_fn(tp, ht, cfg_t), lj, rel=1e-4)


def test_prefill_then_decode_matches_jax():
    """The cache path: prefill 9 tokens, then decode 2 at per-row
    positions, against JAX's prefill/decode_step (gemma3-1b: a local ring
    layer and a global one)."""
    arch = "gemma3-1b"
    jp, tp = _params(arch)
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    toks = np.random.default_rng(2).integers(1, 512, size=(1, 11))
    jc = jt.init_cache(cfg_j, 1, 24, jnp.float32)
    tc = tt.init_cache(cfg_t, 1, 24, torch.float32, device="cpu")
    hj, jc = jax.jit(lambda p, t, c: jt.prefill(p, t, cfg_j, c))(
        jp, jnp.asarray(toks[:, :9], jnp.int32), jc)
    ht, tc = tt.prefill(tp, torch.from_numpy(toks[:, :9]), cfg_t, tc)
    _close(ht, hj, rel=1e-4)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, t, cfg_j, c))
    for i in (9, 10):
        lj, jc = step(jp, jnp.asarray(toks[:, i:i + 1], jnp.int32), jc)
        tc["index"] = torch.tensor([i])
        lt, tc = tt.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                cfg_t, tc)
        _close(lt, lj, rel=1e-4, msg=f"decode at {i}")


@pytest.mark.parametrize("T", [6, 8])
def test_ring_prefill_longer_than_the_window(T):
    """A prompt longer than a local layer's ring, then one decode step,
    equals JAX's full forward over the same tokens.  (JAX's own prefill
    writes the last S tokens at slots 0..S-1, so its decode after a
    6-token prompt into a 4-slot ring misses this; ROADMAP.md C.)"""
    cfg_j = dataclasses.replace(jget("gemma3-1b").reduced(), attn_window=4)
    cfg_t = dataclasses.replace(tget("gemma3-1b").reduced(), attn_window=4)
    jp, tp = _params("gemma3-1b")
    toks = np.random.default_rng(0).integers(1, 512, size=(1, T + 1))
    hj, _, _ = jax.jit(lambda p, t: jt.forward(p, t, cfg_j))(
        jp, jnp.asarray(toks, jnp.int32))
    want = jt.logits_fn(jp, hj[:, -1:], cfg_j)
    cache = tt.init_cache(cfg_t, 1, 16, torch.float32, device="cpu")
    _, cache = tt.prefill(tp, torch.from_numpy(toks[:, :T]), cfg_t, cache)
    got, _ = tt.decode_step(tp, torch.from_numpy(toks[:, T:]), cfg_t, cache)
    _close(got, want, rel=1e-4)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b",
                                  "granite-moe-1b-a400m"])
def test_prefill_then_decode_of_recurrent_and_moe_archs(arch):
    """The cache path of the Griffin and MoE archs: prefill 9 tokens, then
    decode 3 at per-row positions; every step against JAX's
    prefill/decode_step and against JAX's full forward at that position
    (recurrentgemma: RG-LRU state and conv window, and a local ring that
    holds the prompt)."""
    jp, tp = _params(arch)
    cfg_j, cfg_t = jget(arch).reduced(), tget(arch).reduced()
    toks = np.random.default_rng(5).integers(1, 512, size=(1, 12))
    hf, _, _ = jax.jit(lambda p, t: jt.forward(p, t, cfg_j))(
        jp, jnp.asarray(toks, jnp.int32))
    jc = jt.init_cache(cfg_j, 1, 24, jnp.float32)
    tc = tt.init_cache(cfg_t, 1, 24, torch.float32, device="cpu")
    hj, jc = jax.jit(lambda p, t, c: jt.prefill(p, t, cfg_j, c))(
        jp, jnp.asarray(toks[:, :9], jnp.int32), jc)
    ht, tc = tt.prefill(tp, torch.from_numpy(toks[:, :9]), cfg_t, tc)
    _close(ht, hj, rel=1e-4)
    _close(ht, hf[:, 8:9], rel=1e-4)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, t, cfg_j, c))
    for i in (9, 10, 11):
        lj, jc = step(jp, jnp.asarray(toks[:, i:i + 1], jnp.int32), jc)
        tc["index"] = torch.tensor([i])
        lt, tc = tt.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                cfg_t, tc)
        _close(lt, lj, rel=1e-4, msg=f"decode at {i}")
        _close(lt, jt.logits_fn(jp, hf[:, i:i + 1], cfg_j), rel=1e-4,
               msg=f"decode at {i} vs the full forward")


def test_recurrentgemma_ring_prefill_longer_than_the_window():
    """recurrentgemma prefills at exact length, so a prompt can outgrow a
    local layer's ring (C.1): 6 tokens into a 4-slot ring, then one decode
    step, equal JAX's full forward over the same 7 tokens (not JAX's own
    prefill, which misplaces the ring)."""
    arch = "recurrentgemma-2b"
    cfg_j = dataclasses.replace(jget(arch).reduced(), attn_window=4)
    cfg_t = dataclasses.replace(tget(arch).reduced(), attn_window=4)
    jp, tp = _params(arch)
    toks = np.random.default_rng(6).integers(1, 512, size=(1, 7))
    hj, _, _ = jax.jit(lambda p, t: jt.forward(p, t, cfg_j))(
        jp, jnp.asarray(toks, jnp.int32))
    cache = tt.init_cache(cfg_t, 1, 16, torch.float32, device="cpu")
    assert cache["segments"]["seg0"]["l2"]["k"].shape[2] == 4
    _, cache = tt.prefill(tp, torch.from_numpy(toks[:, :6]), cfg_t, cache)
    got, _ = tt.decode_step(tp, torch.from_numpy(toks[:, 6:]), cfg_t, cache)
    _close(got, jt.logits_fn(jp, hj[:, -1:], cfg_j), rel=1e-4)


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-2b"])
def test_unported_archs_raise_naming_the_roadmap(arch):
    """The embedding-input archs (ROADMAP.md queue A, item 14) are ported
    now: they build and run a forward on [B, T, D] embeddings, and only
    the serving engine refuses them, as the JAX engine does."""
    from repro_torch.serving.engine import ServeEngine
    cfg = tget(arch).reduced()
    params = tt.init_params(cfg, 0, device="cpu")
    embeds = torch.from_numpy(_x(7, 2, 5, cfg.d_model))
    h, _, _ = tt.forward(params, embeds, cfg)
    assert h.shape == (2, 5, cfg.d_model) and torch.isfinite(h).all()
    with pytest.raises(ValueError, match="engine serves token archs"):
        ServeEngine(cfg, params)
