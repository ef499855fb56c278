"""The port's training stack (`repro_torch.data`, `repro_torch.training`)
against the JAX package's, on the same inputs (numpy, from seeds):

  * the loader's batches byte for byte (synthetic and memmap, one and two
    hosts);
  * `lr_at` for the three schedules, global-norm clipping, and AdamW and
    SGD updates from the same gradients and state (keys, dtypes, values
    within 1e-6 relative);
  * the compressor's log codes byte for byte and its error state, with a
    leaf under ``min_size`` left uncompressed with a 0-d error;
  * one `make_train_step` on reduced gemma-2b (SGD with momentum, plain
    and with two microbatches), params within 1e-5·(max|p|+1): its update
    is linear in the gradient.  An AdamW step is not compared end to end:
    its first step is about lr·sign(g), which moves by 2·lr wherever two
    correct gradients differ in the sign of a near-zero element; the
    optimizer tests hold AdamW on identical gradients instead;
  * `input_specs` for every arch and shape;
  * mirrors of `tests/test_training.py` on the port alone (microbatches
    equal the full batch, loss falls with and without compression, hooks
    fire), and remat giving the gradients of the plain forward;
  * the grad guard of the four kernel wrappers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import REGISTRY as JREGISTRY  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.training import grad_compress as jgc  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.registry import REGISTRY as TREGISTRY  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.training import grad_compress as tgc  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

DTYPES = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          np.int32: torch.int32}


def _np(tree):
    """A tree of tensors or jax arrays → the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().numpy()
    return np.asarray(tree)


def _assert_tree_close(got, want, rel, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], rel, f"{path}/{k}")
        return
    g, w = _np(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, path
    np.testing.assert_allclose(g, w, rtol=rel,
                               atol=rel * (np.abs(w).max() + 1),
                               err_msg=path)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("n_hosts", [1, 2])
@pytest.mark.parametrize("source", ["synthetic", "memmap"])
def test_loader_batches_equal_jax_byte_for_byte(source, n_hosts, tmp_path):
    kw = dict(seq_len=16, global_batch=4, vocab=100, seed=7, source=source,
              n_hosts=n_hosts)
    if source == "memmap":
        path = tmp_path / "toks.bin"
        (np.arange(17 * 9, dtype=np.int32) % 50).tofile(path)
        kw["path"] = str(path)
    for host in range(n_hosts):
        jl = jpipe.ShardedLoader(jpipe.DataConfig(**kw, host_id=host))
        tl = tpipe.ShardedLoader(tpipe.DataConfig(**kw, host_id=host))
        for step in (0, 3):
            jb, tb = jl.batch(step), tl.batch(step)
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                assert jb[k].tobytes() == tb[k].tobytes(), (k, step, host)
    cfg = tget("gemma-2b").reduced()
    shape = {"seq_len": 8, "global_batch": 2}
    assert tpipe.make_loader(cfg, shape).batch(1)["tokens"].tobytes() == \
        jpipe.make_loader(jget("gemma-2b").reduced(), shape).batch(1)[
            "tokens"].tobytes()


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1,
              schedule=schedule)
    jc, tc = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    got = [float(topt.lr_at(tc, torch.tensor(s, dtype=torch.int32)))
           for s in range(120)]
    want = [float(jopt.lr_at(jc, s)) for s in range(120)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert topt.lr_at(tc, 5).dtype == torch.float32


def _grads_and_params(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "nested": {"b": (5,), "s": (3, 2, 4)}}

    def draw(tree, scale):
        return {k: draw(v, scale) if isinstance(v, dict)
                else (rng.normal(size=v) * scale).astype(np.float32)
                for k, v in tree.items()}
    return draw(shapes, 1.0), draw(shapes, 0.3), draw(shapes, 0.2)


def test_clip_by_global_norm_matches_jax():
    g, _, _ = _grads_and_params()
    for max_norm in (1.0, 1e3):
        jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                          max_norm)
        tc, tn = topt.clip_by_global_norm(
            topt.tree_map(torch.from_numpy, g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(tc, jc, 1e-6)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_updates_match_jax(name):
    """Three updates from the same gradients: params and state (keys,
    dtypes, ``count``) equal JAX's within 1e-6 relative."""
    cfg_kw = dict(name=name, lr=0.05, warmup_steps=2, total_steps=10)
    jinit, jupd = jopt.make_optimizer(jopt.OptimizerConfig(**cfg_kw))
    tinit, tupd = topt.make_optimizer(topt.OptimizerConfig(**cfg_kw))
    _, p0, _ = _grads_and_params()
    jp = jax.tree.map(jnp.asarray, p0)
    tp = topt.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    js, ts = jinit(jp), tinit(tp)
    for step in range(3):
        g, _, _ = _grads_and_params(seed=step + 1)
        jp, js = jupd(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = tupd(topt.tree_map(torch.from_numpy, g), ts, tp)
        _assert_tree_close(tp, jp, 1e-6)
        _assert_tree_close(ts, js, 1e-6)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3
    with pytest.raises(ValueError):
        topt.make_optimizer(topt.OptimizerConfig(name="lion"))


# ---------------------------------------------------------------- compression


def test_compressor_codes_and_error_equal_jax():
    """Two EF rounds: the codes of ``grad + error`` equal JAX's byte for
    byte, the decoded gradients and the error state agree within 2e-6; a
    leaf under ``min_size`` passes through with a 0-d fp32 error."""
    from repro.core.logquant import log_quantize as jlq
    from repro_torch.core.logquant import log_quantize as tlq
    rng = np.random.default_rng(3)
    grads = {"big": (rng.normal(size=(48, 40)) * 1e-2).astype(np.float32),
             "norm": rng.normal(size=(40,)).astype(np.float32)}
    jcfg, tcfg = jgc.CompressorConfig(), tgc.CompressorConfig()
    js = jgc.compressor_init(jax.tree.map(jnp.asarray, grads), jcfg)
    ts = tgc.compressor_init(topt.tree_map(torch.from_numpy, grads), tcfg)
    assert ts["error"]["norm"].shape == () and \
        ts["error"]["norm"].dtype == torch.float32
    for _ in range(2):
        acc = grads["big"] + np.asarray(js["error"]["big"])
        jcode, jscale = jlq(jnp.asarray(acc))
        tcode, tscale = tlq(torch.from_numpy(acc))
        assert np.asarray(jcode).tobytes() == tcode.numpy().tobytes()
        np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
        jq, js = jgc.log_compress_gradients(
            jax.tree.map(jnp.asarray, grads), js, jcfg)
        tq, ts = tgc.log_compress_gradients(
            topt.tree_map(torch.from_numpy, grads), ts, tcfg)
        _assert_tree_close(tq, jq, 2e-6)
        _assert_tree_close(ts, js, 2e-6)
    np.testing.assert_array_equal(tq["norm"].numpy(), grads["norm"])
    assert tgc.wire_bytes_fraction() == jgc.wire_bytes_fraction()
    # the decode agrees within 2e-6: XLA's CPU exp2 is up to 1.01e-6
    # relative off the exact power of two (ROADMAP.md, section C)
    g = torch.from_numpy(grads["big"])
    np.testing.assert_allclose(
        tgc.compress_decompress(g).numpy(),
        np.asarray(jgc.compress_decompress(jnp.asarray(grads["big"]))),
        rtol=2e-6)


# ---------------------------------------------------------------- train step


def _gemma(**over):
    kw = dict(n_layers=2, vocab=128, d_model=32, d_ff=64, head_dim=8)
    kw.update(over)
    cj = jget("gemma-2b").reduced(**kw)
    ct = dataclasses.replace(tget("gemma-2b").reduced(**kw),
                             attn_impl="blockwise")
    return cj, ct


def _tiny_setup(microbatches=1, grad_compress=False, name="adamw"):
    """The port's counterpart of `tests/test_training.py::_tiny_setup`,
    with JAX's initial weights."""
    cj, ct = _gemma()
    jp = jt.init_params(cj, jax.random.PRNGKey(0))
    loss_fn = lambda p, b: tt.lm_loss(p, b, ct, xent_chunk=16)  # noqa: E731
    tcfg = ttl.TrainConfig(
        opt=topt.OptimizerConfig(name=name, lr=1e-2, warmup_steps=2,
                                 total_steps=50, schedule="constant"),
        microbatches=microbatches, grad_compress=grad_compress, log_every=1)
    ld = tpipe.ShardedLoader(tpipe.DataConfig(seq_len=16, global_batch=4,
                                              vocab=128, seed=0))
    fresh = lambda: tt.params_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, jp), device="cpu")
    return jp, fresh, loss_fn, tcfg, ld


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    cj, _ = _gemma()
    jp, fresh, loss_fn, tcfg, ld = _tiny_setup(microbatches, name="sgd")
    jcfg = jtl.TrainConfig(
        opt=jopt.OptimizerConfig(**dataclasses.asdict(tcfg.opt)),
        microbatches=microbatches, log_every=1)
    jloss = lambda p, b: jt.lm_loss(p, b, cj, xent_chunk=16)  # noqa: E731
    batch = ld.batch(0)
    js, jm = jax.jit(jtl.make_train_step(jloss, jcfg))(
        jtl.init_train_state(jp, jcfg), batch)
    ts, tm = ttl.make_train_step(loss_fn, tcfg)(
        ttl.init_train_state(fresh(), tcfg), batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    assert set(tm) == set(jm)
    _assert_tree_close(ts["params"], js["params"], 1e-5)
    _assert_tree_close(ts["opt"], js["opt"], 1e-5)
    assert int(ts["step"]) == 1 and ts["step"].dtype == torch.int32


def test_train_state_keys_dtypes_and_numpy_round_trip():
    """`init_train_state` builds JAX's tree (same keys, shapes, dtypes), and
    `train_state_from_numpy` / `train_state_to_numpy` carry a JAX state
    across and back unchanged."""
    cj, _ = _gemma()
    jp, fresh, _, tcfg, _ = _tiny_setup(grad_compress=True)
    jcfg = jtl.TrainConfig(grad_compress=True)
    js = jtl.init_train_state(jp, jcfg)
    ts = ttl.init_train_state(fresh(), dataclasses.replace(
        tcfg, grad_compress=True))
    sig = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: (tuple(a.shape), str(np.asarray(a).dtype)), _np(tree))
    assert sig(ts) == sig(js)
    back = ttl.train_state_from_numpy(jax.tree.map(np.asarray, js),
                                      device="cpu")
    assert sig(back) == sig(js)
    out = ttl.train_state_to_numpy(back)
    jax.tree.map(np.testing.assert_array_equal, out,
                 jax.tree.map(np.asarray, js))


def test_grad_accumulation_matches_full_batch():
    """microbatches=2 must produce the same update as one big batch."""
    _, fresh, loss_fn, tcfg, ld = _tiny_setup()
    batch = ld.batch(0)
    s1, _ = ttl.make_train_step(loss_fn, tcfg)(
        ttl.init_train_state(fresh(), tcfg), batch)
    tcfg2 = ttl.TrainConfig(opt=tcfg.opt, microbatches=2, log_every=1)
    s2, _ = ttl.make_train_step(loss_fn, tcfg2)(
        ttl.init_train_state(fresh(), tcfg2), batch)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=2e-4, atol=2e-5), _np(s1["params"]), _np(s2["params"]))


@pytest.mark.parametrize("grad_compress", [False, True])
def test_train_loop_loss_decreases(grad_compress):
    """`test_train_loop_loss_decreases` and
    `test_train_loop_with_compression_still_learns` of the JAX tests."""
    _, fresh, loss_fn, tcfg, ld = _tiny_setup(grad_compress=grad_compress)
    state, hist = ttl.train(loss_fn, fresh(), ld, tcfg, num_steps=20)
    assert int(state["step"]) == 20
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert np.isfinite(hist[-1]["loss"])


def test_hooks_fire_and_the_step_event_feeds_every_consumer():
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.runtime.monitor import HeartbeatMonitor
    _, fresh, loss_fn, tcfg, ld = _tiny_setup()
    seen = []
    reg = obs_metrics.MetricsRegistry()
    mon = HeartbeatMonitor(["host0"])
    obs_trace.clear()
    obs_trace.set_enabled(True)
    try:
        ttl.train(loss_fn, fresh(), ld, tcfg, num_steps=5, metrics=reg,
                  monitor=mon, hooks=[lambda step, st, m: seen.append(step)])
    finally:
        obs_trace.set_enabled(None)
    assert seen == [0, 1, 2, 3, 4]
    hist = reg.snapshot()["histograms"]["train_step_s"]
    spans = [e for e in obs_trace.events() if e[1] == "train_step"]
    assert hist["count"] == len(spans) == 5
    assert list(mon._times["host0"]) == pytest.approx(
        [dur / 1e9 for _, _, _, dur, _, _ in spans])
    obs_trace.clear()


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b"])
def test_remat_gives_the_plain_gradients(arch):
    cfg = dataclasses.replace(tget(arch).reduced(), attn_impl="blockwise")
    b = {k: torch.from_numpy(v) for k, v in tpipe.ShardedLoader(
        tpipe.DataConfig(seq_len=8, global_batch=2, vocab=cfg.vocab)
    ).batch(0).items()}
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        p = tt.init_params(c, 0, device="cpu")
        leaves = topt.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        grads.append(torch.autograd.grad(tt.lm_loss(p, b, c)[0], leaves))
    for a, g in zip(*grads):
        torch.testing.assert_close(g, a, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- configs


def test_input_specs_match_jax():
    """Every arch × shape: the same step kind, names, shapes and dtypes;
    the port's stand-ins live on the meta device.  `remat`, `SHAPES`,
    `SUBQUADRATIC` and `cell_is_runnable` equal JAX's."""
    assert tbase.SHAPES == jbase.SHAPES
    assert tbase.SUBQUADRATIC == jbase.SUBQUADRATIC
    for name in TREGISTRY:
        for shape in tbase.SHAPES:
            assert tbase.cell_is_runnable(name, shape) == \
                jbase.cell_is_runnable(name, shape)
            jstep, jspecs = jbase.input_specs(JREGISTRY[name], shape)
            tstep, tspecs = tbase.input_specs(TREGISTRY[name], shape)
            assert tstep == jstep and list(tspecs) == list(jspecs)
            for k, spec in jspecs.items():
                t = tspecs[k]
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(spec.shape), (name, shape, k)
                assert t.dtype == DTYPES[np.dtype(spec.dtype).type], \
                    (name, shape, k)
        assert TREGISTRY[name].remat and not TREGISTRY[name].reduced().remat


# ---------------------------------------------------------------- grad guard


def _wrapper_calls():
    from repro_torch.core.logquant import quantize_tensor
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    from repro_torch.kernels.log_matmul import log_matmul_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    qm, qc = quantize_tensor(rn(8, 4)), quantize_tensor(rn(3, 3, 2, 4))
    return {
        "log_matmul_cuda": lambda x: log_matmul_cuda(
            x, qm.packed, qm.scale), "x_mm": (2, 8),
        "log_conv2d_fused": lambda x: log_conv2d_fused(
            x, qc.packed, qc.scale), "x_conv": (1, 5, 5, 2),
        "flash_attention_cuda": lambda x: flash_attention_cuda(
            x, x[:, :, :1], x[:, :, :1]), "x_attn": (1, 4, 2, 8),
        "wkv6_cuda": lambda x: wkv6_cuda(
            x, x, x, -torch.ones_like(x), torch.zeros(2, 4)),
        "x_wkv": (1, 3, 2, 4)}


@pytest.mark.parametrize("name,shape", [
    ("log_matmul_cuda", "x_mm"), ("log_conv2d_fused", "x_conv"),
    ("flash_attention_cuda", "x_attn"), ("wkv6_cuda", "x_wkv")])
def test_kernel_wrappers_refuse_inputs_that_require_grad(name, shape):
    """A kernel's output carries no grad_fn, so each wrapper raises on an
    input that requires grad while grad mode is on (on every device; here
    the CPU's plain path), and runs under no_grad or on a plain input."""
    calls = _wrapper_calls()
    x = torch.randn(*calls[shape])
    calls[name](x)
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        calls[name](xg)
    with torch.no_grad():
        calls[name](xg)
