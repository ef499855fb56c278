"""The port's checkpoints and fleet-health monitor
(`repro_torch.runtime.checkpoint`, `repro_torch.runtime.monitor`) against
the JAX package's `repro.runtime`:

  * mirrors of `tests/test_runtime.py` (round trip with a bf16 leaf, meta
    template, rotation, async save, atomicity, bit-exact resume) and of
    the monitor cases of `tests/test_runtime.py` and `tests/test_monitor.py`,
    run on both packages as parametrised cases;
  * a checkpoint written by either package (a bf16 leaf and a train state
    included) restoring in the other, bit for bit;
  * JAX training 3 steps, the port restoring its checkpoint and training 3
    more, against JAX's 6 steps (SGD with momentum, whose update is linear
    in the gradient; params within 1e-5·(max|p|+1));
  * ``shardings=`` raising, naming the roadmap item that holds it.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # test workers share the cores (ROADMAP C)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import ShardedLoader as JLoader  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.runtime import checkpoint as jck  # noqa: E402
from repro.runtime import monitor as jmon  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import DataConfig, ShardedLoader  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.runtime import checkpoint as tck  # noqa: E402
from repro_torch.runtime import monitor as tmon  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402


def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "nested": {"b": torch.ones((5,),
                                                  dtype=torch.bfloat16)}},
            "step": torch.tensor(7, dtype=torch.int32)}


def _jstate():
    return {"params": {"w": jnp.arange(12.0).reshape(3, 4),
                       "nested": {"b": jnp.ones((5,), jnp.bfloat16)}},
            "step": jnp.asarray(7, jnp.int32)}


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


# ------------------------------------------------------------------ checkpoint


def test_save_load_roundtrip(tmp_path):
    state = _state()
    tck.save_checkpoint(str(tmp_path), 7, state)
    restored, step = tck.load_checkpoint(str(tmp_path), state)
    assert step == 7
    _equal(restored, state)
    assert restored["params"]["nested"]["b"].dtype == torch.bfloat16


def test_load_into_meta_template(tmp_path):
    state = _state()
    tck.save_checkpoint(str(tmp_path), 3, state)
    tpl = topt.tree_map(lambda t: t.to("meta"), state)
    restored, _ = tck.load_checkpoint(str(tmp_path), tpl, device="cpu")
    _equal(restored, state)


def test_shardings_are_refused_naming_the_roadmap(tmp_path):
    tck.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(NotImplementedError, match="queue A, item 17"):
        tck.load_checkpoint(str(tmp_path), {"w": torch.ones(2)},
                            shardings={"w": None})


def test_manager_rotation_and_latest(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, {"x": torch.tensor(s)}, sync=True)
    assert tck.latest_step(str(tmp_path)) == 30
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_000000020", "step_000000030"]
    restored, step = mgr.restore({"x": torch.tensor(0)})
    assert step == 30 and int(restored["x"]) == 30


def test_async_save_snapshots_on_the_callers_thread(tmp_path):
    """The host copy is taken before `save` returns: an in-place update
    right after it (as the train step makes) does not reach the file."""
    mgr = tck.CheckpointManager(str(tmp_path), keep=3)
    state = _state()
    mgr.save(5, state)           # async
    state["params"]["w"].add_(100.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore(_state())
    _equal(restored, _state())


def test_atomicity_no_tmp_left(tmp_path):
    tck.save_checkpoint(str(tmp_path), 1, _state())
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    (tmp_path / "step_000000009.tmp").mkdir()    # a save cut mid-write
    assert tck.latest_step(str(tmp_path)) == 1


def test_large_leaf_is_split_into_shards_as_in_jax(tmp_path):
    """A leaf over 64 MiB goes to several files, as JAX splits it, and
    each package reads the other's."""
    big = np.arange((64 << 20) // 4 * 2 + 3, dtype=np.float32)
    tck.save_checkpoint(str(tmp_path / "t"), 1,
                        {"big": torch.from_numpy(big)})
    assert sum(f.startswith("big.shard_") for f in
               os.listdir(tmp_path / "t" / "step_000000001")) == 2
    jr, _ = jck.load_checkpoint(str(tmp_path / "t"), {"big": jnp.zeros(
        big.shape, jnp.float32)})
    np.testing.assert_array_equal(np.asarray(jr["big"]), big)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_packages(writer, tmp_path):
    """A state with a bf16 leaf, written by one package, restores in the
    other bit for bit, with its dtypes."""
    d = str(tmp_path)
    if writer == "jax":
        jck.save_checkpoint(d, 7, _jstate())
        restored, step = tck.load_checkpoint(d, _state())
        _equal(restored, _state())
    else:
        tck.save_checkpoint(d, 7, _state())
        restored, step = jck.load_checkpoint(d, _jstate())
        assert restored["params"]["nested"]["b"].dtype == jnp.bfloat16
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a, np.float32), np.asarray(b, np.float32)),
            restored, _jstate())
    assert step == 7


def _resume_setup(opt_name="adamw"):
    kw = dict(n_layers=2, vocab=64, d_model=16, d_ff=32, head_dim=8,
              n_heads=2)
    cj = jget("gemma-2b").reduced(**kw)
    ct = dataclasses.replace(tget("gemma-2b").reduced(**kw),
                             attn_impl="blockwise")
    opt = dict(name=opt_name, lr=1e-2, warmup_steps=0, schedule="constant",
               total_steps=10)
    jp = jt.init_params(cj, jax.random.PRNGKey(0))
    fresh = lambda: tt.params_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, jp), device="cpu")
    return cj, ct, jp, fresh, opt


def test_train_resume_bitexact(tmp_path):
    """Fault tolerance end to end: train 6 steps straight vs train 3,
    checkpoint, 'crash', restore, train 3 — identical final params."""
    _, ct, _, fresh, opt = _resume_setup()
    loss_fn = lambda p, b: tt.lm_loss(p, b, ct, xent_chunk=8)  # noqa: E731
    tcfg = ttl.TrainConfig(opt=topt.OptimizerConfig(**opt), log_every=1)
    ld = ShardedLoader(DataConfig(seq_len=8, global_batch=2, vocab=64,
                                  seed=1))
    sA, _ = ttl.train(loss_fn, fresh(), ld, tcfg, num_steps=6)
    sB, _ = ttl.train(loss_fn, fresh(), ld, tcfg, num_steps=3)
    tck.save_checkpoint(str(tmp_path), 3, sB)
    tpl = topt.tree_map(lambda t: t.to("meta"), sB)
    sB2, step = tck.load_checkpoint(str(tmp_path), tpl, device="cpu")
    sB2, _ = ttl.train(loss_fn, None, ld, tcfg, num_steps=3,
                       start_step=step, state=sB2)
    _equal(topt.tree_map(torch.Tensor.detach, sA["params"]),
           topt.tree_map(torch.Tensor.detach, sB2["params"]))


def test_jax_trains_three_steps_then_the_port_three_more(tmp_path):
    cj, ct, jp, _, opt = _resume_setup("sgd")
    jcfg = jtl.TrainConfig(opt=jopt.OptimizerConfig(**opt), log_every=1)
    tcfg = ttl.TrainConfig(opt=topt.OptimizerConfig(**opt), log_every=1)
    kw = dict(seq_len=8, global_batch=2, vocab=64, seed=1)
    jloss = lambda p, b: jt.lm_loss(p, b, cj, xent_chunk=8)  # noqa: E731
    fresh = lambda: jt.init_params(cj, jax.random.PRNGKey(0))  # noqa: E731
    sA, _ = jtl.train(jloss, fresh(), JLoader(JDataConfig(**kw)), jcfg,
                      num_steps=6)
    sB, _ = jtl.train(jloss, fresh(), JLoader(JDataConfig(**kw)), jcfg,
                      num_steps=3)
    jck.save_checkpoint(str(tmp_path), 3, sB)
    tpl = ttl.init_train_state(tt.init_params(ct, 0, device="cpu"), tcfg)
    state, step = tck.load_checkpoint(str(tmp_path), tpl)
    assert step == 3 and int(state["step"]) == 3 and \
        int(state["opt"]["count"]) == 3
    state, _ = ttl.train(
        lambda p, b: tt.lm_loss(p, b, ct, xent_chunk=8), None,
        ShardedLoader(DataConfig(**kw)), tcfg, num_steps=3, start_step=3,
        state=state)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * (np.abs(want).max() + 1))
    jax.tree.map(close, state["params"], sA["params"])
    assert int(state["step"]) == int(sA["step"]) == 6


# ------------------------------------------------------------------ monitor


@pytest.fixture(params=["jax", "port"])
def mon(request):
    """The monitor module of each package: every case below runs on both."""
    return {"jax": jmon, "port": tmon}[request.param]


def test_straggler_detection(mon):
    m = mon.HeartbeatMonitor([f"h{i}" for i in range(8)], window=4)
    for step in range(4):
        for i in range(8):
            m.record(f"h{i}", step, 1.0 if i != 5 else 3.5)  # h5 is slow
    rep = m.report(step=3)
    assert list(rep.stragglers) == ["h5"]
    assert not rep.missing


def test_missing_host_detection(mon):
    clk = [0.0]
    m = mon.HeartbeatMonitor(["a", "b"], miss_timeout_s=10.0,
                             clock=lambda: clk[0])
    m.record("a", 0, 1.0)
    m.record("b", 0, 1.0)
    clk[0] = 12.0
    m.record("a", 1, 1.0)
    clk[0] = 20.0                    # b silent for 20s, a for only 8s
    assert m.report(step=1).missing == ["b"]


def _report(mon, missing=(), stragglers=None, step=0):
    return mon.StragglerReport(step=step, median_s=1.0, threshold_s=2.0,
                               stragglers=dict(stragglers or {}),
                               missing=list(missing))


@pytest.mark.parametrize("times,actions", [
    # budget 2 in a 100 s window, restarts at t = 0 and 1 fill it, the
    # window expiring at t = 200 frees it (test_runtime.py)
    ((0.0, 1.0, 2.0, 200.0), ("restart", "restart", "abort", "restart")),
    # sliding, not reset: one expiring restart frees one slot
    # (test_monitor.py)
    ((0.0, 50.0, 90.0, 101.0, 102.0),
     ("restart", "restart", "abort", "restart", "abort"))])
def test_restart_budget_window(mon, times, actions):
    clk = [0.0]
    pol = mon.RestartPolicy(budget=2, budget_window_s=100.0,
                            clock=lambda: clk[0])
    for i, (t, want) in enumerate(zip(times, actions)):
        clk[0] = t
        assert pol.decide(_report(mon, [f"h{i}"]), 16)["action"] == want


@pytest.mark.parametrize("fraction,lost,want", [
    (0.75, 8, "abort"), (0.5, 8, "restart"), (0.5, 9, "abort")])
def test_min_hosts_fraction(mon, fraction, lost, want):
    pol = mon.RestartPolicy(min_hosts_fraction=fraction, budget=10)
    rep = _report(mon, [f"h{i}" for i in range(lost)])
    assert pol.decide(rep, 16)["action"] == want


@pytest.mark.parametrize("missing,stragglers,want", [
    ((), {"h7": 9.0}, {"action": "exclude", "hosts": ["h7"]}),
    (("h1",), {"h2": 9.0}, {"exclude": ["h1", "h2"], "new_world": 15}),
    (("h3",), {"h3": 9.0}, {"exclude": ["h3"]})])
def test_restart_excludes_stragglers(mon, missing, stragglers, want):
    out = mon.RestartPolicy().decide(_report(mon, missing, stragglers), 16)
    assert {k: out[k] for k in want} == want


def test_elastic_scale_up_host_joins_report(mon):
    m = mon.HeartbeatMonitor(["a", "b"], miss_timeout_s=10.0)
    for step in range(3):
        m.record("a", step, 1.0)
        m.record("b", step, 1.0)
    m.record("c", 2, 1.0)              # scale-up: never in the ctor list
    assert "c" in m.hosts
    assert not m.report(step=2).missing
    m.record("c", 3, 9.0)              # and participates in detection
    assert "c" in m.report(step=3).stragglers
