"""The port's telemetry stack (`repro_torch.obs`): span tracer, metrics
registry and kernel-dispatch profiler, mirroring `tests/test_obs.py`, and
the port's profiler records held against the JAX package's for the four
ops (same op, impl, key once the backend field is removed, and bytes).

The CUDA-event path of the profiler is exercised here with stand-in events
(the CPU has no card); the test marked ``cuda`` runs it on the card."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the machine with the card has no JAX: the cross-package test skips
    import jax.numpy as jnp
    from repro.core.logquant import quantize_tensor as jquantize
    from repro.kernels import ops as jops
    from repro.obs import kernel_profile as jkprof
except ImportError:
    jnp = None

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.logquant import quantize_tensor as tquantize  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.obs import kernel_profile as kprof  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServeEngine)
from repro_torch.serving.quantize import quantize_params  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    """Each test starts with env gates unset, empty buffers, no overrides."""
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    monkeypatch.delenv("REPRO_KERNEL_PROFILE", raising=False)
    profilers = [kprof] + ([jkprof] if jnp is not None else [])
    for p in [obs_trace] + profilers:
        p.set_enabled(None)
        p.clear()
    yield
    for p in [obs_trace] + profilers:
        p.set_enabled(None)
        p.clear()


def _small_model():
    cfg = get_config("gemma-2b").reduced(n_layers=2, vocab=64, d_model=16,
                                         d_ff=32, head_dim=8, n_heads=2)
    return cfg, transformer.init_params(cfg, 0, device="cpu")


# ------------------------------------------------------------------- tracer


def test_tracer_disabled_is_shared_noop():
    assert not obs_trace.enabled()
    s1, s2 = obs_trace.span("a"), obs_trace.span("b", x=1)
    assert s1 is s2                       # one shared null span, no allocs
    with s1:
        pass
    obs_trace.instant("marker")
    obs_trace.add_complete("ext", 0, 100)
    assert obs_trace.events() == []


def test_tracer_env_gate_and_override(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "1")
    assert obs_trace.enabled()
    obs_trace.set_enabled(False)          # override beats env
    assert not obs_trace.enabled()
    obs_trace.set_enabled(None)           # defer back to env
    assert obs_trace.enabled()
    monkeypatch.setenv("REPRO_TRACE", "off")
    assert not obs_trace.enabled()


def test_tracer_ring_buffer_bounded():
    t = obs_trace.Tracer(capacity=4)
    t.set_enabled(True)
    for i in range(10):
        with t.span(f"s{i}"):
            pass
    evs = t.events()
    assert len(evs) == 4
    assert [e[1] for e in evs] == ["s6", "s7", "s8", "s9"]  # keeps latest


def test_tracer_chrome_export_loadable(tmp_path):
    obs_trace.set_enabled(True)
    with obs_trace.span("work", uid=7) as sp:
        sp.set(tokens=3)
    obs_trace.instant("mark", note="x")
    path = tmp_path / "sub" / "trace.json"   # exercises makedirs
    obs_trace.export_chrome_trace(str(path))
    payload = json.loads(path.read_text())
    assert payload["displayTimeUnit"] == "ms"
    evs = payload["traceEvents"]
    by_name = {e["name"]: e for e in evs}
    work = by_name["work"]
    assert work["ph"] == "X" and work["dur"] >= 0
    assert work["args"] == {"uid": 7, "tokens": 3}
    assert by_name["mark"]["ph"] == "i" and by_name["mark"]["s"] == "t"
    for e in evs:
        assert {"ts", "pid", "tid", "cat"} <= set(e)


def test_traced_decorator():
    calls = []

    @obs_trace.traced("fancy", kind="unit")
    def fn(x):
        calls.append(x)
        return x * 2

    assert fn(3) == 6                     # disabled: plain passthrough
    assert obs_trace.events() == []
    obs_trace.set_enabled(True)
    assert fn(4) == 8
    (ev,) = obs_trace.events()
    assert ev[1] == "fancy" and ev[5] == {"kind": "unit"}
    assert calls == [3, 4]


# ------------------------------------------------------------------ metrics


def test_log_bucket_bounds():
    b = obs_metrics.log_bucket_bounds(1e-3, 1.0, per_decade=3)
    assert b[0] == pytest.approx(1e-3)
    assert b[-1] >= 1.0
    assert all(x < y for x, y in zip(b, b[1:]))
    ratios = [y / x for x, y in zip(b, b[1:])]   # geometric spacing
    assert max(ratios) == pytest.approx(min(ratios))
    with pytest.raises(ValueError):
        obs_metrics.log_bucket_bounds(1.0, 0.5)


def test_counter_gauge():
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("reqs", route="a")
    c.inc()
    c.inc(3)
    assert c.value == 4
    assert reg.counter("reqs", route="a") is c       # get-or-create
    assert reg.counter("reqs", route="b") is not c   # distinct labels
    g = reg.gauge("depth")
    g.set(5)
    g.inc(-2)
    assert g.value == 3


def test_histogram_percentiles_and_snapshot():
    reg = obs_metrics.MetricsRegistry()
    h = reg.histogram("lat_s")
    for v in (0.001, 0.002, 0.002, 0.003, 0.5):
        h.record(v)
    assert h.count == 5
    assert h.sum == pytest.approx(0.508)
    p50, p99 = h.percentile(50), h.percentile(99)
    assert 0.001 <= p50 <= 0.5
    assert p50 <= p99 <= 0.5
    snap = h.snapshot()
    assert snap["count"] == 5 and snap["min"] == 0.001 and snap["max"] == 0.5
    assert snap["mean"] == pytest.approx(0.508 / 5)
    assert snap["buckets"][-1][0] == "+Inf"
    assert sum(c for _, c in snap["buckets"]) == 5
    assert snap["p50"] == pytest.approx(p50)
    assert reg.histogram("empty").percentile(50) == 0.0


def test_registry_kind_collision():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


def test_registry_snapshot_and_prometheus():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("hits", op="conv").inc(2)
    reg.gauge("depth").set(1.5)
    h = reg.histogram("lat", bounds=(0.1, 1.0))
    h.record(0.05)
    h.record(0.5)
    h.record(7.0)

    snap = reg.snapshot()
    assert snap["counters"] == {'hits{op="conv"}': 2}
    assert snap["gauges"] == {"depth": 1.5}
    assert snap["histograms"]["lat"]["count"] == 3

    text = reg.to_prometheus()
    assert "# TYPE hits counter" in text
    assert 'hits{op="conv"} 2' in text
    assert "# TYPE lat histogram" in text
    # cumulative buckets: ≤0.1 → 1, ≤1.0 → 2, +Inf → 3
    assert 'lat_bucket{le="0.1"} 1' in text
    assert 'lat_bucket{le="1.0"} 2' in text
    assert 'lat_bucket{le="+Inf"} 3' in text
    assert "lat_sum 7.55" in text and "lat_count 3" in text


def test_registry_dump_json(tmp_path):
    reg = obs_metrics.MetricsRegistry()
    reg.counter("n").inc()
    path = tmp_path / "m.json"
    reg.dump_json(str(path))
    assert json.loads(path.read_text())["counters"]["n"] == 1


# ----------------------------------------------------------- kernel profiler


def test_profiler_disabled_passthrough():
    p = kprof.KernelProfiler()
    assert p.dispatch("op", "ref", "k", {}, lambda: 42, traced=False) == 42
    assert p.time_program("prog", lambda: torch.ones(2)).shape == (2,)
    snap = p.snapshot()
    assert snap["records"] == [] and snap["programs"] == {}


def test_profiler_eager_first_vs_steady():
    p = kprof.KernelProfiler()
    p.set_enabled(True)
    fn = lambda: torch.ones(4)
    for _ in range(3):
        p.dispatch("attention", "ref", "k1", {"total": 64}, fn, traced=False)
    (rec,) = p.snapshot()["records"]
    assert rec["calls"] == 3 and rec["traced_calls"] == 0
    assert rec["first_us"] is not None
    assert rec["steady_us"] is not None and rec["steady_source"] == "self"
    assert rec["steady_us_min"] <= rec["steady_us"]
    assert rec["bytes"]["total"] == 64


def test_profiler_traced_dispatch_inherits_program_time():
    """A dispatch made while a graph is captured (``traced=True``) has no
    clock of its own: it takes its program's steady time."""
    kprof.set_enabled(True)

    def program():
        return kprof.dispatch("attention", "blockwise", "k-traced",
                              {"total": 128}, lambda: torch.ones(2),
                              traced=True)
    for _ in range(3):                    # 1 first + 2 steady
        kprof.time_program("myprog", program)
    snap = kprof.snapshot()
    (rec,) = [r for r in snap["records"] if r["op"] == "attention"]
    assert rec["traced_calls"] == 3 and rec["calls"] == 0
    assert rec["program"] == "myprog"
    assert rec["steady_source"] == "program:myprog"
    assert rec["steady_us"] is not None and rec["bytes"]["total"] > 0
    prog = snap["programs"]["myprog"]
    assert prog["calls"] == 3 and prog["first_us"] is not None
    assert prog["steady_us"] is not None
    assert not kprof.is_traced(torch.ones(2))   # never on the CPU


def test_profiler_eager_ops_dispatch_records():
    kprof.set_enabled(True)
    q = torch.ones((1, 8, 2, 4))
    kv = torch.ones((1, 8, 2, 4))
    for _ in range(2):
        ops.attention(q, kv, kv, impl="blockwise")
    recs = [r for r in kprof.snapshot()["records"]
            if r["op"] == "attention" and r["calls"] == 2]
    assert recs
    rec = recs[0]
    assert rec["impl"] == "blockwise"
    assert rec["key"].startswith("attention|cpu|")
    assert rec["bytes"]["total"] > 0
    assert rec["steady_source"] == "self"
    # dispatch also feeds the process-wide latency histogram
    h = obs_metrics.REGISTRY.histogram(
        "kernel_dispatch_us", bounds=obs_metrics.US_BUCKETS,
        op="attention", impl="blockwise", phase="steady")
    assert h.count >= 1


def test_profiler_off_computes_no_key_or_bytes(monkeypatch):
    """While profiling is off the ops compute no key and no byte count."""
    def boom(*a, **k):
        raise AssertionError("computed while profiling is off")
    for name in ("conv_key", "conv_traffic_bytes", "attention_key",
                 "attention_traffic_bytes"):
        monkeypatch.setattr(ops, name, boom)
    monkeypatch.setattr(ops._kprof, "dispatch", boom)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(1, 6, 6, 4)).astype(np.float32))
    qt = tquantize(torch.as_tensor(rng.normal(size=(3, 3, 4, 5))
                                   .astype(np.float32)))
    ops.conv2d(x, qt, impl="cuda")
    ops.log_matmul(x.reshape(-1, 4),
                   tquantize(torch.as_tensor(rng.normal(size=(4, 3))
                                             .astype(np.float32))))
    q = torch.ones((1, 4, 2, 4))
    ops.attention(q, q, q, impl="cuda")
    ops.wkv6(q, q, q, -q.abs(), torch.ones((2, 4)), impl="cuda")
    assert kprof.snapshot() == {"records": [], "programs": {}}


class _FakeEvent:
    """Stands in for `torch.cuda.Event`: ``elapsed_time`` gives a fixed
    2 ms, and every synchronisation is logged."""
    log: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream=None):
        self.log.append("record")

    def synchronize(self):
        self.log.append("event.synchronize")

    def elapsed_time(self, other):
        return 2.0


def test_profiler_cuda_events_resolve_lazily(monkeypatch):
    """On a CUDA device a dispatch records an event pair and does not
    synchronise; `snapshot()` synchronises once and resolves every pair;
    past ``MAX_PENDING`` pairs the oldest resolve, so memory stays bounded."""
    _FakeEvent.log = []
    syncs = []
    monkeypatch.setattr(kprof.torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(kprof.torch.cuda, "current_stream",
                        lambda dev=None: "stream")
    monkeypatch.setattr(kprof.torch.cuda, "synchronize",
                        lambda dev=None: syncs.append(dev))
    monkeypatch.setattr(kprof, "MAX_PENDING", 4)
    p = kprof.KernelProfiler()
    p.set_enabled(True)
    obs_trace.set_enabled(True)
    for _ in range(4):
        p.dispatch("wkv6", "cuda", "k", {"total": 8}, lambda: 1,
                   traced=False, device="cuda:0")
    assert syncs == [] and "event.synchronize" not in _FakeEvent.log
    assert len(p._pending) == 4
    p.dispatch("wkv6", "cuda", "k", {"total": 8}, lambda: 1, traced=False,
               device="cuda:0")              # the fifth: two oldest resolve
    assert len(p._pending) == 3 and syncs == []
    (rec,) = p.snapshot()["records"]
    assert syncs == [torch.device("cuda:0")] and not p._pending
    assert rec["calls"] == 5 and rec["first_us"] == 2000.0
    assert rec["steady_us"] == 2000.0 and rec["steady_source"] == "self"
    spans = [e for e in obs_trace.events() if e[1] == "wkv6[cuda]"]
    assert len(spans) == 5 and spans[0][5]["phase"] == "compile"
    assert {e[3] for e in spans} == {2_000_000}   # the device duration, ns


def test_profiler_cuda_span_starts_at_the_launch_mark(monkeypatch):
    """With ``marks_launch`` a CUDA dispatch times from the event its kernel
    wrapper records right before the launch (once, however often it is
    called), not from the one before the call; a call that never marks is
    timed from the early event; without ``marks_launch`` ``fn`` takes no
    argument."""
    recorded, starts = [], []

    class Ev(_FakeEvent):
        def record(self, stream=None):
            recorded.append(self)

        def elapsed_time(self, other):
            starts.append(self)
            return 2.0
    monkeypatch.setattr(kprof.torch.cuda, "Event", Ev)
    monkeypatch.setattr(kprof.torch.cuda, "current_stream",
                        lambda dev=None: "stream")
    monkeypatch.setattr(kprof.torch.cuda, "synchronize", lambda dev=None: 0)
    p = kprof.KernelProfiler()
    p.set_enabled(True)

    def launches(mark=None):
        mark()
        mark()
        return 7
    assert p.dispatch("conv2d", "cuda", "k", {"total": 8}, launches,
                      traced=False, device="cuda:0", marks_launch=True) == 7
    assert len(recorded) == 3          # before the call, the mark, after it
    p.snapshot()
    assert starts == [recorded[1]]
    recorded.clear()
    starts.clear()
    p.dispatch("conv2d", "cuda", "k", {"total": 8}, lambda mark=None: 1,
               traced=False, device="cuda:0", marks_launch=True)
    p.dispatch("wkv6", "cuda", "k", {"total": 8}, lambda: 1, traced=False,
               device="cuda:0")
    p.snapshot()
    assert starts == [recorded[0], recorded[2]] and len(recorded) == 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_profiler_counts_kernel_launches_on_card(cuda_device):
    from repro_torch.kernels.log_conv2d import log_conv2d_fused
    kprof.set_enabled(True)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(2, 16, 16, 32)).astype(np.float32),
                        device=cuda_device)
    qt = tquantize(torch.as_tensor(rng.normal(size=(3, 3, 32, 64))
                                   .astype(np.float32), device=cuda_device))
    before = log_conv2d_fused.launches
    for _ in range(4):
        ops.conv2d(x, qt)
    (rec,) = kprof.snapshot()["records"]
    assert rec["calls"] == log_conv2d_fused.launches - before == 4
    assert rec["impl"] == "cuda" and rec["key"].startswith("conv2d|cuda|")
    assert rec["steady_us"] > 0 and rec["first_us"] > 0


# -------------------------------------------------- the JAX package's records


def _case(name, rng):
    """(port call, JAX call) of one op on the same seeded numpy inputs."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    if name == "log_matmul":
        x, w = f32(2, 3, 32), f32(32, 24)
        return (lambda impl: ops.log_matmul(torch.as_tensor(x),
                                            tquantize(torch.as_tensor(w)),
                                            impl=impl),
                lambda impl: jops.log_matmul(jnp.asarray(x),
                                             jquantize(jnp.asarray(w)),
                                             impl=impl))
    if name.startswith("conv2d"):
        B, H, W, C, K, P, s, pad, g = (
            (1, 9, 7, 4, 3, 6, 2, "SAME", 1) if name == "conv2d_dense"
            else (2, 8, 8, 6, 3, 6, 1, "VALID", 6))
        x, w = f32(B, H, W, C), f32(K, K, C // g, P)
        kw = dict(stride=s, padding=pad, groups=g)
        return (lambda impl: ops.conv2d(torch.as_tensor(x),
                                        tquantize(torch.as_tensor(w)),
                                        impl=impl, **kw),
                lambda impl: jops.conv2d(jnp.asarray(x),
                                         jquantize(jnp.asarray(w)),
                                         impl=impl, **kw))
    if name == "attention":
        q, k, v = f32(2, 8, 4, 8), f32(2, 8, 2, 8), f32(2, 8, 2, 8)
        kw = dict(causal=True, window=4)
        return (lambda impl: ops.attention(
                    *map(torch.as_tensor, (q, k, v)), impl=impl, **kw),
                lambda impl: jops.attention(
                    *map(jnp.asarray, (q, k, v)), impl=impl, **kw))
    r, k, v, u = f32(1, 5, 2, 4), f32(1, 5, 2, 4), f32(1, 5, 2, 4), f32(2, 4)
    logw = -np.exp(f32(1, 5, 2, 4))
    args = (r, k, v, logw, u)
    return (lambda impl: ops.wkv6(*map(torch.as_tensor, args), impl=impl),
            lambda impl: jops.wkv6(*map(jnp.asarray, args), impl=impl))


def _records(snap):
    return [(r["op"], r["impl"],
             "|".join(f for i, f in enumerate(r["key"].split("|")) if i != 1),
             r["bytes"], r["calls"]) for r in snap["records"]]


@pytest.mark.skipif(jnp is None, reason="needs the JAX package")
@pytest.mark.parametrize("impl", ["blockwise", "ref"])
@pytest.mark.parametrize("name", ["log_matmul", "conv2d_dense",
                                  "conv2d_depthwise", "attention", "wkv6"])
def test_records_match_jax(name, impl):
    """Both packages' profilers record the same op, impl, key (less its
    backend field) and bytes for the same call."""
    kprof.set_enabled(True)
    jkprof.set_enabled(True)
    port_call, jax_call = _case(name, np.random.default_rng(0))
    port_call(impl)
    jax_call(impl)
    port, jx = _records(kprof.snapshot()), _records(jkprof.snapshot())
    assert len(port) == 1 and port == jx, (port, jx)


# ------------------------------------------------------- serving acceptance


def test_engine_trace_acceptance(tmp_path, monkeypatch):
    """REPRO_TRACE=1 + a run over 8 mixed-length requests must yield a
    loadable Chrome trace with prefill/decode spans and a metrics snapshot
    with TTFT/tokens-per-s histograms plus per-op kernel records carrying
    impl, analytic bytes moved and a steady-µs figure."""
    monkeypatch.setenv("REPRO_TRACE", "1")
    cfg, params = _small_model()
    eng = ServeEngine(cfg, quantize_params(params),   # so log_matmul runs
                      EngineConfig(max_batch=4, max_prompt=16, max_len=64))
    rng = np.random.default_rng(0)
    for uid in range(8):
        T = int(rng.integers(2, 13))
        eng.submit(Request(uid=uid,
                           prompt=rng.integers(1, cfg.vocab, size=T)
                           .astype(np.int32),
                           max_new_tokens=3 + uid % 4))
    done = eng.run()
    assert len(done) == 8

    path = tmp_path / "trace.json"
    obs_trace.export_chrome_trace(str(path))
    payload = json.loads(path.read_text())
    names = {e["name"] for e in payload["traceEvents"]}
    assert {"enqueue", "prefill", "decode", "retire"} <= names
    for e in payload["traceEvents"]:
        if e["ph"] == "X":
            assert e["dur"] >= 0

    for r in done:
        tl = r.timeline
        assert tl["enqueue"] <= tl["prefill_start"] <= tl["first_token"] \
            <= tl["retire"]

    snap = eng.metrics_snapshot()
    hists = snap["engine"]["histograms"]
    assert hists["serve_ttft_s"]["count"] == 8
    assert hists["serve_tokens_per_s"]["count"] == 8
    assert hists["serve_prefill_s"]["count"] == 8
    assert snap["engine"]["counters"]["serve_requests_retired"] == 8
    assert snap["stats"]["prefill_calls"] == 8

    recs = snap["kernels"]["records"]
    assert {r["op"] for r in recs} == {"log_matmul", "attention"}
    for r in recs:
        assert r["impl"]
        assert r["bytes"]["total"] > 0
        assert r["steady_us"] is not None, r
        assert r["steady_source"].startswith(("self", "program:")), r
    progs = snap["kernels"]["programs"]
    assert {"prefill", "decode"} <= set(progs)
    assert progs["decode"]["steady_us"] is not None
    assert progs["prefill"]["calls"] == 8
    assert progs["decode"]["calls"] == snap["stats"]["decode_steps"]


def test_engine_telemetry_off_records_nothing():
    obs_trace.set_enabled(True)           # tracer on, engine forced off
    cfg, params = _small_model()
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=2, max_prompt=16,
                                                max_len=32, telemetry="off"))
    eng.submit(Request(uid=0, prompt=np.array([1, 2, 3], np.int32),
                       max_new_tokens=3))
    done = eng.run()
    assert done[0].timeline == {}
    snap = eng.metrics_snapshot()
    assert snap["engine"]["histograms"]["serve_ttft_s"]["count"] == 0
    assert {e[1] for e in obs_trace.events()}.isdisjoint(
        {"enqueue", "prefill", "decode", "retire"})
    assert snap["kernels"]["programs"] == {}
    assert eng.stats["prefill_calls"] == 1    # counters always on


def test_engine_auto_follows_profiler_gate(monkeypatch):
    """With ``telemetry="auto"`` the profiler's own gate turns the engine's
    telemetry on: its programs are timed with the tracer off."""
    monkeypatch.setenv("REPRO_KERNEL_PROFILE", "1")
    cfg, params = _small_model()
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=2, max_prompt=16,
                                                max_len=32))
    eng.submit(Request(uid=0, prompt=np.array([1, 2, 3], np.int32),
                       max_new_tokens=3))
    eng.run()
    assert not obs_trace.enabled() and obs_trace.events() == []
    progs = eng.metrics_snapshot()["kernels"]["programs"]
    assert progs["prefill"]["calls"] == 1 and progs["decode"]["calls"] == 2
