"""The port's serving engine and CLI (`repro_torch.serving.engine`,
`repro_torch.launch.serve`) against the JAX package's, mirroring
`tests/test_serving.py`.

Greedy outputs of the port's `ServeEngine` equal JAX's `ServeEngine` on
the same bridged weights (reduced configs, fp32), on the kernel route
("cuda", plain on the CPU) and on blockwise attention, for the
attention-only archs, recurrentgemma-2b (RG-LRU) and granite-moe-1b-a400m
(MoE; also at the full config's capacity factor 1.25, where prefill drops
tokens).  Sampling at a
temperature uses a `torch.Generator`, whose stream differs from
`jax.random`'s, so it is checked for determinism only.
"""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import engine as je  # noqa: E402
from repro.serving import quantize as jq  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import quantize as tq  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServeEngine)

PROMPT = np.array([5, 17, 42, 7, 99], np.int32)
ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = jget(arch).reduced()
    jp = jt.init_params(cfg, jax.random.PRNGKey(0))
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _engine(arch, packed=False, cfg=None, **ecfg):
    tp = _params(arch)[1]
    return ServeEngine(cfg or tget(arch).reduced(),
                       tq.quantize_params(tp) if packed else tp,
                       EngineConfig(**ecfg))


def _jax_engine(arch, prompts, n_new, packed=False, cfg=None, **ecfg):
    jp = _params(arch)[0]
    jeng = je.ServeEngine(cfg or jget(arch).reduced(),
                          jq.quantize_params(jp) if packed else jp,
                          je.EngineConfig(**ecfg))
    for i, p in enumerate(prompts):
        jeng.submit(je.Request(uid=i, prompt=p, max_new_tokens=n_new))
    return {r.uid: r.output for r in jeng.run()}


def _serve(eng, prompts, n_new, **kw):
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=n_new, **kw))
    return {r.uid: r.output for r in eng.run()}


def _naive_greedy(arch, prompt, n_new):
    """Reference: rerun the port's full forward on the growing sequence."""
    cfg, tp = tget(arch).reduced(), _params(arch)[1]
    toks = list(prompt)
    for _ in range(n_new):
        h, _, _ = tt.forward(tp, torch.tensor([toks]), cfg)
        toks.append(int(tt.logits_fn(tp, h[:, -1:], cfg)[0, 0].argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("arch,packed", [
    ("gemma-2b", False), ("qwen1.5-4b", False), ("gemma3-1b", False),
    ("gemma-2b", True), ("recurrentgemma-2b", False),
    ("recurrentgemma-2b", True), ("granite-moe-1b-a400m", False),
    ("granite-moe-1b-a400m", True)])
def test_engine_matches_jax_engine(arch, packed):
    jp = _params(arch)[0]
    jeng = je.ServeEngine(jget(arch).reduced(),
                          jq.quantize_params(jp) if packed else jp,
                          je.EngineConfig(max_batch=2, max_prompt=16,
                                          max_len=32))
    jeng.submit(je.Request(uid=0, prompt=PROMPT, max_new_tokens=6))
    want = jeng.run()[0].output
    for impl in ("cuda", "blockwise"):
        eng = _engine(arch, packed, max_batch=2, max_prompt=16, max_len=32,
                      attn_impl=impl)
        assert eng.cfg.attn_impl == impl
        assert _serve(eng, [PROMPT], 6)[0] == want, impl


def test_engine_runs_dense_layers_and_attention_through_ops(monkeypatch):
    """Packed weights: every dense layer goes through `ops.log_matmul` and
    every attention call through `ops.attention`, 7 and 1 per layer per
    forward (what the chip run counts as kernel launches)."""
    calls = {"log_matmul": 0, "attention": 0}
    for op in calls:
        orig = getattr(tops, op)

        def counted(*a, _orig=orig, _op=op, **kw):
            calls[_op] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tops, op, counted)
    eng = _engine("gemma-2b", packed=True, max_batch=2, max_prompt=16,
                  max_len=32)
    _serve(eng, [PROMPT, PROMPT[:3]], 4)
    fwd = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    n_layers = tget("gemma-2b").reduced().n_layers
    assert calls == {"log_matmul": 7 * n_layers * fwd,
                     "attention": n_layers * fwd}


def _launches_per_forward(cfg) -> dict:
    """`chip_smoke.launches_per_forward`: the launch counts the chip run
    expects a forward, from the layer pattern."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke.launches_per_forward(cfg)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b",
                                  "granite-moe-1b-a400m"])
def test_engine_runs_griffin_and_moe_archs_through_ops(arch, monkeypatch):
    """Packed weights: the `ops` calls a forward makes are the launches
    the chip run expects from the layer pattern (recurrentgemma reduced:
    2 × (rec, rec, local) gives 2 × (3 + 3 + 7) = 26 log_matmul and 2
    attention calls; granite: 4 a layer and 1), and at full depth that
    count gives 110 + 8 and 128 + 32, and gemma-2b's and rwkv6-1.6b's
    126 + 18 and 192 + 24 WKV as before."""
    calls = {"log_matmul": 0, "attention": 0}
    for op in calls:
        orig = getattr(tops, op)

        def counted(*a, _orig=orig, _op=op, **kw):
            calls[_op] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tops, op, counted)
    eng = _engine(arch, packed=True, max_batch=2, max_prompt=16, max_len=32)
    _serve(eng, [PROMPT, PROMPT[:3]], 4)
    fwd = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    per = _launches_per_forward(tget(arch).reduced())
    assert calls == {op: per[op] * fwd for op in calls} and per["wkv6"] == 0
    full = {a: tuple(_launches_per_forward(tget(a)).values()) for a in
            ("gemma-2b", "rwkv6-1.6b", "recurrentgemma-2b",
             "granite-moe-3b-a800m")}
    assert full == {"gemma-2b": (126, 18, 0), "rwkv6-1.6b": (192, 0, 24),
                    "recurrentgemma-2b": (110, 8, 0),
                    "granite-moe-3b-a800m": (128, 32, 0)}


def test_engine_recurrentgemma_refill_and_exact_length(monkeypatch):
    """recurrentgemma prefills at exact length (a pad would enter the
    RG-LRU state), and refilled slots start from a zeroed Griffin state:
    5 prompts on 2 slots equal JAX's engine and the solo full-forward
    reference."""
    arch = "recurrentgemma-2b"
    lengths = []
    fwd = tt.forward

    def spy(params, inputs, cfg, **kw):
        if inputs.shape[0] == 1:
            lengths.append(inputs.shape[1])
        return fwd(params, inputs, cfg, **kw)

    monkeypatch.setattr(tt, "forward", spy)
    prompts = [np.arange(1, 4 + i, dtype=np.int32) for i in range(5)]
    eng = _engine(arch, max_batch=2, max_prompt=16, max_len=32)
    done = _serve(eng, prompts, 4)
    monkeypatch.setattr(tt, "forward", fwd)
    assert sorted(lengths) == [3, 4, 5, 6, 7]
    want = _jax_engine(arch, prompts, 4, max_batch=2, max_prompt=16,
                       max_len=32)
    for i, p in enumerate(prompts):
        assert done[i] == want[i], f"request {i} vs JAX"
        assert done[i] == _naive_greedy(arch, p, 4), f"request {i} vs solo"


@pytest.mark.parametrize("packed", [False, True])
def test_engine_moe_at_capacity_factor_125_matches_jax(packed, monkeypatch):
    """granite at the full config's capacity factor 1.25: prompts of 3, 5
    and 9 tokens prefill in buckets of 4, 8 and 16, where C = int(1.25 ·
    Tpad · 2 / 8) = 1, 2 and 5 drops tokens (pads included); decode routes
    the 3 slots as one group, JAX's engine each slot alone.  Greedy tokens
    equal JAX's engine."""
    arch = "granite-moe-1b-a400m"
    over = dict(capacity_factor=1.25)
    prompts = [np.array([5, 17, 42], np.int32),
               np.array([9, 3, 77, 21, 8], np.int32),
               np.array([2, 7, 1, 8, 2, 8, 1, 8, 3], np.int32)]
    sizes = dict(max_batch=3, max_prompt=16, max_len=32)
    seen = []
    route = tmoe.route

    def spy(p, xt, cfg, T, capacity=None):
        rt = route(p, xt, cfg, T, capacity)
        seen.append((T, int((~rt["keep"]).sum())))
        return rt

    monkeypatch.setattr(tmoe, "route", spy)
    eng = _engine(arch, packed, cfg=tget(arch).reduced(**over), **sizes)
    done = _serve(eng, prompts, 5)
    want = _jax_engine(arch, prompts, 5, packed,
                       cfg=jget(arch).reduced(**over), **sizes)
    assert done == want
    assert {T for T, _ in seen} == {4, 8, 16, 1}
    assert sum(n for T, n in seen if T > 1) > 0       # prefill drops
    assert sum(n for T, n in seen if T == 1) == 0     # decode never does


def test_engine_ragged_batch_isolation():
    """Two prompts of different lengths decode exactly as they would alone."""
    p1 = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
    p2 = np.array([2, 7, 1], np.int32)
    done = _serve(_engine("gemma-2b", max_batch=2, max_prompt=16, max_len=32),
                  [p1, p2], 5)
    assert done[0] == _naive_greedy("gemma-2b", p1, 5)
    assert done[1] == _naive_greedy("gemma-2b", p2, 5)


def test_engine_continuous_batching_refill():
    """More requests than slots: slots are refilled, all finish, outputs
    match the solo references (no cross-request cache pollution; gemma3-1b
    has ring layers)."""
    prompts = [np.arange(1, 4 + i, dtype=np.int32) for i in range(5)]
    eng = _engine("gemma3-1b", max_batch=2, max_prompt=16, max_len=32)
    done = _serve(eng, prompts, 4)
    assert len(done) == 5
    for i, p in enumerate(prompts):
        assert done[i] == _naive_greedy("gemma3-1b", p, 4), f"request {i}"
    assert eng.stats["prefill_calls"] == 5


def test_engine_max_len_stops_generation():
    eng = _engine("gemma-2b", max_batch=1, max_prompt=8, max_len=10)
    eng.submit(Request(uid=0, prompt=np.array([1, 2, 3], np.int32),
                       max_new_tokens=100))
    done = eng.run()
    assert done[0].done
    assert len(done[0].output) <= 10 - 3 + 1


def test_engine_rejects_nonpositive_max_new_tokens():
    eng = _engine("gemma-2b", max_batch=1, max_prompt=8, max_len=16)
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
        eng.submit(Request(uid=0, prompt=np.array([1, 2], np.int32),
                           max_new_tokens=0))
    assert not eng.queue                 # rejected request never queued


def test_engine_queue_admits_fifo():
    eng = _engine("gemma-2b", max_batch=1, max_prompt=8, max_len=32)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=np.array([1 + uid, 2], np.int32),
                           max_new_tokens=2))
    assert [r.uid for r in eng.run()] == [0, 1, 2]


def test_engine_temperature_sampling_deterministic_per_seed():
    def run_once(seed):
        eng = _engine("gemma-2b", max_batch=1, max_prompt=8, max_len=32)
        eng.submit(Request(uid=0, prompt=np.array([1, 2], np.int32),
                           max_new_tokens=5, temperature=1.0, seed=seed))
        return eng.run()[0].output

    assert run_once(42) == run_once(42)
    assert len(run_once(7)) == 5


@pytest.fixture
def kernel_profile():
    """The kernel-dispatch profiler, empty and deferring to the env gates,
    before and after the test."""
    from repro_torch.obs import kernel_profile as kprof
    kprof.set_enabled(None)
    kprof.clear()
    yield kprof
    kprof.set_enabled(None)
    kprof.clear()


def test_serve_main_runs_to_the_end(tmp_path, capsys, monkeypatch,
                                    kernel_profile):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    monkeypatch.delenv("REPRO_KERNEL_PROFILE", raising=False)
    out = tmp_path / "metrics.json"
    done = tserve.main(["--reduced", "--device", "cpu", "--requests", "3",
                        "--max-new", "4", "--telemetry", "on",
                        "--metrics-out", str(out)])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    snap = json.loads(out.read_text())
    assert snap["stats"] == {"prefill_calls": 3, "decode_steps": 3,
                             "tokens_out": 12}
    assert snap["engine"]["histograms"]["serve_ttft_s"]["count"] == 3
    # the profiler is off: its section is there and empty
    assert snap["kernels"] == {"records": [], "programs": {}}


def test_serve_metrics_out_has_kernel_records(tmp_path, monkeypatch,
                                              kernel_profile):
    """With ``REPRO_KERNEL_PROFILE=1``, ``--metrics-out`` writes the
    profiler's records: every packed product and attention call of the run,
    and the prefill and decode programs."""
    monkeypatch.setenv("REPRO_KERNEL_PROFILE", "1")
    out = tmp_path / "metrics.json"
    tserve.main(["--reduced", "--device", "cpu", "--requests", "3",
                 "--max-new", "4", "--metrics-out", str(out)])
    kern = json.loads(out.read_text())["kernels"]
    assert {r["op"] for r in kern["records"]} == {"log_matmul", "attention"}
    assert all(r["key"].split("|")[1] == "cpu" and r["bytes"]["total"] > 0
               for r in kern["records"])
    assert kern["programs"]["prefill"]["calls"] == 3
    assert kern["programs"]["decode"]["calls"] == 3


@pytest.mark.parametrize("arch", ["recurrentgemma-2b",
                                  "granite-moe-3b-a800m"])
def test_serve_main_runs_griffin_and_moe(arch, capsys):
    done = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--requests", "3", "--max-new", "4"])
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """Without a card, the LM entry points raise unless the caller passes
    ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget("gemma-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.params_from_numpy({"w": np.ones(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduced", "--requests", "1"])
