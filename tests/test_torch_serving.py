"""The port's serving engine and CLI (`repro_torch.serving.engine`,
`repro_torch.launch.serve`) against the JAX package's, mirroring
`tests/test_serving.py`.

Greedy outputs of the port's `ServeEngine` equal JAX's `ServeEngine` on
the same bridged weights (reduced configs, fp32), on the kernel route
("cuda", plain on the CPU) and on blockwise attention.  Sampling at a
temperature uses a `torch.Generator`, whose stream differs from
`jax.random`'s, so it is checked for determinism only.
"""

import functools
import json

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
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import quantize as tq  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServeEngine)

PROMPT = np.array([5, 17, 42, 7, 99], np.int32)


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = jget(arch).reduced()
    jp = jt.init_params(cfg, jax.random.PRNGKey(0))
    return jp, tt.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _engine(arch, packed=False, **ecfg):
    tp = _params(arch)[1]
    return ServeEngine(tget(arch).reduced(),
                       tq.quantize_params(tp) if packed else tp,
                       EngineConfig(**ecfg))


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
    ("gemma-2b", True)])
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


def test_serve_main_runs_to_the_end(tmp_path, capsys):
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
    assert "kernels" not in snap   # no kernel-dispatch profiler yet


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
