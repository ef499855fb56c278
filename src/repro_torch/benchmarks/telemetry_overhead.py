"""Telemetry overhead probe: the disabled path's cost must stay in the
noise.  The twin of the JAX package's `benchmarks/telemetry_overhead.py`.

    python -m repro_torch.benchmarks.run --only telemetry_overhead  # card
    PYTHONPATH=src python -m repro_torch.benchmarks.run \
        --only telemetry_overhead --device cpu

  1. engine A/B: decode-step time of a `ServeEngine` over JAX's tiny
     gemma-2b with ``telemetry="off"`` (hooks bypassed, the control)
     against ``telemetry="auto"`` with every obs gate forced off (the
     shipping default), as the minimum over alternating trials.  ``ok``
     holds the JAX bench's gate: < 3 % overhead;
  2. the disabled costs of `span()`, `instant()` and the profiler gate;
  3. on a CUDA device, the decode step with the kernel-dispatch profiler on
     as well (its CUDA events are the port's own cost; informational);
  4. an enabled run (tracer and profiler on, informational) that exports
     ``trace.json`` and ``metrics_snapshot.json`` under
     ``<root>/telemetry_torch/`` (``root`` defaults to the repository's
     git-ignored ``results/``).

Times are host clock: a decode step ends in a device synchronisation (the
sampled tokens are read back).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer
from repro_torch.obs import kernel_profile as kprof
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

from .common import ROOT, card_name, fmt_table, write_json

OVERHEAD_THRESHOLD_PCT = 3.0


def _small_model(dev):
    cfg = get_config("gemma-2b").reduced(n_layers=2, vocab=64, d_model=16,
                                         d_ff=32, head_dim=8, n_heads=2)
    return cfg, transformer.init_params(cfg, 0, device=dev)


def _make_engine(cfg, params, mode):
    return ServeEngine(cfg, params, EngineConfig(
        max_batch=4, max_prompt=16, max_len=4096, telemetry=mode))


def _feed(eng, cfg, n=4, max_new=10**6, seed=0):
    rng = np.random.default_rng(seed)
    for uid in range(n):
        T = int(rng.integers(2, 6))
        eng.submit(Request(
            uid=uid, prompt=rng.integers(1, cfg.vocab, size=T)
            .astype(np.int32), max_new_tokens=max_new))


def _time_steps(eng, steps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    return (time.perf_counter() - t0) / steps * 1e6  # µs/step


def _disabled_ns(fn, n=50_000) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def run(device=None, root=None, steps: int = 20, trials: int = 5) -> dict:
    dev = resolve_device(device)
    cfg, params = _small_model(dev)
    art_dir = Path(root if root is not None else ROOT / "results") \
        / "telemetry_torch"
    try:
        out = _run(dev, cfg, params, steps, trials, art_dir)
    finally:
        obs_trace.set_enabled(None)
        kprof.set_enabled(None)
    write_json("BENCH_torch_telemetry.json", out, root)
    return out


def _run(dev, cfg, params, steps, trials, art_dir) -> dict:
    # ------------------------------------------------- A/B: off vs auto-off
    # every obs gate forced off, so "auto" measures the shipping default
    # even if the environment carries REPRO_TRACE
    obs_trace.set_enabled(False)
    kprof.set_enabled(False)
    engines = {}
    for mode in ("off", "auto"):
        eng = _make_engine(cfg, params, mode)
        _feed(eng, cfg)
        _time_steps(eng, 10)                       # build + warm
        engines[mode] = eng
    trial_us = {m: [] for m in engines}
    for _ in range(trials):
        for mode, eng in engines.items():          # alternate modes
            trial_us[mode].append(_time_steps(eng, steps))
    best = {m: min(v) for m, v in trial_us.items()}
    overhead_pct = (best["auto"] / best["off"] - 1.0) * 100.0

    # ----------------------------------------- disabled primitive costs
    span_ns = _disabled_ns(lambda: obs_trace.span("x"))
    instant_ns = _disabled_ns(lambda: obs_trace.instant("x"))
    gate_ns = _disabled_ns(kprof.enabled)

    # ------------------- the profiler's own cost on the card (informational)
    profiled_us = None
    if dev.type == "cuda":
        kprof.set_enabled(True)
        kprof.clear()
        _time_steps(engines["auto"], 10)
        profiled_us = min(_time_steps(engines["auto"], steps)
                          for _ in range(3))
        kprof.set_enabled(False)
        kprof.clear()

    # -------------------------- enabled run (informational) + artifacts
    obs_trace.set_enabled(True)
    kprof.set_enabled(True)
    obs_trace.clear()
    kprof.clear()
    eng_on = _make_engine(cfg, params, "auto")
    # max_new outlasts the timed steps (100 at JAX's 20 steps a trial)
    _feed(eng_on, cfg, max_new=40 + 3 * steps, seed=1)
    _time_steps(eng_on, 10)
    on_us = min(_time_steps(eng_on, steps) for _ in range(3))
    eng_on.run(max_iters=200)                      # retire → tokens/s rows
    art_dir.mkdir(parents=True, exist_ok=True)
    obs_trace.export_chrome_trace(str(art_dir / "trace.json"))
    snap = eng_on.metrics_snapshot()
    with open(art_dir / "metrics_snapshot.json", "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True, default=str)
        f.write("\n")
    obs_trace.clear()
    kprof.clear()

    ok = overhead_pct < OVERHEAD_THRESHOLD_PCT
    rows = [
        {"case": "engine_off", "steady_us": best["off"],
         "note": "no-telemetry control"},
        {"case": "engine_auto_disabled", "steady_us": best["auto"],
         "note": f"overhead {overhead_pct:+.2f}% (limit "
                 f"{OVERHEAD_THRESHOLD_PCT}%)"},
        {"case": "engine_profiled", "steady_us": profiled_us,
         "note": "kernel profiler on (CUDA events a dispatch), "
                 "informational; card only"},
        {"case": "engine_traced", "steady_us": on_us,
         "note": "REPRO_TRACE=1 path (tracer and profiler), informational"},
        {"case": "span_disabled", "steady_us": span_ns / 1e3,
         "note": f"{span_ns:.0f} ns/call"},
        {"case": "instant_disabled", "steady_us": instant_ns / 1e3,
         "note": f"{instant_ns:.0f} ns/call"},
        {"case": "profiler_gate", "steady_us": gate_ns / 1e3,
         "note": f"{gate_ns:.0f} ns/check"},
    ]
    print(fmt_table([{k: (f"{v:.4g}" if isinstance(v, float) else v)
                      for k, v in r.items()} for r in rows],
                    ["case", "steady_us", "note"]))
    print(f"telemetry-disabled overhead: {overhead_pct:+.2f}% "
          f"({'OK' if ok else 'FAIL'}, limit {OVERHEAD_THRESHOLD_PCT}%)")
    return {"rows": rows, "overhead_pct": overhead_pct,
            "threshold_pct": OVERHEAD_THRESHOLD_PCT,
            "trials_us": trial_us, "steps": steps,
            "span_disabled_ns": span_ns, "instant_disabled_ns": instant_ns,
            "profiler_gate_ns": gate_ns,
            "profiled_overhead_pct": (None if profiled_us is None else
                                      (profiled_us / best["off"] - 1) * 100),
            "kernel_records": len(snap["kernels"]["records"]),
            "artifacts": [f"{art_dir.name}/{n}" for n in
                          ("trace.json", "metrics_snapshot.json")],
            "timer": "host clock", "card": card_name(dev), "ok": bool(ok)}
