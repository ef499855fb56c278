"""One run of one cell of `BENCHMARK.json`, driven by its data.

A cell names a configuration (``configs[].file``) and a traffic mix
(``bench/traffic/<traffic>.json``); its end-to-end metrics are read by
``bench/end_to_end/<name>.py`` and its per-layer metrics by
``bench/layer_metrics/<name>.py``, each a module with ``read(run)`` that
returns a number or None.  A later cell, mix or metric is a new file and a
new entry, found by its name.

A run: weights and a pool of images from the seed, on the card in a few
large calls; the program packs the weights; the loop warms up on the
cell's own batch; the timed window runs the loop for ``seconds``; with
``trace`` a profiled window follows; then the output check
(`reference.check`) replays a sample of the window's queries, drawn from
the seed, and holds them against the reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import costs
import loadgen
import traced
from reference import check as ref_check
from reference import cnn as ref_cnn

BENCH = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
BIAS_STD = 0.05


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is that of JAX or of the JAX
    package (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of `BENCHMARK.json` with its configuration, traffic and
    the metrics it reports."""

    def __init__(self, bench: dict, name: str, root: Path):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise ValueError(f"no workload {name!r} in BENCHMARK.json")
        w = found[0]
        self.name, self.chips = name, w["chips"]
        conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
        self.config = json.loads((root / conf["file"]).read_text())
        self.traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]


class Run:
    """What the metric readers read."""

    def __init__(self, cell: Cell):
        self.cell, self.config = cell, cell.config
        self.traffic = cell.traffic
        self.convs = costs.conv_shapes(cell.config, cell.traffic["batch"])
        self.setup_s = None
        self.window = None
        self.trace = None


def draw_weights(config: dict, gen: torch.Generator, device) -> dict:
    """Every weight of the plan from one normal draw on ``device``, in the
    plan's order, each scaled and shifted to the (mean, std) that its
    family gives it, or else to `default_init`'s."""
    shapes = ref_cnn.weight_shapes(config)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        w = flat[off:off + n].view(shape)
        off += n
        mean, std = (ref_cnn.weight_init(config, name, shape)
                     or default_init(name, shape))
        w.mul_(std)
        if mean:
            w.add_(mean)
        out[name] = w
    return out


def default_init(name: str, shape) -> tuple[float, float]:
    """Biases at ``BIAS_STD``, the head at std sqrt(1 / width), a K x K x
    I x O kernel He-normal (std sqrt(2 / (K K I))); mean 0."""
    if name.endswith(".b"):
        return 0.0, BIAS_STD
    if name == "head.w":
        return 0.0, (1.0 / shape[0]) ** 0.5
    return 0.0, (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5


def power_limit_w() -> float | None:
    """The card's power limit, which caps its clocks under load."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=60)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _finite(v):
    return v if v is not None and math.isfinite(v) else None


def replay(run: Run, prog, pool, seed: int, device) -> list:
    """A sample of the window's queries, drawn from the seed, run again on
    the program with each conv captured → [(query, capture)]."""
    win = run.window
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(win.done), replace=False,
                       size=min(run.traffic["check_queries"], len(win.done)))
    out = []
    for q in sorted(picks.tolist()):
        rec = {}
        with prog.capture(rec):
            prog.forward(pool[win.slot[q]].to(device))
        out.append((q, rec))
    return out


def check_outputs(run: Run, replays: list, weights, pool, device) -> dict:
    """The replayed queries against the reference, on images copied here
    → {number: worst value over the sample}."""
    win = run.window
    worst = {k: 0.0 for k in ref_check.NUMBERS}
    for q, rec in replays:
        images = pool[win.slot[q]].to(device)
        got = ref_check.compare(run.config, weights, images, rec,
                                win.logits[q])
        worst = {k: max(worst[k], got[k]) for k in worst}
        free = ref_check.reference_forward(run.config, weights, images)
        log(f"query {q}: {got}; logits from the images alone "
            f"(no stage-by-stage following) differ by "
            f"{ref_check.gap(win.logits[q].to(device), free):.4e} of max|l|")
    return worst


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float) -> dict:
    """One run; returns the result line's object."""
    import program

    def mark(what):
        log(f"at {time.perf_counter() - t0:.3f} s: {what}")
    mark("harness entered")
    config, traffic = cell.config, cell.traffic
    run = Run(cell)
    batch = traffic["batch"]
    if program.conv_shapes(config, batch) != sorted(
            (c["B"], c["H"], c["W"], c["C"], c["K"], c["Cout"], c["stride"],
             c["groups"]) for c in run.convs):
        raise ValueError(f"{config['name']}: the program's convs are not the "
                         f"configuration's")
    mark("shapes checked against the program's")
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = draw_weights(config, gen, device)
    pool = loadgen.make_pool(config, traffic, gen, device)
    mark("weights and images drawn")
    prog = program.Program(config, weights)
    mark("weights packed")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def loop(**kw):
        return loadgen.closed_loop(prog.forward, pool, device,
                                   traffic["in_flight"], **kw)

    loop(count=traffic["warmup_queries"])
    if cuda:
        torch.cuda.synchronize()
    mark("warmed up")
    log(f"autotune counters after warm-up: {program.autotune_counters()}")
    launches = program.b1_launches()
    collections = [g["collections"] for g in gc.get_stats()]
    start = time.perf_counter()
    run.setup_s = start - t0
    run.window = loop(until=start + seconds)
    per_fwd = (program.b1_launches() - launches) / max(len(run.window.done), 1)
    lat = run.window.latencies_ms()
    log(f"window: {len(run.window.done)} queries, {run.window.images} images "
        f"in {run.window.seconds:.4f} s; B1 launches a forward {per_fwd} "
        f"(convs {len(run.convs)}); latency ms p50 "
        f"{loadgen.percentile(lat, 50):.3f} p90 {loadgen.percentile(lat, 90):.3f}"
        f" p99 {loadgen.percentile(lat, 99):.3f} max {max(lat):.3f}; garbage "
        f"collections by generation "
        f"{[g['collections'] - c for g, c in zip(gc.get_stats(), collections)]}")
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": cell.chips}
    breakdown = None
    if trace:
        t, whole, lost = traced.traced_window(
            lambda span: loop(count=traffic["trace_queries"], span=span),
            program.b1_launches)
        if lost:
            log(f"profiler windows that lost conv-kernel events: saw {lost} "
                f"of {len(run.convs) * traffic['trace_queries']}")
        mark(f"traced window read ({len(t.kernels)} kernels)")
        run.trace = t if whole else None
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        breakdown = {"device_ops": [list(x) for x in t.device_ops()[:10]],
                     "idle_gaps": [list(x) for x in t.idle_gaps()[:10]]}
    device_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                        if cuda else 0)
    if cuda:
        device_info["power_limit_w"] = power_limit_w()
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = _finite(_module("layer_metrics" if trace else "end_to_end",
                            m["name"]).read(run))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    logits = torch.stack(run.window.logits) if run.window.logits else None
    failed = (len(run.window.issued) - len(run.window.done)
              + (0 if logits is None else
                 int((~torch.isfinite(logits)).flatten(1).any(1).sum())))
    replays = replay(run, prog, pool, seed, device)
    del prog, loop
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    mark("replayed for the check")
    worst = check_outputs(run, replays, weights, pool, device)
    mark("checked")
    limits = config["limits"]
    checks = {k: {"value": _finite(worst[k]), "limit": limits[k]}
              for k in ref_check.NUMBERS}
    correct = (failed == 0 and bool(run.window.done)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    out = {"correct": correct, "attempted": len(run.window.issued),
           "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
