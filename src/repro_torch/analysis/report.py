"""The §Dry-run and §Roofline tables of dry-run records, and the rendering
of live-telemetry snapshots.  Counterpart of `repro.analysis.report`.

    PYTHONPATH=src python -m repro_torch.analysis.report --dir results/dryrun
    PYTHONPATH=src python -m repro_torch.analysis.report --metrics snap.json

``--metrics`` takes a JSON snapshot (`ServeEngine.metrics_snapshot()` or
the kernel profiler's `snapshot()`, e.g. from ``REPRO_KERNEL_PROFILE=1
python -m repro_torch.launch.serve ... --metrics-out snap.json``) and
prints the per-op utilization table: analytic bytes moved against the
achieved bandwidth, as a share of the H100's HBM rate
(`roofline.HBM_BW`), echoing the paper's per-layer utilization analysis
(§V) from *measured* dispatches.  A snapshot taken on the CPU holds host
times, so its column reads against the card's rate, not the CPU's.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

from ..configs.base import SHAPES
from ..configs.registry import ARCH_NAMES
from .roofline import HBM_BW, from_record, load_records


def dryrun_table(recs: list[dict]) -> str:
    """One row per (arch, shape): single- and multi-pod status + memory."""
    by_key = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    lines = [
        "| arch | shape | step | 1-pod (256c) | GiB/dev | 2-pod (512c) | "
        "GiB/dev | collectives (1-pod, per unit-iter) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            s = by_key.get((arch, shape, "single"))
            m = by_key.get((arch, shape, "multi"))
            if s is None:
                continue
            if s.get("skipped"):
                lines.append(f"| {arch} | {shape} | — | skipped "
                             f"(full-attention @500k) | | skipped | | |")
                continue

            def fmt(r):
                if r is None:
                    return "—", ""
                if "error" in r:
                    return "FAIL", ""
                mem = (r["memory"]["temp_bytes"]
                       + r["memory"]["argument_bytes"]) / 2**30
                return "ok", f"{mem:.1f}"

            s_st, s_mem = fmt(s)
            m_st, m_mem = fmt(m)
            cc = s.get("collectives_prod_once", {}).get("counts", {})
            cstr = " ".join(f"{k.split('-')[-1][:4]}:{v}"
                            for k, v in sorted(cc.items()))
            lines.append(f"| {arch} | {shape} | {s.get('step_kind','')} "
                         f"| {s_st} | {s_mem} | {m_st} | {m_mem} | {cstr} |")
    return "\n".join(lines)


def _single_rooflines(recs: list[dict]):
    """`from_record` of each single-mesh record that has costs."""
    return [from_record(rec) for rec in recs
            if rec.get("mesh") == "single" and not rec.get("skipped")
            and "cost_true" in rec]


def roofline_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | t_comp ms | t_mem ms | t_coll ms | bound | "
        "useful | roofline-MFU | GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in _single_rooflines(recs):
        lines.append(
            f"| {r.arch} | {r.shape} | {r.t_compute*1e3:.2f} "
            f"| {r.t_memory*1e3:.2f} | {r.t_collective*1e3:.2f} "
            f"| {r.bottleneck[:4]} | {r.useful_flops_ratio:.2f} "
            f"| {r.mfu*100:.1f}% | {r.memory_per_dev/2**30:.1f} |")
    return "\n".join(lines)


def summary(recs: list[dict]) -> str:
    n_ok = sum(1 for r in recs if "error" not in r and not r.get("skipped"))
    n_skip = sum(1 for r in recs if r.get("skipped"))
    n_fail = sum(1 for r in recs if "error" in r)
    bounds = defaultdict(int)
    worst = []
    for r in _single_rooflines(recs):
        bounds[r.bottleneck] += 1
        worst.append((r.mfu, f"{r.arch}/{r.shape}"))
    worst.sort()
    out = [f"- {n_ok} compiled ok, {n_skip} skipped (per assignment), "
           f"{n_fail} failed",
           f"- bottleneck split: {dict(bounds)}",
           f"- lowest roofline-MFU cells: "
           + ", ".join(f"{n} ({m*100:.1f}%)" for m, n in worst[:3])]
    return "\n".join(out)


def _fmt_bytes(n) -> str:
    if n >= 2**20:
        return f"{n/2**20:.2f} MiB"
    return f"{n/2**10:.1f} KiB"


def per_op_utilization_table(snap: dict) -> str:
    """Per-dispatch utilization rows from a telemetry snapshot: analytic
    bytes moved (the paper's traffic accounting) over measured steady time
    → achieved GB/s, as a fraction of the HBM roofline."""
    recs = snap.get("kernels", snap).get("records", [])
    lines = ["| op | impl | shape key | calls | bytes moved | steady µs | "
             "GB/s | %HBM roofline | timing |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["op"], r["impl"], r["key"])):
        total = (r.get("bytes") or {}).get("total", 0)
        calls = r.get("calls", 0) + r.get("traced_calls", 0)
        us = r.get("steady_us")
        if us:
            gbps = total / (us * 1e-6) / 1e9
            util = f"{100 * gbps * 1e9 / HBM_BW:.2f}%"
            us_s, gb_s = f"{us:.1f}", f"{gbps:.3f}"
        else:
            us_s, gb_s, util = "—", "—", "—"
        lines.append(f"| {r['op']} | {r['impl']} | `{r['key']}` | {calls} "
                     f"| {_fmt_bytes(total)} | {us_s} | {gb_s} | {util} "
                     f"| {r.get('steady_source') or '—'} |")
    return "\n".join(lines)


def _histogram_rows(hists: dict) -> str:
    lines = ["| metric | count | mean | p50 | p90 | p99 |",
             "|---|---|---|---|---|---|"]
    for name, h in sorted(hists.items()):
        lines.append(f"| {name} | {h['count']} | {h['mean']:.4g} "
                     f"| {h['p50']:.4g} | {h['p90']:.4g} | {h['p99']:.4g} |")
    return "\n".join(lines)


def metrics_report(snap: dict) -> str:
    """Full rendering of a telemetry snapshot: engine latency histograms,
    per-op utilization, program timings, autotune hit/miss."""
    out = ["## §Telemetry — per-op utilization (measured dispatches)", "",
           per_op_utilization_table(snap)]
    progs = snap.get("kernels", snap).get("programs", {})
    if progs:
        out += ["", "### Programs (the engine's timed prefill and decode "
                "calls)", "",
                "| program | calls | first (compile) µs | steady µs |",
                "|---|---|---|---|"]
        for name, p in sorted(progs.items()):
            steady = f"{p['steady_us']:.1f}" if p.get("steady_us") else "—"
            out.append(f"| {name} | {p['calls']} | {p['first_us']:.1f} "
                       f"| {steady} |")
    hists = snap.get("engine", {}).get("histograms", {})
    if hists:
        out += ["", "### Engine latency (seconds / tokens-per-s)", "",
                _histogram_rows(hists)]
    counters = snap.get("global", {}).get("counters", {})
    tuned = {k: v for k, v in counters.items() if "autotune" in k}
    if tuned:
        out += ["", "### Autotune table", ""]
        out += [f"- {k}: {v}" for k, v in sorted(tuned.items())]
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--out", default="")
    ap.add_argument("--metrics", default="",
                    help="telemetry snapshot JSON (metrics_snapshot()); "
                         "prints the per-op utilization report instead of "
                         "the dry-run tables")
    args = ap.parse_args(argv)
    if args.metrics:
        with open(args.metrics) as f:
            text = metrics_report(json.load(f))
    else:
        recs = load_records(args.dir)
        text = ("## §Dry-run\n\n" + summary(recs) + "\n\n"
                + dryrun_table(recs)
                + "\n\n## §Roofline (single-pod, 256 chips)"
                + "\n\n" + roofline_table(recs) + "\n")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
