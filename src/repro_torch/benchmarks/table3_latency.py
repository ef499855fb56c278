"""Table 3 — VGG16 layer-by-layer latency.  The twin of the JAX package's
`benchmarks/table3_latency.py`, over the port's
`core/accelerator.run_network`: analytic, it touches no device and writes
no JSON.

Paper totals: NeuroMAX 240.23 ms, [7] 3755.3 ms, [15] 457.5 ms (after the
paper's 200 MHz normalisation of [15]).  The dataflow model reproduces the
per-layer NeuroMAX column; the conv1_1 anomaly (the paper reports 1.35 ms,
which implies 2× the per-thread rate of every other layer) is flagged
rather than overfit."""

from __future__ import annotations

from repro_torch.core.accelerator import run_network

from .common import fmt_table

PAPER = {  # ms
    "CONV1_1": 1.35, "CONV1_2": 28.9, "CONV2_1": 14.4, "CONV2_2": 29.26,
    "CONV3_1": 14.54, "CONV3_2": 28.6, "CONV3_3": 28.7, "CONV4_1": 14.4,
    "CONV4_2": 29.0, "CONV4_3": 29.5, "CONV5_1": 7.24, "CONV5_2": 7.23,
    "CONV5_3": 7.11,
}
PAPER_TOTAL = 240.23
PRIOR_TOTALS = {"[7]": 3755.3, "[15]": 457.5}


def run(device=None, root=None) -> dict:
    """``device`` and ``root`` are the twins' common signature: unused."""
    perf = run_network("vgg16")
    rows = []
    total = 0.0
    for lp in perf.layers:
        ours = lp.latency_ms
        total += ours
        paper = PAPER.get(lp.spec.name)
        rows.append({"layer": lp.spec.name, "ours_ms": round(ours, 2),
                     "paper_ms": paper,
                     "delta_%": round((ours / paper - 1) * 100, 1)
                     if paper else None})
    rows.append({"layer": "TOTAL", "ours_ms": round(total, 2),
                 "paper_ms": PAPER_TOTAL,
                 "delta_%": round((total / PAPER_TOTAL - 1) * 100, 1)})
    print(fmt_table(rows, ["layer", "ours_ms", "paper_ms", "delta_%"]))
    for ref, t in PRIOR_TOTALS.items():
        print(f"vs {ref}: {(1 - total / t) * 100:.0f}% lower latency "
              f"(paper: {(1 - PAPER_TOTAL / t) * 100:.0f}%)")
    # aggregate within ±4 %; non-anomalous layers within ±3 %
    layer_ok = all(abs(r["delta_%"]) <= 3.0 for r in rows[1:-1]
                   if r["paper_ms"])
    ok = abs(total / PAPER_TOTAL - 1) < 0.04 and layer_ok
    print("paper claims (total ±4%, layers ±3% except conv1_1):",
          "REPRODUCED" if ok else "FAIL")
    return {"rows": rows, "total_ms": total, "ok": ok}
