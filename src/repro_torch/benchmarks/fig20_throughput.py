"""Fig. 20 — PE count vs utilization vs throughput against VWA [15].  The
twin of the JAX package's `benchmarks/fig20_throughput.py`, over the port's
`core/accelerator.run_network` and `core/cost_model.py`: analytic, it
touches no device and writes no JSON.

Paper: NeuroMAX at 122 cost-adjusted PEs delivers 307.8 / 281.8 / 268.92
GOPS for VGG16 / ResNet-34 / MobileNet (85 / 79.4 / 77.4 % more than [15]
at 168 PEs), with similar utilization."""

from __future__ import annotations

from repro_torch.core.accelerator import run_network
from repro_torch.core.cost_model import cost_adjusted_pe_count

from .common import fmt_table

# [15] (VWA, Chang & Chang 2020) figures quoted by the paper, at 200 MHz
VWA = {"vgg16": (0.99, 166.32), "resnet34": (0.934, 156.91),
       "mobilenet_v1": (0.902, 151.54)}
PAPER_GOPS = {"vgg16": 307.8, "resnet34": 281.8, "mobilenet_v1": 268.92}


def run(device=None, root=None) -> dict:
    """``device`` and ``root`` are the twins' common signature: unused."""
    rows = []
    for net, (vwa_util, vwa_gops) in VWA.items():
        perf = run_network(net)
        ours = perf.throughput_gops_paper
        rows.append({
            "network": net,
            "ours_util_%": round(perf.mean_layer_utilization * 100, 1),
            "ours_GOPS": round(ours, 1),
            "paper_GOPS": PAPER_GOPS[net],
            "vwa[15]_GOPS": vwa_gops,
            "gain_vs_vwa_%": round((ours / vwa_gops - 1) * 100, 1),
        })
    print(fmt_table(rows, list(rows[0])))
    pes = cost_adjusted_pe_count()
    print(f"PE count: {pes} cost-adjusted vs 168 in [15] "
          f"({(1 - pes/168)*100:.0f}% fewer)")
    ok = all(abs(r["ours_GOPS"] - r["paper_GOPS"]) / r["paper_GOPS"] < 0.04
             for r in rows) and all(r["gain_vs_vwa_%"] > 70 for r in rows)
    print("paper claims (GOPS ±4%, ≥77% gain over [15]):",
          "REPRODUCED" if ok else "FAIL")
    return {"rows": rows, "adjusted_pes": pes, "ok": ok}
