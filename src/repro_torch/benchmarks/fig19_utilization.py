"""Fig. 19 — layer-by-layer hardware (thread) utilization for VGG-16,
MobileNet v1 and ResNet-34 on the 6×3×6 grid + 2D weight-broadcast
dataflow.  Paper averages: 95 % / 84 % / 86 %.  The twin of the JAX
package's `benchmarks/fig19_utilization.py`, over the port's
`core/accelerator.run_network`: analytic, it touches no device and writes
no JSON."""

from __future__ import annotations

from repro_torch.core.accelerator import run_network

from .common import fmt_table

PAPER_AVG = {"vgg16": 0.95, "mobilenet_v1": 0.84, "resnet34": 0.86}


def run(device=None, root=None) -> dict:
    """``device`` and ``root`` are the twins' common signature: unused."""
    summary = []
    per_layer = {}
    for net, paper in PAPER_AVG.items():
        perf = run_network(net)
        util = perf.mean_layer_utilization
        summary.append({"network": net, "layers": len(perf.layers),
                        "mean_util_%": round(util * 100, 1),
                        "paper_%": paper * 100,
                        "delta_pp": round((util - paper) * 100, 1)})
        per_layer[net] = [round(lp.utilization * 100, 1)
                          for lp in perf.layers]
    print(fmt_table(summary, list(summary[0])))
    print("VGG16 per-layer util %:", per_layer["vgg16"])
    # first VGG16 layer: paper says exactly 50% (3 of 6 PE matrices idle)
    first = per_layer["vgg16"][0]
    ok = all(abs(r["delta_pp"]) <= 2.5 for r in summary) and first <= 51.0
    print("paper claims (±2.5 pp, conv1_1 ≈ 50%):",
          "REPRODUCED" if ok else "FAIL")
    return {"rows": summary, "per_layer": per_layer, "ok": ok}
