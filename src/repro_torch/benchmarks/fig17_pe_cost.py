"""Fig. 17 — linear vs log PE LUT/FF cost at 16-bit output precision, and
the headline "200 % more peak throughput for 6 % area" claim.  The twin of
the JAX package's `benchmarks/fig17_pe_cost.py`, over the port's
`core/cost_model.py`: analytic, it touches no device and writes no JSON.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig17_pe_cost
"""

from __future__ import annotations

from repro_torch.core.cost_model import (area_overhead_vs_linear,
                                         cost_adjusted_pe_count,
                                         linear_pe_cost, log_pe_cost,
                                         peak_throughput_per_pe)

from .common import fmt_table


def run(device=None, root=None) -> dict:
    """``device`` and ``root`` are the twins' common signature: unused."""
    rows = []
    lin = linear_pe_cost()
    for threads in (1, 2, 3, 4):
        c = log_pe_cost(threads)
        rows.append({
            "PE": f"log({threads})",
            "LUTs_rel": round(c.luts / lin.luts, 3),
            "FFs_rel": round(c.ffs / lin.ffs, 3),
            "peak_OPS/cycle": threads,
        })
    rows.append({"PE": "linear", "LUTs_rel": 1.0, "FFs_rel": 1.0,
                 "peak_OPS/cycle": 1})
    print(fmt_table(rows, list(rows[0])))

    overhead = area_overhead_vs_linear(3)
    adj = cost_adjusted_pe_count()
    tput = peak_throughput_per_pe()
    print(f"3-thread log PE: area overhead {overhead*100:.1f}% "
          f"(paper: ≈6%), peak throughput/PE (adjusted) {tput:.2f} "
          f"(paper: 2.7), 108 PEs ≡ {adj} cost-adjusted (paper: 122)")
    ok = abs(overhead - 0.06) < 0.05 and adj == 122 and 2.5 < tput < 3.0
    print("paper claims:", "REPRODUCED" if ok else "FAIL")
    return {"rows": rows, "area_overhead": overhead,
            "adjusted_pes": adj, "tput_per_pe": tput, "ok": ok}
