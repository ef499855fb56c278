"""Table 2 — comparison with previous designs.  The twin of the JAX
package's `benchmarks/table2_comparison.py`: analytic, it touches no device
and writes no JSON.

The numbers for prior accelerators are the paper's own reported values
(literature constants, not things one can re-measure; this module keeps its
own copy); the NeuroMAX column is *computed* from the port's models: peak
throughput from the grid geometry, PE count from the cost model."""

from __future__ import annotations

from repro_torch.core.cost_model import (N_PES, N_THREADS, TOTAL_ACCEL_LUTS,
                                         cost_adjusted_pe_count,
                                         peak_throughput_per_pe)
from repro_torch.core.dataflow import (CLOCK_HZ, PEAK_GOPS_PAPER,
                                       PEAK_OPS_PER_CYCLE)

from .common import fmt_table

PRIOR = [
    {"design": "[7] Eyeriss", "PEs": 168, "peak_GOPS": 84.0,
     "tput/PE": 0.5},
    {"design": "[8] Zynq-7100", "PEs": 1926, "peak_GOPS": 17.11,
     "tput/PE": 0.008},
    {"design": "[9] Arria-10", "PEs": 1278, "peak_GOPS": 170.6,
     "tput/PE": 0.13},
    {"design": "[10] Eyeriss v2", "PEs": 192, "peak_GOPS": 153.6,
     "tput/PE": 0.8},
    {"design": "[15] VWA", "PEs": 168, "peak_GOPS": 168.0, "tput/PE": 1.0},
]


def run(device=None, root=None) -> dict:
    """``device`` and ``root`` are the twins' common signature: unused."""
    # Table 2 uses the paper's own accounting (Fig-20/Table-2 rows are
    # exactly util × 324 GOPS): 324 thread-MACs/cycle ≡ "324 GOPS".  The
    # plain-physics number (324 × 200 MHz = 64.8 GMAC/s) is reported by
    # NetworkPerf.gmacs_per_s; comparisons here stay in paper units.
    peak = PEAK_GOPS_PAPER
    pes = cost_adjusted_pe_count()
    tput_pe = peak_throughput_per_pe()
    ours = {"design": "NeuroMAX (ours)", "PEs": pes,
            "peak_GOPS": round(peak, 1), "tput/PE": round(tput_pe, 2)}
    rows = [ours] + PRIOR
    print(fmt_table(rows, ["design", "PEs", "peak_GOPS", "tput/PE"]))
    best_prior = max(p["tput/PE"] for p in PRIOR)
    print(f"peak {peak:.0f} GOPS (paper accounting) from {N_PES} PEs × "
          f"{N_THREADS} threads = {PEAK_OPS_PER_CYCLE} threads @ "
          f"{CLOCK_HZ/1e6:.0f} MHz; LUTs {TOTAL_ACCEL_LUTS/1e3:.1f}k")
    ok = abs(peak - 324.0) < 1e-6 and pes == 122 and \
        tput_pe > 2.5 * best_prior
    print("paper claims (324 GOPS, 122 PEs, ≥2.5× best prior tput/PE):",
          "REPRODUCED" if ok else "FAIL")
    return {"rows": rows, "peak_gops": peak, "ok": ok}
