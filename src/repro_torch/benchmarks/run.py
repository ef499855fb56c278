"""Run the bench twins: every bench of the JAX package's `benchmarks/`,
the paper's figures and tables and the kernel and telemetry benches.

    python -m repro_torch.benchmarks.run [--only fig19_utilization ...]
    PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu

On the card (the default) the twins that write JSON write
``BENCH_torch_<name>.json`` at the repository root; with ``--device cpu``
under ``results/bench_torch_cpu/`` (git-ignored), since a CPU run is no
figure of the card's.  ``--out DIR`` writes under DIR either way.  The five
analytic paper benches (Fig. 17, 19, 20, Tables 2, 3) touch no device and
write no JSON, as in JAX.  Prints each bench's table, then a
``name,us_per_call,derived`` summary with REPRODUCED/FAIL for the paper
benches and OK/FAIL for the others.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core.device import resolve_device

from . import (ablation_grad_compress, attention_kernels, conv_kernels,
               fig1_quant, fig17_pe_cost, fig19_utilization, fig20_throughput,
               table2_comparison, table3_latency, telemetry_overhead)
from .common import ROOT, timed

BENCHES = {
    "fig1_quant": (fig1_quant, "snr_gain_db"),
    "conv_kernels": (conv_kernels, "mean_kernel_overhead_x"),
    "attention_kernels": (attention_kernels, "min_gqa4_traffic_win_x"),
    "fig17_pe_cost": (fig17_pe_cost, "tput_per_pe"),
    "fig19_utilization": (fig19_utilization, None),
    "fig20_throughput": (fig20_throughput, "adjusted_pes"),
    "table2_comparison": (table2_comparison, "peak_gops"),
    "table3_latency": (table3_latency, "total_ms"),
    "ablation_grad_compress": (ablation_grad_compress, "ef_gap"),
    "telemetry_overhead": (telemetry_overhead, "overhead_pct"),
}

# the paper's figures and tables and the ablation, whose verdict reads
# REPRODUCED/FAIL
PAPER_BENCHES = ("fig1_quant", "fig17_pe_cost", "fig19_utilization",
                 "fig20_throughput", "table2_comparison", "table3_latency",
                 "ablation_grad_compress")

ALIASES = {"conv": "conv_kernels",  # short names accepted by --only
           "attention": "attention_kernels",
           "telemetry": "telemetry_overhead"}


def main(argv=None, results: dict | None = None) -> int:
    """The CLI; a ``results`` dict receives each bench's result dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*",
                    choices=list(BENCHES) + list(ALIASES))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=None,
                    help="directory for the BENCH_torch_*.json (default: "
                         "the repository root on the card, "
                         "results/bench_torch_cpu on the CPU)")
    ap.add_argument("--img", type=int, default=conv_kernels.IMG,
                    help="image size of the conv bench's layers")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = args.out
    if out is None and dev.type != "cuda":
        out = ROOT / "results" / "bench_torch_cpu"
    names = [ALIASES.get(n, n) for n in (args.only or list(BENCHES))]

    summary, ok_all, paper_ok = [], True, True
    for name in names:
        mod, key = BENCHES[name]
        print(f"\n=== {name} " + "=" * max(0, 60 - len(name)))
        kw = {"img": args.img} if mod is conv_kernels else {}
        res, us = timed(lambda: mod.run(device=dev, root=out, **kw))
        if results is not None:
            results[name] = res
        ok = bool(res.get("ok"))
        derived = f"{res.get(key):.4g}" if key and res.get(key) is not None \
            else ("ok" if ok else "fail")
        ok_all &= ok
        if name in PAPER_BENCHES:
            paper_ok &= ok
            verdict = "REPRODUCED" if ok else "FAIL"
        else:
            verdict = "OK" if ok else "FAIL"
        summary.append(f"{name},{us:.0f},{derived} [{verdict}]")

    print("\nname,us_per_call,derived")
    for line in summary:
        print(line)
    if any(n in PAPER_BENCHES for n in names):
        print(f"\npaper benches: "
              f"{'ALL PAPER CLAIMS REPRODUCED' if paper_ok else 'SOME FAILED'}")
    print(f"\noverall: {'ALL OK' if ok_all else 'SOME FAILED'}")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
