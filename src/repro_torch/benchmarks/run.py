"""Run the bench twins: the kernel and telemetry benches of the JAX
package's `benchmarks/`, timed on the card.

    python -m repro_torch.benchmarks.run [--only conv_kernels ...]
    PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu

On the card (the default) each writes ``BENCH_torch_<name>.json`` at the
repository root; with ``--device cpu`` under ``results/bench_torch_cpu/``
(git-ignored), since a CPU run is no figure of the card's.  ``--out DIR``
writes under DIR either way.  Prints each bench's table, then a
``name,us_per_call,derived`` summary.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core.device import resolve_device

from . import attention_kernels, conv_kernels, telemetry_overhead
from .common import ROOT, timed

BENCHES = {
    "conv_kernels": (conv_kernels, "mean_kernel_overhead_x"),
    "attention_kernels": (attention_kernels, "min_gqa4_traffic_win_x"),
    "telemetry_overhead": (telemetry_overhead, "overhead_pct"),
}

ALIASES = {"conv": "conv_kernels",  # short names accepted by --only
           "attention": "attention_kernels",
           "telemetry": "telemetry_overhead"}


def main(argv=None) -> int:
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

    summary, ok_all = [], True
    for name in names:
        mod, key = BENCHES[name]
        print(f"\n=== {name} " + "=" * max(0, 60 - len(name)))
        kw = {"img": args.img} if mod is conv_kernels else {}
        res, us = timed(lambda: mod.run(device=dev, root=out, **kw))
        derived = f"{res.get(key):.4g}" if res.get(key) is not None \
            else ("ok" if res.get("ok") else "fail")
        ok_all &= bool(res.get("ok"))
        summary.append(f"{name},{us:.0f},{derived} "
                       f"[{'OK' if res.get('ok') else 'FAIL'}]")

    print("\nname,us_per_call,derived")
    for line in summary:
        print(line)
    print(f"\noverall: {'ALL OK' if ok_all else 'SOME FAILED'}")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
