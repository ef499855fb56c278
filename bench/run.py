"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python bench/run.py --workload vgg16.ms8 --seed 7 --seconds 20 --trace 0

Run from the root of a checkout on a machine with the cell's cards.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled window.  The numbers
that decide ``correct`` close standard error, each beside its limit, and
the line's ``checks``.  Without a card, without the program beside the
benchmark, or with JAX or the JAX package loaded, it prints no result and
exits with another code than 0.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the interpreter's bytecode goes to a fixed directory of the checkout:
    # where the installed packages hold none (and none may be written
    # beside them), every run would compile torch from source, which took
    # most of set-up and varied with the host's load
    state = BENCH / ".state"
    sys.pycache_prefix = str(state / "pycache")
    sys.dont_write_bytecode = False
    # the program's user autotune tier points at a file that no run writes,
    # so every run sees the packaged tier only; its own tracing stays off
    os.environ["REPRO_TORCH_AUTOTUNE_PATH"] = str(state / "autotune_user.json")
    (state / "autotune_user.json").unlink(missing_ok=True)
    for var in ("REPRO_TRACE", "REPRO_TRACE_PATH", "REPRO_KERNEL_PROFILE"):
        os.environ.pop(var, None)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    import harness
    import torch

    harness.log(f"at {time.perf_counter() - T0:.3f} s: torch imported")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    torch.cuda.init()
    harness.log(f"at {time.perf_counter() - T0:.3f} s: CUDA initialised")
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the run loaded JAX or the JAX package: {found}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # no exit handler may print after the checks
