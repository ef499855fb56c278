"""The output check's readings: the program's on a dozen seeds or more and
the control's on three or more, each a short run of the cell at its own
size, in one process.  Not part of a benchmark run.

The control is the reference put in the program's place and computed one
precision below the configuration's float32: every product on TF32
operands, the quantizer in bfloat16.  The limits in each configuration's
``limits`` lie between the program's largest reading and the control's
smallest.

    python bench/control.py --workload vgg16.ms8 --seconds 2 \\
        --seeds 11 12 13 --control-seeds 21 22 23 --out FILE
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


class ControlProgram:
    """The reference at `reference.check.CONTROL` precision, with the
    program's interface: ``forward`` and ``capture``."""

    def __init__(self, config: dict, weights: dict, precision=None):
        from reference import check
        self._check, self.config, self.weights = check, config, weights
        self.precision = precision or check.CONTROL
        self._record = None

    def forward(self, x):
        return self._check.reference_forward(
            self.config, self.weights, x, self.precision, record=self._record)

    @contextlib.contextmanager
    def capture(self, record: dict):
        self._record = record
        try:
            yield record
        finally:
            self._record = None


def readings(cell, seeds, seconds, device, precision=None) -> list[dict]:
    """Each seed's checked numbers: a run of the program, or with the
    reference at ``precision`` in its place."""
    import harness
    import program
    real = program.Program
    control = precision is not None
    out = []
    try:
        if control:
            program.Program = lambda c, w: ControlProgram(c, w, precision)
        for seed in seeds:
            r = harness.run_cell(cell, seed, seconds, False, device,
                                 time.perf_counter())
            out.append({"seed": seed, "correct": r["correct"],
                        **{k: c["value"] for k, c in r["checks"].items()}})
            harness.log(f"{'control' if control else 'program'} seed {seed}:"
                        f" {out[-1]}")
    finally:
        program.Program = real
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--precision", default="control",
                    choices=("control", "tf32", "bf16_quant"),
                    help="the control's precision: "
                    "both steps down (the control), or only one of them")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import harness
    import torch
    from reference import check
    prec = check.PRECISIONS[args.precision]
    cell = harness.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                        args.workload, ROOT)
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    res = {"workload": args.workload,
           "device": torch.cuda.get_device_name(dev),
           "precision": args.precision,
           "program": readings(cell, args.seeds, args.seconds, dev),
           "control": readings(cell, args.control_seeds, args.seconds, dev,
                                prec)}
    for side in ("program", "control"):
        for k in ("conv_gap", "act_mismatch", "logit_gap"):
            vals = [r[k] for r in res[side] if r[k] is not None]
            harness.log(f"{side} {k}: min {min(vals, default=None)!r} "
                        f"max {max(vals, default=None)!r} "
                        f"(None = inf: {sum(r[k] is None for r in res[side])})")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
