"""Shared plumbing of the bench twins (the counterpart of the JAX package's
`benchmarks/common.py`): `timed`, `write_json`, `regression_report`,
`fmt_table`, a device timer and the card's peak rates (from
`repro_torch.analysis.roofline`)."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

# the card's peaks, defined once in `analysis.roofline`: HBM3, dense bf16 on
# the tensor cores, fp32 on the CUDA cores
from repro_torch.analysis.roofline import HBM_BW as PEAK_HBM_BYTES
from repro_torch.analysis.roofline import PEAK_FLOPS as PEAK_BF16_FLOPS
from repro_torch.analysis.roofline import PEAK_FP32_FLOPS  # noqa: F401

ROOT = Path(__file__).resolve().parents[3]

WINDOWS = 5   # profiler windows a device timing may take before it fails


def retake_wait(attempt: int) -> None:
    """Wait before profiler window ``attempt`` (from 0): none before the
    first, then 0.5, 1, 2 and 4 s.  The profiler on the card's machine now
    and then loses every event of the windows of a short span, so the
    retakes are spread over some 7.5 s rather than 2."""
    if attempt:
        time.sleep(0.5 * 2 ** (attempt - 1))


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e6  # µs


def bound_us(nbytes: int, flops: int, peak_flops: float = PEAK_BF16_FLOPS
             ) -> tuple[float, str]:
    """The least time the card could take: the larger of ``nbytes`` at the
    HBM rate and ``flops`` at ``peak_flops`` → (µs, "bytes"|"operations")."""
    b_us, f_us = nbytes / PEAK_HBM_BYTES * 1e6, flops / peak_flops * 1e6
    return max(b_us, f_us), ("operations" if f_us >= b_us else "bytes")


def _device_kernels(fn, reps: int) -> list[float]:
    """µs of each CUDA kernel of ``reps`` calls of ``fn`` in one
    `torch.profiler` window, which opens with a throwaway fill kernel (the
    profiler may drop an event at its edge; the fill is left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda")
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and "FillFunctor" not in e.name]


def device_us(fn, device, reps: int = 5) -> float:
    """µs a call of ``fn`` after one warm-up call.  On a CUDA device: the
    device time, the sum of the call's kernels in a `torch.profiler` window
    over ``reps`` calls; a window that lost kernel events (a count that is
    not a non-zero multiple of ``reps``) is taken again after a wait
    (`retake_wait`), up to ``WINDOWS`` windows, then it raises.  On the
    CPU: the host-clock mean."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    seen = []
    for attempt in range(WINDOWS):
        retake_wait(attempt)
        kern = _device_kernels(fn, reps)
        if kern and len(kern) % reps == 0:
            return sum(kern) / reps
        seen.append(len(kern))
    raise RuntimeError(f"the profiler lost kernel events in {WINDOWS} "
                       f"windows (saw {seen} kernels for {reps} calls)")


def timer_name(device) -> str:
    return ("device time by torch.profiler"
            if torch.device(device).type == "cuda" else "host clock")


def card_name(device) -> str:
    return (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else "cpu")


def write_json(filename: str, payload: dict, root=None) -> str:
    """Persist a bench's result dict (e.g. ``BENCH_torch_conv.json``) at the
    repository root, or under ``root`` when given.  When a previous run
    exists there, prints a per-row timing delta table (flagging >1.3×
    slowdowns) before overwriting.  Returns the path written."""
    base = Path(root) if root is not None else ROOT
    base.mkdir(parents=True, exist_ok=True)
    path = base / filename
    prev = None
    if path.exists():
        try:
            prev = json.loads(path.read_text())
        except (OSError, ValueError):
            prev = None
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    if prev is not None:
        report = regression_report(prev, payload, name=filename)
        if report:
            print(report)
    return str(path)


SLOWDOWN_FLAG_X = 1.3

_ID_FIELDS = ("net", "layer", "name", "case", "shape")


def _row_id(row: dict) -> tuple:
    return tuple(str(row[k]) for k in _ID_FIELDS if k in row)


def regression_report(prev: dict, new: dict, *, name: str = "",
                      threshold: float = SLOWDOWN_FLAG_X) -> str:
    """Per-row delta table between two bench payloads.

    Matches ``rows`` entries by their identity fields and compares every
    ``*_us`` timing column; ratios above ``threshold`` are flagged.
    Returns "" when there is nothing comparable."""
    prev_rows = {_row_id(r): r for r in prev.get("rows", [])
                 if isinstance(r, dict)}
    deltas, flagged = [], 0
    for row in new.get("rows", []):
        if not isinstance(row, dict):
            continue
        old = prev_rows.get(_row_id(row))
        if old is None:
            continue
        for col, val in row.items():
            if not col.endswith("_us") or not isinstance(val, (int, float)):
                continue
            was = old.get(col)
            if not isinstance(was, (int, float)) or was <= 0:
                continue
            ratio = val / was
            flag = f"SLOW>{threshold}x" if ratio > threshold else ""
            flagged += bool(flag)
            deltas.append({"row": ":".join(_row_id(row)) or "-", "col": col,
                           "prev_us": round(was, 1), "now_us": round(val, 1),
                           "ratio_x": round(ratio, 2), "flag": flag})
    if not deltas:
        return ""
    head = f"Δ vs previous {name or 'run'}".rstrip()
    tail = (f"{flagged} column(s) regressed more than {threshold}x"
            if flagged else "no timing regressions above threshold")
    return "\n".join([head, fmt_table(
        deltas, ["row", "col", "prev_us", "now_us", "ratio_x", "flag"]),
        tail])


def fmt_table(rows: list[dict], cols: list[str]) -> str:
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    line = " | ".join(c.ljust(widths[c]) for c in cols)
    sep = "-+-".join("-" * widths[c] for c in cols)
    body = "\n".join(" | ".join(str(r.get(c, "")).ljust(widths[c])
                                for c in cols) for r in rows)
    return f"{line}\n{sep}\n{body}"
