"""Kernel-dispatch profiling: per-op records behind `kernels/ops.py`.

Counterpart of `repro.obs.kernel_profile`, with the same names and record
schema, so that one reader takes a snapshot of either package.  Every
dispatch through the port's ops (`log_matmul` / `conv2d` / `attention` /
`wkv6`) is recorded here when profiling is on: the op, the resolved impl,
the shape key (the namespaced key of `repro.kernels.autotune`'s format,
backend ``cuda`` or ``cpu``), the **analytic bytes moved** (from
`conv_traffic_bytes` / `attention_traffic_bytes` / the op's own formula)
and the time, split into the first call of a key and the steady calls
after it.

Three dispatch regimes:

  cuda     the op ran on CUDA tensors.  A `torch.cuda.Event` pair is
           recorded on the current stream around the call and kept
           pending beside the host start; no call synchronises.  Pending
           pairs are resolved by `snapshot()` (one synchronisation), or
           oldest first once more than ``MAX_PENDING`` wait, so memory
           stays bounded.  The time is stream time between the two
           events: the kernels of the call, and where the host is slower
           than the kernels, the wrapper's host time as well.  An op whose
           wrapper marks its launch (``marks_launch``: the conv kernel's)
           starts the pair at that mark, so its checks, geometry and
           allocations stay out of the time.  The first call of a key
           includes the kernel build at first use (the counterpart of
           JAX's compile-inclusive first call).
  cpu      the op ran on CPU tensors: timed by the host clock around the
           call (the CPU is synchronous).
  traced   the current CUDA stream is capturing a graph (`is_traced`):
           there is no per-op clock, so the record carries shape and bytes
           only, tagged with the enclosing **program** (`time_program`,
           e.g. the serving engine's "prefill"/"decode"); `snapshot()`
           gives such records their program's steady time.

A resolved time feeds the record's first/steady statistics, a trace span
(`TRACER.add_complete`, host start and measured duration, ``phase=
compile|steady``) and a ``kernel_dispatch_us`` histogram sample labelled
with op, impl and phase on `obs.metrics.REGISTRY`.

Gating mirrors the tracer: ``REPRO_KERNEL_PROFILE=1`` or ``REPRO_TRACE=1``
(a trace without kernel rows is half a trace), or `set_enabled(True)`.
While profiling is off the whole cost is one gate check per op: no key or
byte count is computed and no event is recorded.  The profiler never
catches an exception of the call it wraps.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

import torch

from . import metrics as _metrics
from . import trace as _trace

_OFF = ("", "0", "false", "off")
MAX_PENDING = 4096   # unresolved CUDA event pairs before the oldest resolve


def is_traced(*operands) -> bool:
    """True while the current CUDA stream captures a graph and an operand
    lies on the card: the op is being recorded, not run, so it has no
    clock of its own.  Always false on the CPU."""
    return (any(isinstance(x, torch.Tensor) and x.is_cuda for x in operands)
            and torch.cuda.is_current_stream_capturing())


def _new_entry(op, impl, key, bytes_moved):
    return {"op": op, "impl": impl, "key": key, "bytes": bytes_moved,
            "calls": 0, "traced_calls": 0, "first_us": None,
            "steady_n": 0, "steady_sum": 0.0, "steady_min": None,
            "program": None}


def _push_steady(ent, dt_us):
    ent["steady_n"] += 1
    ent["steady_sum"] += dt_us
    ent["steady_min"] = dt_us if ent["steady_min"] is None \
        else min(ent["steady_min"], dt_us)


def _cuda_device(tree):
    """The device of the first CUDA tensor in a result, or None."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for x in items:
        dev = _cuda_device(x)
        if dev is not None:
            return dev
    return None


class KernelProfiler:
    """Process-wide dispatch recorder used by `kernels/ops.py`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple, dict] = {}
        self._programs: dict[str, dict] = {}
        self._pending: deque = deque()
        self._local = threading.local()
        self._override: bool | None = None

    # ------------------------------------------------------------- gating
    def enabled(self) -> bool:
        if self._override is not None:
            return self._override
        if os.environ.get("REPRO_KERNEL_PROFILE", "0").lower() not in _OFF:
            return True
        return _trace.TRACER.enabled()

    def set_enabled(self, flag: bool | None) -> None:
        """True/False force; None defers to the env gates."""
        self._override = flag

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._programs.clear()
            self._pending.clear()

    # ----------------------------------------------------------- programs
    def current_program(self) -> str | None:
        return getattr(self._local, "program", None)

    def time_program(self, name: str, fn):
        """Run `fn` (one engine program: a prefill or a decode step) under a
        named program scope: traced dispatches inside it are tagged with
        `name`, and the call is timed end to end by the host clock, ending
        in one `torch.cuda.synchronize()` when the result lies on the card
        (first call = build-inclusive, later calls = steady)."""
        if not self.enabled():
            return fn()
        prev = getattr(self._local, "program", None)
        self._local.program = name
        t0 = time.perf_counter_ns()
        try:
            out = fn()
        finally:
            self._local.program = prev
        dev = _cuda_device(out)
        if dev is not None:
            torch.cuda.synchronize(dev)
        dt_ns = time.perf_counter_ns() - t0
        dt_us = dt_ns / 1e3
        with self._lock:
            ent = self._programs.setdefault(
                name, {"calls": 0, "first_us": None, "steady_n": 0,
                       "steady_sum": 0.0, "steady_min": None})
            first = ent["calls"] == 0
            if first:
                ent["first_us"] = dt_us
            else:
                _push_steady(ent, dt_us)
            ent["calls"] += 1
        _trace.TRACER.add_complete(name, t0, dt_ns,
                                   phase="compile" if first else "steady")
        return out

    # ----------------------------------------------------------- dispatch
    def _entry(self, op, impl, key, bytes_moved):
        return self._entries.setdefault(
            (op, impl, key), _new_entry(op, impl, key, bytes_moved))

    def dispatch(self, op: str, impl: str, key: str, bytes_moved: dict,
                 fn, *, traced: bool, device=None,
                 marks_launch: bool = False):
        """The hook `kernels/ops.py` routes every kernel call through.
        ``device`` is the device of the op's operands: a CUDA device is
        timed by events on its current stream, anything else by the host
        clock.  With ``marks_launch``, ``fn`` takes an optional argument
        on a CUDA device: a callable its kernel wrapper calls right before
        the launch, where the timed span then starts (a call that never
        calls it is timed from before ``fn``)."""
        if not self.enabled():
            return fn()
        if traced:
            with self._lock:
                ent = self._entry(op, impl, key, bytes_moved)
                ent["traced_calls"] += 1
                prog = self.current_program()
                if prog is not None:
                    ent["program"] = prog
            _trace.TRACER.instant(f"trace:{op}[{impl}]", key=key)
            return fn()
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            e0.record(stream)
            if marks_launch:
                launch = torch.cuda.Event(enable_timing=True)
                marked = []

                def mark():
                    if not marked:
                        launch.record(stream)
                        marked.append(True)
                out = fn(mark)
                if marked:
                    e0 = launch
            else:
                out = fn()
            e1.record(stream)
            with self._lock:
                ent = self._entry(op, impl, key, bytes_moved)
                first = ent["calls"] == 0
                ent["calls"] += 1
                self._pending.append((ent, first, t0, dev, e0, e1))
                over = len(self._pending) > MAX_PENDING
            if over:
                self._resolve(MAX_PENDING // 2)
            return out
        t0 = time.perf_counter_ns()
        out = fn()
        dt_ns = time.perf_counter_ns() - t0
        with self._lock:
            ent = self._entry(op, impl, key, bytes_moved)
            first = ent["calls"] == 0
            ent["calls"] += 1
        self._record(ent, first, t0, dt_ns / 1e3)
        return out

    def _record(self, ent, first: bool, t0_ns: int, dt_us: float) -> None:
        """One measured call: first/steady statistics, a span, a sample."""
        with self._lock:
            if first:
                ent["first_us"] = dt_us
            else:
                _push_steady(ent, dt_us)
        op, impl = ent["op"], ent["impl"]
        phase = "compile" if first else "steady"
        _trace.TRACER.add_complete(f"{op}[{impl}]", t0_ns, int(dt_us * 1e3),
                                   key=ent["key"], phase=phase)
        _metrics.REGISTRY.histogram("kernel_dispatch_us",
                                    bounds=_metrics.US_BUCKETS,
                                    op=op, impl=impl,
                                    phase=phase).record(dt_us)

    def _resolve(self, n: int | None = None) -> None:
        """Resolve the ``n`` oldest pending event pairs (all when None):
        all of them after one synchronisation of each device concerned, a
        few by waiting for the newest of them."""
        with self._lock:
            k = len(self._pending) if n is None else min(n,
                                                         len(self._pending))
            batch = [self._pending.popleft() for _ in range(k)]
        if not batch:
            return
        if n is None:
            for dev in {p[3] for p in batch}:
                torch.cuda.synchronize(dev)
        for ent, first, t0, _, e0, e1 in batch:
            e1.synchronize()
            self._record(ent, first, t0, e0.elapsed_time(e1) * 1e3)

    # ------------------------------------------------------------ readout
    def snapshot(self) -> dict:
        """{"records": [per-(op, impl, key) rows], "programs": {...}}.

        Pending CUDA events are resolved first.  Rows always carry
        `steady_us` when any steady sample exists: timed ops report their
        own mean, traced ops inherit their program's steady mean
        (`steady_source` says which)."""
        self._resolve()
        with self._lock:
            entries = [dict(e) for e in self._entries.values()]
            programs = {n: dict(p) for n, p in self._programs.items()}
        for p in programs.values():
            p["steady_us"] = (p["steady_sum"] / p["steady_n"]
                              if p["steady_n"] else None)
            del p["steady_sum"]
        records = []
        for e in entries:
            r = {k: e[k] for k in ("op", "impl", "key", "bytes", "calls",
                                   "traced_calls", "first_us", "program")}
            if e["steady_n"]:
                r["steady_us"] = e["steady_sum"] / e["steady_n"]
                r["steady_us_min"] = e["steady_min"]
                r["steady_source"] = "self"
            else:
                prog = programs.get(e["program"]) or {}
                r["steady_us"] = prog.get("steady_us") or prog.get("first_us")
                r["steady_us_min"] = prog.get("steady_min")
                r["steady_source"] = (f"program:{e['program']}"
                                      if r["steady_us"] is not None else None)
            records.append(r)
        return {"records": records, "programs": programs}


PROFILER = KernelProfiler()

dispatch = PROFILER.dispatch
time_program = PROFILER.time_program
snapshot = PROFILER.snapshot
set_enabled = PROFILER.set_enabled
enabled = PROFILER.enabled
clear = PROFILER.clear
