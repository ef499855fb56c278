"""Low-overhead span tracer: ring buffer → Chrome-trace/Perfetto JSON.

The paper argues NeuroMAX entirely through measurement (per-layer latency
and utilization, §V); this module is the live-measurement half of that
story — every span is a `(name, t0, dur, tid, args)` tuple in a bounded
thread-safe ring buffer, exported in the Chrome ``traceEvents`` format
that both ``chrome://tracing`` and Perfetto load directly.

Gating: tracing is OFF unless ``REPRO_TRACE=1`` is set (or
`set_enabled(True)` is called programmatically — `set_enabled(None)`
defers back to the env).  When disabled, `span()` returns one shared
no-op context manager and `instant()` returns immediately, so the cost
on a hot path is a single attribute load + env check (~100 ns) — cheap
enough to leave call sites unconditional.

    from repro_torch.obs import trace
    with trace.span("prefill", uid=3):
        ...
    trace.export_chrome_trace("trace.json")

``REPRO_TRACE_PATH=/path.json`` additionally auto-exports the buffer at
interpreter exit, so any program run under ``REPRO_TRACE=1`` leaves a
loadable trace behind without code changes.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from functools import wraps

_DEFAULT_CAPACITY = 65536
_OFF = ("", "0", "false", "off")


class _NullSpan:
    """Shared no-op span handed out while tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer, name, args):
        self._tracer, self.name, self.args = tracer, name, args
        self._t0 = 0

    def set(self, **args):
        """Attach attributes mid-span (rendered under `args` in the UI)."""
        self.args.update(args)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tracer._push(("X", self.name, self._t0, t1 - self._t0,
                            threading.get_ident(), self.args or None))
        return False


class Tracer:
    """Thread-safe bounded span buffer with Chrome-trace export."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._override: bool | None = None

    # ------------------------------------------------------------- gating
    def enabled(self) -> bool:
        if self._override is not None:
            return self._override
        return os.environ.get("REPRO_TRACE", "0").lower() not in _OFF

    def set_enabled(self, flag: bool | None) -> None:
        """True/False force; None defers to ``$REPRO_TRACE``."""
        self._override = flag

    # ----------------------------------------------------------- recording
    def span(self, name: str, **args):
        """Context manager timing a block; no-op (shared object) when off."""
        if not self.enabled():
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event."""
        if not self.enabled():
            return
        self._push(("i", name, time.perf_counter_ns(), 0,
                    threading.get_ident(), args or None))

    def add_complete(self, name: str, t0_ns: int, dur_ns: int, **args):
        """Record an externally-timed span (e.g. a call timed with a
        device synchronize, whose clock the caller already owns)."""
        if not self.enabled():
            return
        self._push(("X", name, t0_ns, dur_ns, threading.get_ident(),
                    args or None))

    def _push(self, ev: tuple) -> None:
        with self._lock:
            self._buf.append(ev)

    # ------------------------------------------------------------- readout
    def events(self) -> list:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def chrome_events(self) -> list[dict]:
        pid = os.getpid()
        out = []
        for ph, name, ts, dur, tid, args in self.events():
            ev = {"ph": ph, "name": name, "cat": "repro",
                  "ts": ts / 1e3, "pid": pid, "tid": tid}
            if ph == "X":
                ev["dur"] = dur / 1e3
            elif ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def export_chrome_trace(self, path: str | None = None) -> dict:
        """Chrome ``traceEvents`` payload; written to `path` when given."""
        payload = {"traceEvents": self.chrome_events(),
                   "displayTimeUnit": "ms"}
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, default=str)
                f.write("\n")
        return payload


TRACER = Tracer()

# module-level conveniences bound to the process-wide tracer
span = TRACER.span
instant = TRACER.instant
add_complete = TRACER.add_complete
enabled = TRACER.enabled
set_enabled = TRACER.set_enabled
events = TRACER.events
clear = TRACER.clear
export_chrome_trace = TRACER.export_chrome_trace


def traced(name: str | None = None, **static_args):
    """Decorator form: ``@traced()`` spans every call of the function."""
    def deco(fn):
        label = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*a, **kw):
            if not TRACER.enabled():
                return fn(*a, **kw)
            with TRACER.span(label, **static_args):
                return fn(*a, **kw)
        return wrapper
    return deco


@atexit.register
def _export_at_exit():  # pragma: no cover - exercised via subprocess runs
    path = os.environ.get("REPRO_TRACE_PATH")
    if path and TRACER.events():
        try:
            TRACER.export_chrome_trace(path)
        except OSError:
            pass
