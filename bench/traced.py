"""The traced window of a ``--trace 1`` run: the cell's own loop under
`torch.profiler`, read from its Chrome trace.

The profiler on the card has now and then lost kernel events; a window in
which it saw fewer (or more) launches of the conv kernel than the
program's own launch counter says is taken again, after a wait that
doubles from half a second, up to ``WINDOWS`` windows.  A window that never
comes out whole gives no per-layer figures.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

WINDOWS = 5
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
B1_NAME = "log_conv2d"   # both of B1's kernels carry it in their names


class Traced:
    """The window's device events and host spans (microseconds, one
    clock), its query count and the conv kernel's launches in it."""

    def __init__(self, events: list[dict], queries: int, images: int,
                 b1_launches: int):
        span = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == "bench.window"]
        if not span:
            raise ValueError("the trace holds no bench.window span")
        self.start = float(span[0]["ts"])
        self.end = self.start + float(span[0]["dur"])
        tid = span[0].get("tid")
        inside = [e for e in events if e.get("ph") == "X"
                  and self.start <= float(e["ts"]) <= self.end]
        self.device = [(e["name"], float(e["ts"]), float(e["dur"]), e["cat"])
                       for e in inside if e.get("cat") in DEVICE_CATS]
        self.kernels = [d for d in self.device if d[3] == "kernel"]
        self.host = sorted(((e["name"], float(e["ts"]), float(e["dur"]))
                            for e in inside if e.get("cat") in HOST_CATS
                            and e.get("tid") == tid),
                           key=lambda h: (h[1], -h[2]))
        self.queries, self.images = queries, images
        self.b1_launches = b1_launches

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def b1_kernels(self) -> list:
        return [k for k in self.kernels if B1_NAME in k[0]]

    def complete(self) -> bool:
        return len(self.b1_kernels()) == self.b1_launches > 0

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device events' intervals, clipped to the
        window."""
        out = []
        for _, ts, dur, _ in sorted(self.device, key=lambda d: d[1]):
            a, b = max(ts, self.start), min(ts + dur, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> list[tuple[str, float]]:
        """Idle seconds of the device by what the host was doing then: the
        innermost span of the loop's thread around each gap's midpoint
        (its spans nest, so one sweep with a stack finds it)."""
        gaps, t = [], self.start
        for a, b in self.busy_intervals() + [(self.end, self.end)]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        by, stack, i = {}, [], 0
        for a, b in gaps:
            mid = (a + b) / 2
            while i < len(self.host) and self.host[i][1] <= mid:
                while stack and stack[-1][1] + stack[-1][2] < self.host[i][1]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] + stack[-1][2] < mid:
                stack.pop()
            name = stack[-1][0] if stack else "host"
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return sorted(by.items(), key=lambda kv: -kv[1])

    def device_ops(self) -> list[tuple[str, float]]:
        by = {}
        for name, _, dur, _ in self.device:
            by[name[:120]] = by.get(name[:120], 0.0) + dur * 1e-6
        return sorted(by.items(), key=lambda kv: -kv[1])


def _chrome_events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def traced_window(run, b1_launches) -> tuple[Traced, bool, list[int]]:
    """``run(span)`` drives the loop (returning its `Window`) under the
    profiler; ``b1_launches()`` reads the launch counter.  Returns the first
    whole window (else the last one taken), whether it is whole, and the
    conv-kernel counts of the windows that were not."""
    from torch.profiler import ProfilerActivity, profile, record_function
    lost = []
    for attempt in range(WINDOWS):
        if attempt:
            time.sleep(0.5 * 2 ** (attempt - 1))
        torch.cuda.synchronize()
        before = b1_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("bench.window"):
                win = run(record_function)
            torch.cuda.synchronize()
        t = Traced(_chrome_events(prof), len(win.done), win.images,
                   b1_launches() - before)
        if t.complete():
            return t, True, lost
        lost.append(len(t.b1_kernels()))
    return t, False, lost
