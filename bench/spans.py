"""The program's own spans in a traced window (`traced.Traced`), and the
device events launched inside each.

The program marks each CNN forward with host spans named ``cnn.*``
(``cnn.forward`` around the whole forward; ``cnn.conv``, ``cnn.requant``,
``cnn.pool``, ``cnn.shortcut``, ``cnn.concat``, ``cnn.head`` inside it),
which the profiler records as ``user_annotation`` events on the loop's
thread.  A program without them gives no figures here.

`traced.Traced` keeps no link from a device event to the host call that
launched it.  The loop runs on one stream, so the n-th call of the loop's
thread that puts work on the device (`LAUNCHES`) made the n-th device
event by start time; a device event then belongs to the innermost
``cnn.*`` span around its launch.  The profiler now and then loses a few
device events, so both sequences are cut at their copies (the images in
and the logits out of each query) and paired piece by piece (`_align`):
a copy the device lacks joins the runs on either side of it, and a
forward in which a piece's counts or kinds (a kernel against a memset)
differ is left out, and says so on standard error.  A window whose device
holds an event that no launch explains gives nothing.

The pairing does not compare times: the profiler's device clock drifts
from its host clock (about -450 ppm on an H100 machine), so where the
card waits on the host, a kernel can read as starting a few hundred µs
before its launch by the end of a second-long window.
"""

from __future__ import annotations

import bisect
import sys

PREFIX = "cnn."
FORWARD = "cnn.forward"
# the host calls that put work on the device, as the card's profiler names
# them (NVIDIA H100, torch 2.11, CUDA 12.8), and the device event each makes
# copies a window may lose on the device before its pairing is given up
MAX_LOST_COPIES = 8
LAUNCHES = {"cudaLaunchKernel": "kernel", "cuLaunchKernel": "kernel",
            "cudaMemcpyAsync": "gpu_memcpy", "cudaMemsetAsync": "gpu_memset"}


def forwards(t) -> list[tuple[float, float]]:
    """(start, end) of each ``cnn.forward`` span, in order."""
    return [(ts, ts + dur) for name, ts, dur in t.host if name == FORWARD]


def _pieces(kinds: list[str]) -> list[list[int]]:
    """Indices of a sequence of event kinds, cut before and after each
    copy: [run, [copy], run, [copy], ..., run]."""
    out = [[]]
    for i, kind in enumerate(kinds):
        if kind == "gpu_memcpy":
            out += [[i], []]
        else:
            out[-1].append(i)
    return out


def _enclosing(launches, spans) -> list[tuple]:
    """For each launch: the innermost and the outermost ``cnn.*`` span
    around it (None, None outside every one).  ``spans`` come by start,
    the outer first, as `Traced.host` keeps them, and nest: one sweep
    with a stack finds them."""
    out, stack, i = [], [], 0
    for _, ts, _ in launches:
        while i < len(spans) and spans[i][1] <= ts:
            while stack and stack[-1][1] + stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] + stack[-1][2] < ts:
            stack.pop()
        out.append((stack[-1], stack[0]) if stack else (None, None))
    return out


def _align(lp, dp, lk, dk) -> list[tuple[list[int], list[int], bool]] | None:
    """The launches' pieces against the device's (`_pieces`), where the
    device may lack events the profiler lost but holds none more: each
    device copy goes to a launched copy, in order, and the device's run
    between two copies to the launches' runs between theirs, with any
    launched copy skipped there (lost).  Of the ways to match them, the
    one with the fewest stretches whose counts or kinds differ, then the
    fewest copies skipped.  Where nothing lies between two copies, the one
    the device kept may go to its neighbour's launch: both lie outside
    every span, so no device time moves between spans.  → [(launch
    indices, device indices, exact)] a stretch each, the copies as
    stretches of one; None where no way explains the device."""
    runs, druns = lp[0::2], dp[0::2]
    copies, dcopies = [c[0] for c in lp[1::2]], [c[0] for c in dp[1::2]]
    m, n = len(copies), len(dcopies)
    if not 0 <= m - n <= MAX_LOST_COPIES:
        return None

    def stretch(a0, a1, b):
        """Launch runs a0..a1 against the device's run b → (launch
        indices, exact), None where the device holds more."""
        idx = [i for r in runs[a0:a1 + 1] for i in r]
        d = druns[b]
        if len(d) > len(idx):
            return None
        return idx, len(d) == len(idx) and all(
            lk[i] == dk[j] for i, j in zip(idx, d))

    # best[(b, a)]: (inexact stretches, copies skipped, previous a) with
    # the device's copy b on the launched copy a (b = n, a = m: the
    # window's end); a - b never passes m - n
    best = {(-1, -1): (0, 0, None)}
    for b in range(n + 1):
        ends = range(b, b + m - n + 1) if b < n else [m]
        for a in ends:
            opts = []
            for ap in range(b - 1, a):
                if (b - 1, ap) not in best:
                    continue
                st = stretch(ap + 1, a, b)
                if st is not None:
                    bad, skip, _ = best[(b - 1, ap)]
                    opts.append((bad + (not st[1]), skip + a - ap - 1, ap))
            if opts:
                best[(b, a)] = min(opts)
    if (n, m) not in best:
        return None
    out, b, a = [], n, m
    while b >= 0:
        ap = best[(b, a)][2]
        idx, exact = stretch(ap + 1, a, b)
        out.append((idx, druns[b], exact))
        if b > 0:
            out.append(([copies[ap]], [dcopies[b - 1]], True))
        b, a = b - 1, ap
    return out[::-1]


def attribute(t) -> tuple[list[tuple[str | None, tuple]], int] | None:
    """The device events of the window that pair with their launches, each
    with the name of the innermost ``cnn.*`` span around its launch (None
    outside every one), leaving out the forwards in which a stretch does
    not pair (`_align`); and how many ``cnn.forward`` spans are kept.
    None when no pairing explains the device's events."""
    launches = [h for h in t.host if h[0] in LAUNCHES]
    device = sorted(t.device, key=lambda d: d[1])
    lk, dk = [LAUNCHES[h[0]] for h in launches], [d[3] for d in device]
    lp, dp = _pieces(lk), _pieces(dk)
    stretches = _align(lp, dp, lk, dk)
    if stretches is None:
        print(f"spans: {len(lp) // 2} copies launched and {len(dp) // 2} "
              f"on the device in the traced window; not paired",
              file=sys.stderr)
        return None
    if len(lp) != len(dp):
        print(f"spans: {(len(lp) - len(dp)) // 2} of {len(lp) // 2} copies "
              f"launched in the traced window are not on the device; "
              f"skipped", file=sys.stderr)
    where = _enclosing(launches, [h for h in t.host
                                  if h[0].startswith(PREFIX)])
    pairs, lost = [], set()
    for a, b, exact in stretches:
        if exact:
            pairs += zip(a, b)
        else:
            lost.update(where[i][1] for i in a if where[i][1] is not None)
    n = len(forwards(t))
    kept = n - sum(s[0] == FORWARD for s in lost)
    if lost:
        print(f"spans: {n - kept} of {n} forwards left out: their launches "
              f"and device events do not pair", file=sys.stderr)
    return [(where[i][0][0] if where[i][0] else None, device[j])
            for i, j in pairs if where[i][1] not in lost], kept


def device_ms_a_forward(t) -> dict[str | None, float] | None:
    """Device ms by the innermost ``cnn.*`` span of each event's launch,
    over the forwards kept by `attribute`; None without program spans,
    without a pairing, or with no forward kept."""
    if not forwards(t):
        return None
    paired = attribute(t)
    if paired is None or not paired[1]:
        return None
    pairs, kept = paired
    by = {}
    for name, d in pairs:
        by[name] = by.get(name, 0.0) + d[2] * 1e-3 / kept
    return by


def idle_gaps(t) -> list[tuple[float, float]]:
    """The window's device-idle intervals (µs), as `Traced.idle_gaps`
    finds them."""
    gaps, end = [], t.start
    for a, b in t.busy_intervals() + [(t.end, t.end)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    return gaps


def forward_idle_us(t) -> float:
    """Device-idle µs of the window whose gap's midpoint falls inside a
    ``cnn.forward`` span."""
    fw = forwards(t)
    starts = [a for a, _ in fw]
    idle = 0.0
    for a, b in idle_gaps(t):
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid <= fw[k][1]:
            idle += b - a
    return idle
