"""The one load generator: a closed loop of fixed-size queries over a pool
of images, read from a traffic file (``bench/traffic/<name>.json``).

A query copies its batch from (pinned) host memory to the card, runs the
forward and copies the logits back; ``in_flight`` queries may be on the
card at once, and after each issue the host waits on the oldest until
fewer remain.  ``in_flight = 1`` is MLPerf's MultiStream, more is its
Offline.  A query's latency runs from its issue (before the copy in) to its
logits on the host.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


class Window:
    """What one run of the loop did: per query its pool slot, issue and
    completion times (host clock, seconds) and logits on the host."""

    def __init__(self, batch: int):
        self.batch = batch
        self.slot, self.issued, self.done, self.logits = [], [], [], []

    @property
    def seconds(self) -> float:
        return self.done[-1] - self.issued[0] if self.done else 0.0

    @property
    def images(self) -> int:
        return self.batch * len(self.done)

    @property
    def images_per_s(self) -> float:
        return self.images / self.seconds if self.seconds > 0 else 0.0

    def latencies_ms(self) -> list[float]:
        return [(d - i) * 1e3 for i, d in zip(self.issued, self.done)]


def percentile(values, q: float) -> float:
    """The q-th percentile of all ``values``, interpolated linearly between
    the two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def make_pool(config: dict, traffic: dict, gen: torch.Generator,
              device: torch.device) -> list[torch.Tensor]:
    """``pool_batches`` batches of N(0, 1) NHWC float32 images, drawn on
    the device in one call and kept in pinned host memory."""
    s, b = config["image_size"], traffic["batch"]
    n = traffic["pool_batches"]
    x = torch.randn((n * b, s, s, config["in_channels"]), generator=gen,
                    device=device)
    if device.type == "cuda":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        del x
        x = host
    return [x[i * b:(i + 1) * b] for i in range(n)]


def closed_loop(forward, pool: list, device: torch.device, in_flight: int,
                *, until: float | None = None, count: int | None = None,
                span=None) -> Window:
    """Issue queries until the host clock passes ``until`` or ``count``
    have been issued, then wait for all.  ``span(name)``, where given,
    opens a named host span around each issue and each wait."""
    span = span or (lambda name: contextlib.nullcontext())
    cuda = device.type == "cuda"
    win = Window(pool[0].shape[0])
    ring = [None] * in_flight
    pending = collections.deque()

    def retire():
        q, host, event = pending.popleft()
        with span("bench.wait"):
            if event is not None:
                event.synchronize()
            win.done.append(time.perf_counter())
        win.logits.append(host.clone())

    q = 0
    while (until is None or time.perf_counter() < until) and \
            (count is None or q < count):
        with span("bench.issue"):
            win.issued.append(time.perf_counter())
            slot = q % len(pool)
            x = pool[slot].to(device, non_blocking=True)
            logits = forward(x)
            k = q % in_flight
            if ring[k] is None:
                ring[k] = torch.empty(logits.shape, dtype=logits.dtype,
                                      pin_memory=cuda)
            ring[k].copy_(logits, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
        win.slot.append(slot)
        pending.append((q, ring[k], event))
        q += 1
        while len(pending) >= in_flight:
            retire()
    while pending:
        retire()
    return win
