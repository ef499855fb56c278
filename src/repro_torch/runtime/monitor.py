"""Fleet health: heartbeats, straggler detection, restart policy.

Counterpart of `repro.runtime.monitor`, a plain-Python copy.

At 1000+ nodes the failure model is: (a) hard node loss → detected by
missed heartbeats, handled by restart-from-checkpoint on a shrunken mesh
(checkpoint.py reshards); (b) stragglers (slow HBM, thermal throttle,
flaky ICI) → detected by per-step-time outliers, handled by exclusion
lists fed back to the scheduler.

This module is deliberately transport-agnostic: heartbeats are
`record(host, step, step_time)` calls; in a real deployment they arrive
over the coordination service (or `torch.distributed`); in
tests they are driven synthetically.  The *logic* — windows, MAD-based
outlier detection, restart budgets — is the part worth testing and is
identical at any scale.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque


@dataclasses.dataclass
class StragglerReport:
    step: int
    median_s: float
    threshold_s: float
    stragglers: dict          # host -> last step_time
    missing: list             # hosts with no heartbeat in the window


class HeartbeatMonitor:
    """Sliding-window heartbeat + straggler tracker."""

    def __init__(self, hosts: list, *, window: int = 8,
                 mad_factor: float = 5.0, miss_timeout_s: float = 60.0,
                 clock=time.monotonic):
        self.hosts = list(hosts)
        self.window = window
        self.mad_factor = mad_factor
        self.miss_timeout_s = miss_timeout_s
        self._clock = clock
        self._times = defaultdict(lambda: deque(maxlen=window))
        self._last_seen = {h: None for h in self.hosts}

    def record(self, host, step: int, step_time_s: float):
        if host not in self._last_seen:
            self.hosts.append(host)            # elastic scale-up
        self._times[host].append(step_time_s)
        self._last_seen[host] = (self._clock(), step)

    def _median(self, xs):
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def report(self, step: int) -> StragglerReport:
        now = self._clock()
        latest = {h: (self._times[h][-1] if self._times[h] else None)
                  for h in self.hosts}
        live = [v for v in latest.values() if v is not None]
        med = self._median(live) if live else 0.0
        mad = self._median([abs(v - med) for v in live]) if live else 0.0
        thr = med + self.mad_factor * max(mad, 0.05 * med, 1e-6)
        stragglers = {h: v for h, v in latest.items()
                      if v is not None and v > thr}
        missing = [h for h in self.hosts
                   if self._last_seen.get(h) is None
                   or now - self._last_seen[h][0] > self.miss_timeout_s]
        return StragglerReport(step=step, median_s=med, threshold_s=thr,
                               stragglers=stragglers, missing=missing)


@dataclasses.dataclass
class RestartPolicy:
    """Decides what to do after a failure report.

    budget: max restarts within `budget_window_s` before escalating to
    `abort` (a crash loop must not burn the whole allocation)."""

    budget: int = 5
    budget_window_s: float = 3600.0
    min_hosts_fraction: float = 0.5
    clock: object = time.monotonic

    def __post_init__(self):
        self._restarts: deque = deque()

    def decide(self, report: StragglerReport, n_hosts_total: int) -> dict:
        now = self.clock()
        while self._restarts and now - self._restarts[0] \
                > self.budget_window_s:
            self._restarts.popleft()

        n_lost = len(report.missing)
        healthy = n_hosts_total - n_lost
        if n_lost == 0:
            if report.stragglers:
                return {"action": "exclude",
                        "hosts": sorted(report.stragglers)}
            return {"action": "continue"}
        if healthy < self.min_hosts_fraction * n_hosts_total:
            return {"action": "abort",
                    "reason": f"only {healthy}/{n_hosts_total} hosts left"}
        if len(self._restarts) >= self.budget:
            return {"action": "abort", "reason": "restart budget exhausted"}
        self._restarts.append(now)
        # a restart must also shed the stragglers seen in the same report,
        # or the reshard lands the job right back on the slow hosts
        exclude = sorted(set(report.missing) | set(report.stragglers))
        return {"action": "restart",
                "exclude": exclude,
                "new_world": healthy,
                "note": "restore latest checkpoint, reshard onto "
                        f"{healthy} hosts"}
