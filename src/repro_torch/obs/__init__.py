"""Runtime telemetry, copied from the framework-free half of `repro.obs`.

  `trace`    ring-buffer span tracer → Chrome-trace/Perfetto JSON
             (``REPRO_TRACE=1``, ``REPRO_TRACE_PATH=...``)
  `metrics`  counters / gauges / log-bucketed histograms, JSON snapshot +
             Prometheus text exposition

The kernel-dispatch profiler (`repro.obs.kernel_profile`) is not ported
yet (ROADMAP.md queue A, item 10).  Consumer:
`serving.engine.ServeEngine.metrics_snapshot()`.
"""

from . import metrics, trace  # noqa: F401

__all__ = ["trace", "metrics"]
