"""Runtime telemetry, the counterpart of `repro.obs`.

  `trace`          ring-buffer span tracer → Chrome-trace/Perfetto JSON
                   (``REPRO_TRACE=1``, ``REPRO_TRACE_PATH=...``); a copy
  `metrics`        counters / gauges / log-bucketed histograms, JSON
                   snapshot + Prometheus text exposition; a copy
  `kernel_profile` per-dispatch kernel records behind `kernels/ops.py`:
                   op, impl, shape key, analytic bytes and first/steady
                   time, by CUDA events on the card
                   (``REPRO_KERNEL_PROFILE=1`` or ``REPRO_TRACE=1``)

Consumer: `serving.engine.ServeEngine.metrics_snapshot()`.
"""

from . import kernel_profile, metrics, trace  # noqa: F401

__all__ = ["trace", "metrics", "kernel_profile"]
