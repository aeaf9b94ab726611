"""Unified telemetry: one registry, step-time attribution, durable export
(counterpart of ``mxnet_tpu/telemetry/``).

- **registry.py**: the process-wide metrics registry (counters, gauges,
  timers, histograms with p50/p99, all named ``subsystem::name``) with
  one atomic snapshot-and-clear. The report surfaces
  (``serving_report``, ``data_report``, ``fault_report``,
  ``compile_report``, ``sparse_report``, ``memory_report``,
  ``profiler.counters``) are collectors here, filtered views of
  :func:`report`.
- **timeline.py**: :class:`StepTimeline`: ``fit()`` attributes every
  step's host wall time across data-wait / H2D / compile (warm step and
  capture) / device-step (the replay) / metric-sync phases.
- **export.py**: with ``MXTPU_TELEMETRY_DIR`` set, the rotating JSONL
  event log, atomic report snapshots and a Prometheus rendering, in the
  JAX package's file format (its ``read_events`` and
  ``tools/telemetry.py`` read the port's files).
- **trace.py**: spans with trace / span ids in a bounded ring,
  propagated serving request -> batch -> bucket and fit step -> phase,
  exported as Chrome trace-event JSON under ``MXTPU_TRACE_DIR``; mirrored
  into ``torch.profiler.record_function`` while the profiler runs.
- **memory.py**: per-program device memory of the captured CUDA graphs
  (``memory_report()``, ``mem::`` gauges), read around each capture.

Everything here is observability: export failures count and log, they
never take down the training step or the serving loop.
"""
from __future__ import annotations

from . import registry
from . import timeline
from . import export
from . import trace
from . import memory
from .registry import (Counter, Gauge, Timer, Histogram, counter, gauge,
                       timer, histogram, snapshot, report, collect,
                       register_collector, collector_view, reset, remove)
from .timeline import (StepTimeline, current, peak_hbm_bytes_s,
                       set_step_cost)
from .export import (enabled, telemetry_dir, emit_event, export_snapshot,
                     render_prometheus, read_events)
from .memory import memory_report

__all__ = ["registry", "timeline", "export", "trace", "memory",
           "Counter", "Gauge", "Timer", "Histogram",
           "counter", "gauge", "timer", "histogram",
           "snapshot", "report", "collect", "register_collector",
           "collector_view", "reset", "remove",
           "StepTimeline", "current", "peak_hbm_bytes_s", "set_step_cost",
           "enabled", "telemetry_dir", "emit_event", "export_snapshot",
           "render_prometheus", "read_events", "memory_report"]
