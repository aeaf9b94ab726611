"""Telemetry (counterpart of ``mxnet_tpu/telemetry/``): the
process-wide metrics registry alone.

``registry`` holds counters, gauges, timers and histograms named
``subsystem::name`` with one atomic snapshot-and-clear, and the
collectors whose views are ``sparse.sparse_report()`` and
``data.data_report()``. The JAX package's ``timeline`` (``StepTimeline``),
``export``, ``trace`` and ``memory`` are not ported yet (ROADMAP.md
queue A, item 7).
"""
from __future__ import annotations

from . import registry
from .registry import (Counter, Gauge, Timer, Histogram, counter, gauge,
                       timer, histogram, snapshot, report, collect,
                       register_collector, collector_view, reset, remove)

__all__ = ["registry", "Counter", "Gauge", "Timer", "Histogram",
           "counter", "gauge", "timer", "histogram", "snapshot", "report",
           "collect", "register_collector", "collector_view", "reset",
           "remove"]
