"""Process-wide metrics registry (counterpart of
``mxnet_tpu/telemetry/registry.py``): the one store the port's
subsystems report into.

- **Metric kinds**: :class:`Counter` (monotonic within a window),
  :class:`Gauge` (current level), :class:`Timer` (count/total/min/max),
  :class:`Histogram` (Timer plus a sliding window with p50/p99). Every
  metric is named ``subsystem::name``; further ``::`` segments are
  free-form tags.
- **Atomic snapshot-and-clear**: :func:`snapshot` reads (and with
  ``reset=True`` zeroes) every metric under one lock acquisition, so a
  concurrent writer is never counted twice nor torn across windows.
- **Collectors**: a subsystem whose report needs live computation (the
  data pipelines' queue depths) registers a ``fn(reset) -> dict``
  collector; :func:`report` assembles ``{subsystems: {...}, metrics:
  {...}}`` and each ``*_report()`` view (``sparse_report``,
  ``data_report``) is ``collect(name, reset)`` of it
  (:func:`collector_view`).

Handles are cheap and cacheable: ``counter("sparse::steps")`` returns
the same object every call; hot paths hold the handle.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List

__all__ = ["Counter", "Gauge", "Timer", "Histogram", "counter", "gauge",
           "timer", "histogram", "snapshot", "report", "collect",
           "register_collector", "collector_view", "collectors",
           "namespace", "reset", "remove"]

# RLock, not Lock: dead-replica cleanup (serving's weakref.finalize ->
# remove()) can run synchronously during a GC triggered by an
# allocation INSIDE a locked region on the same thread — re-entrancy
# must not deadlock the whole process
_LOCK = threading.RLock()
_metrics: Dict[str, "_Metric"] = {}
_collectors: Dict[str, Callable] = {}
_DEFAULT_WINDOW = 2048


def namespace(name: str) -> str:
    """``subsystem::rest`` -> ``subsystem`` (``op`` when untagged)."""
    return name.split("::", 1)[0] if "::" in name else "op"


class _Metric:
    __slots__ = ("name",)
    kind = "?"

    def __init__(self, name):
        self.name = name


class Counter(_Metric):
    """Monotonic count within a measurement window (snapshot-and-clear
    zeroes it)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self, name):
        super().__init__(name)
        self.value = 0

    def inc(self, delta=1):
        with _LOCK:
            self.value += delta

    def get(self):
        with _LOCK:
            return self.value

    def _snap(self, reset):
        out = {"kind": "counter", "value": self.value}
        if reset:
            self.value = 0
        return out


class Gauge(_Metric):
    """Current level (queue depth, bytes-per-step). ``reset`` keeps the
    value: a level is a fact about now, not about a window."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, name):
        super().__init__(name)
        self.value = 0.0

    def set(self, value):
        with _LOCK:
            self.value = value

    def inc(self, delta=1):
        with _LOCK:
            self.value += delta

    def get(self):
        with _LOCK:
            return self.value

    def _snap(self, reset):
        return {"kind": "gauge", "value": self.value}


class Timer(_Metric):
    """count/total/min/max over recorded durations — the profiler
    aggregate-table shape. Zero-count snapshots render ``min`` as 0.0,
    never ``inf``."""

    __slots__ = ("count", "total", "min", "max")
    kind = "timer"

    def __init__(self, name):
        super().__init__(name)
        self._zero()

    def _zero(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def record(self, dt):
        with _LOCK:
            self.count += 1
            self.total += dt
            if dt < self.min:
                self.min = dt
            if dt > self.max:
                self.max = dt

    def _snap(self, reset):
        out = {"kind": "timer", "count": self.count, "total": self.total,
               "min": self.min if self.count else 0.0, "max": self.max}
        if reset:
            self._zero()
        return out


class Histogram(Timer):
    """Timer plus a sliding sample window for p50/p99 (the serving
    latency shape). Percentiles are computed at snapshot time from the
    last ``window`` observations; count/total/min/max stay exact."""

    __slots__ = ("window", "_samples")
    kind = "histogram"

    def __init__(self, name, window=_DEFAULT_WINDOW):
        super().__init__(name)
        self.window = int(window)
        self._samples: List[float] = []

    def observe(self, value):
        with _LOCK:
            self.count += 1
            self.total += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            self._samples.append(value)
            if len(self._samples) > self.window:
                del self._samples[:-self.window]

    record = observe

    @staticmethod
    def _pct(ordered, q):
        if not ordered:
            return None
        idx = q * (len(ordered) - 1)
        lo = int(idx)
        hi = min(lo + 1, len(ordered) - 1)
        frac = idx - lo
        return ordered[lo] * (1 - frac) + ordered[hi] * frac

    def _snap(self, reset):
        # percentiles need a sort — O(n log n) per histogram must not
        # run under the one registry lock every hot-path write takes;
        # copy the window out here, snapshot() sorts after release
        out = {"kind": "histogram", "count": self.count,
               "total": self.total,
               "min": self.min if self.count else 0.0, "max": self.max,
               "mean": (self.total / self.count) if self.count else 0.0,
               "window": len(self._samples),
               "_samples": list(self._samples)}
        if reset:
            self._zero()
            self._samples = []
        return out


def _get(name, cls, **kwargs):
    with _LOCK:
        m = _metrics.get(name)
        if m is None:
            m = _metrics[name] = cls(name, **kwargs)
        elif not isinstance(m, cls) and not (cls is Timer
                                             and isinstance(m, Histogram)):
            raise TypeError(
                f"telemetry metric '{name}' already registered as "
                f"{m.kind}, requested {cls.kind}")
        return m


def counter(name) -> Counter:
    return _get(name, Counter)


def gauge(name) -> Gauge:
    return _get(name, Gauge)


def timer(name) -> Timer:
    return _get(name, Timer)


def histogram(name, window=_DEFAULT_WINDOW) -> Histogram:
    return _get(name, Histogram, window=window)


def snapshot(reset=False, prefix=None, kinds=None):
    """Read every metric (optionally only names under ``prefix`` /
    kinds in ``kinds``) in ONE lock acquisition; ``reset=True`` zeroes
    what was read in the same acquisition — the atomic
    snapshot-and-clear every report surface shares. Returns
    ``{name: {kind, ...values}}``."""
    out = {}
    with _LOCK:
        for name in sorted(_metrics):
            if prefix is not None and not name.startswith(prefix):
                continue
            # .get(): a re-entrant remove() (GC finalizer mid-loop) may
            # drop a name after the sorted() materialized it
            m = _metrics.get(name)
            if m is None or (kinds is not None and m.kind not in kinds):
                continue
            out[name] = m._snap(reset)
    # histogram percentiles: sorted OUTSIDE the lock (the read-and-clear
    # above stays atomic; the sort only post-processes copied samples)
    for snap in out.values():
        samples = snap.pop("_samples", None)
        if samples is not None:
            ordered = sorted(samples)
            snap["p50"] = Histogram._pct(ordered, 0.50)
            snap["p99"] = Histogram._pct(ordered, 0.99)
    return out


def reset(prefix=None):
    """Zero every (matching) metric without reading it."""
    snapshot(reset=True, prefix=prefix)


def remove(prefix):
    """Drop every metric named under ``prefix`` entirely (handle and
    all). For per-instance series — ``serving::<predictor-id>::…`` —
    whose owner is gone: a long-lived process that churns replicas must
    not accumulate dead series in every report/scrape forever (the
    registry would otherwise grow without bound). Live handles to a
    removed metric keep working but are re-registered on next
    lookup."""
    with _LOCK:
        for name in [n for n in _metrics if n.startswith(prefix)]:
            del _metrics[name]


# ---------------------------------------------------------------------------
# collectors: subsystem report trees
# ---------------------------------------------------------------------------
def register_collector(name: str, fn: Callable):
    """Register ``fn(reset: bool) -> dict`` as subsystem ``name``'s
    report tree. The ``*_report()`` views delegate to :func:`collect`,
    so the unified report is a superset of each of them by
    construction."""
    with _LOCK:
        _collectors[name] = fn
    return fn


def collector_view(name: str, fn: Callable):
    """Register ``fn`` as subsystem ``name``'s collector and return its
    view function (``<name>_report(reset=False)``). Every report view is
    built here, so the delegation contract lives in one place."""
    register_collector(name, fn)

    def view(reset=False):
        return collect(name, reset=reset)

    view.__name__ = view.__qualname__ = name + "_report"
    view.__doc__ = (f"The ``{name}`` subtree of "
                    f"``telemetry.report()``: the filtered view of "
                    f"the unified telemetry tree (see the subsystem "
                    f"collector for the fields).")
    return view


def collectors():
    with _LOCK:
        return dict(_collectors)


def collect(name: str, reset=False):
    """One subsystem's report subtree (the filtered view of
    :func:`report`). Unknown subsystems return ``{}``."""
    fn = _collectors.get(name)
    return fn(reset) if fn is not None else {}


def report(reset=False, subsystems=None):
    """The unified telemetry tree:

    - ``subsystems``: every registered collector's report (``sparse``
      and ``data`` in the port),
    - ``metrics``: the flat registry snapshot (``subsystem::name`` ->
      values).

    ``reset=True`` clears both layers. The flat ``metrics`` snapshot is
    taken first, in one atomic read-and-clear, so a reset read carries
    the window's values there. Collectors (which
    snapshot-and-clear their own stores, including their registry
    prefixes) run after: in a reset read their registry-counter mirrors
    reflect the post-clear state, while their instance-local state
    (latency windows, program tables) still reports this window. A
    write landing between the two appears in exactly one layer of
    exactly one window — never twice, never torn.
    """
    names = list(_collectors) if subsystems is None else list(subsystems)
    metrics = snapshot(reset=reset)
    subs = {n: collect(n, reset=reset) for n in names}
    return {
        "schema": 1,
        "time": time.time(),
        "subsystems": subs,
        "metrics": metrics,
    }
