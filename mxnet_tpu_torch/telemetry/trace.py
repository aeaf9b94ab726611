"""Structured host tracing: trace/span ids in a bounded ring, exported
as Chrome trace-event JSON (counterpart of
``mxnet_tpu/telemetry/trace.py``; the file format is the JAX package's,
so its ``read_trace`` and ``tools/telemetry.py trace`` read the port's
files unchanged).

The metrics layer (registry/timeline/export) answers "how long do steps
take on average"; this module answers "where did THIS step / THIS
serving request spend its time". A *span* is one named interval with a
``trace_id`` (the request or fit run it belongs to), a ``span_id``, and
a ``parent_id``: parents link explicitly, so a serving request
submitted on a client thread, coalesced on the batcher thread, and
dispatched to a Predictor bucket reconstructs as one tree even though
the intervals live on three threads. Producers:

- serving: ``serving:request`` (submit -> complete, per request),
  ``serving:batch`` (DynamicBatcher micro-batch; its args carry the
  member request trace ids), ``serving:bucket<b>`` (Predictor dispatch,
  nested under the batch span), and the decode batcher's
  ``decode:prefill`` / ``decode:step`` / ``decode:lane_import`` /
  ``decode:reprefill``;
- training: ``fit:<symbol>`` (the run root), ``step`` and the
  StepTimeline phases (``data_wait`` / ``h2d_stage`` / ``compile`` /
  ``device_step`` / ``metric_ft_sync``), recorded FROM the timeline's
  own phase records (timeline.py), never measured twice;
- data pipeline: ``data:source`` / ``data:decode`` / ``data:stage`` on
  the pipeline's threads, linked to the fit root through
  :meth:`DataPipeline.set_trace`.

Hot-path contract: recording a completed span is one tuple write into a
preallocated ring under a short lock: no I/O, no device call, no
unbounded growth (``MXTPU_TRACE_RING`` caps it; overwrites count
``trace::dropped``). With ``MXTPU_TRACE_DIR`` unset every producer's
guard is a single env check and nothing is recorded at all. Export
(:func:`export_trace`, also run at StepTimeline close and
DynamicBatcher stop) writes ``trace-<pid>-NNNNN.json`` in Chrome
trace-event format (``X`` complete events with ``ts`` / ``dur`` in
microseconds on one monotonic clock), loadable in Perfetto or
chrome://tracing. While the port's profiler runs
(``profiler.set_state("run")``, a ``torch.profiler`` trace), a span
also enters ``torch.profiler.record_function`` under
``<cat>::<name>`` (``MXTPU_TRACE_ANNOTATE``), so host spans and the
card's kernels line up in the profiler's trace. ``record_function`` is
a host-side record: entered while a CUDA graph is captured it adds
nothing to the graph.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

from . import registry

__all__ = ["enabled", "trace_dir", "new_trace_id", "new_span_id",
           "span", "current", "record_span", "record_spans", "spans",
           "export_trace",
           "trace_files", "read_trace", "reset"]

# one monotonic origin for every ts this process emits: Chrome trace
# viewers only need ordering/containment, not wall-clock epoch
_EPOCH = time.perf_counter()

_lock = threading.Lock()
_ring = []           # preallocated to capacity on first record
_cap = 0
_count = 0           # spans ever recorded; live slot i = (i % _cap)
_exports = 0
_tls = threading.local()
_id_seq = itertools.count(1)
_thread_names = {}   # tid -> name at first record (for "M" metadata)

_PID_TAG = None      # cached f"{pid:x}" id prefix (reset on fork-safety)


def trace_dir():
    """The effective trace export directory for THIS process (rank-
    qualified in multi-process runs, like the event log), or ''."""
    from .. import config
    base = str(config.get("MXTPU_TRACE_DIR") or "")
    if not base:
        return ""
    from .export import rank_subdir
    return rank_subdir(base)


def enabled():
    """True when MXTPU_TRACE_DIR is set. This is the producers' guard:
    one env read, no path construction."""
    from .. import config
    return bool(str(config.get("MXTPU_TRACE_DIR") or ""))


def _pid_tag():
    global _PID_TAG
    pid = os.getpid()
    if _PID_TAG is None or _PID_TAG[0] != pid:
        _PID_TAG = (pid, f"{pid:x}")
    return _PID_TAG[1]


def new_trace_id():
    """A process-unique trace id (pid-prefixed so rank files merge
    without collisions)."""
    return f"t{_pid_tag()}-{next(_id_seq):x}"


def new_span_id():
    return f"s{_pid_tag()}-{next(_id_seq):x}"


def record_span(name, cat, t0, dur_s, trace_id=None, span_id=None,
                parent_id=None, args=None, tid=None):
    """Record one COMPLETED interval into the ring (the low-level entry
    the StepTimeline phase bridge and the serving request records use —
    they already hold measured ``t0``/``dur``, so tracing never times
    anything twice). ``t0`` is a ``time.perf_counter()`` reading; never
    raises and never blocks beyond the ring lock."""
    record_spans([(name, cat, t0, dur_s, trace_id, span_id, parent_id,
                   args)], tid=tid)


def record_spans(records, tid=None):
    """Record several completed intervals, each ``(name, cat, t0, dur_s,
    trace_id, span_id, parent_id, args)``, under one acquisition of the
    ring lock (the StepTimeline flushes a step's phase spans this way,
    after the step's wall clock has stopped: the lock, which the data
    pipeline's threads also take, is never waited for inside a timed
    step). Never raises."""
    global _ring, _cap, _count
    try:
        tid = tid if tid is not None else threading.get_ident()
        recs = [((t0 - _EPOCH) * 1e6, max(0.0, dur_s) * 1e6, str(name),
                 str(cat), tid, trace_id, span_id, parent_id, args)
                for name, cat, t0, dur_s, trace_id, span_id, parent_id,
                args in records]
        with _lock:
            if _cap == 0:
                from .. import config
                _cap = max(64, int(config.get("MXTPU_TRACE_RING")))
                _ring = [None] * _cap
            for rec in recs:
                _ring[_count % _cap] = rec
                _count += 1
            if tid not in _thread_names:
                _thread_names[tid] = threading.current_thread().name
    except Exception:
        pass


class _NullSpan:
    """The disabled-tracing span: a shared no-op context manager, so
    ``with span(...)`` costs one attribute call when tracing is off."""

    trace_id = None
    span_id = None
    parent_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _Span:
    """An open interval: times itself, links to the innermost open span
    on this thread (or an explicit parent), and lands in the ring on
    exit. While the profiler runs it also mirrors into
    ``torch.profiler.record_function``, so the profiler's trace carries
    the same names."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "args", "_t0", "_ann")

    def __init__(self, name, cat, trace_id, parent_id, args):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.span_id = new_span_id()
        self.args = args
        self._t0 = 0.0
        self._ann = None

    def __enter__(self):
        st = _stack()
        if st:
            top = st[-1]
            if self.parent_id is None:
                self.parent_id = top.span_id
            if self.trace_id is None:
                self.trace_id = top.trace_id
        if self.trace_id is None:
            self.trace_id = new_trace_id()
        st.append(self)
        from .. import profiler as _prof
        if _prof._annotating():
            from .. import config
            if config.get("MXTPU_TRACE_ANNOTATE"):
                self._ann = _prof._annotation(f"{self.cat}::{self.name}")
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:          # mismatched exits must not wedge TLS
            st.remove(self)
        record_span(self.name, self.cat, self._t0, dur,
                    trace_id=self.trace_id, span_id=self.span_id,
                    parent_id=self.parent_id, args=self.args)
        return False


def span(name, cat="host", trace=None, parent=None, args=None):
    """Open a traced interval (context manager). Inherits trace/parent
    from the innermost open span on this thread unless given
    explicitly. Returns a shared no-op when tracing is disabled."""
    if not enabled():
        return _NULL
    return _Span(name, cat, trace, parent, args)


def current():
    """The innermost open span on this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def spans():
    """The ring's live records, oldest first, as dicts (test/export
    surface; ts/dur in microseconds on the module's monotonic clock)."""
    with _lock:
        if _count <= _cap:
            live = _ring[:_count]
        else:
            head = _count % _cap
            live = _ring[head:] + _ring[:head]
    out = []
    for rec in live:
        if rec is None:
            continue
        ts, dur, name, cat, tid, trace_id, span_id, parent_id, args = rec
        out.append({"ts": ts, "dur": dur, "name": name, "cat": cat,
                    "tid": tid, "trace_id": trace_id, "span_id": span_id,
                    "parent_id": parent_id, "args": args})
    out.sort(key=lambda s: s["ts"])
    return out


def dropped():
    """Spans overwritten before export (ring wrapped)."""
    with _lock:
        return max(0, _count - _cap) if _cap else 0


def export_trace(path=None, clear=True):
    """Write the ring as one Chrome trace-event JSON file (``{"trace
    Events": [...]}``, "X" complete events + thread-name metadata) and
    return its path — None when tracing is disabled/empty or the write
    fails (export must never take down the caller). Runs off the hot
    path: StepTimeline.close() and DynamicBatcher.stop() call it, and
    ``clear=True`` empties the ring so back-to-back exports don't
    duplicate spans."""
    global _ring, _count, _exports
    try:
        recs = spans()
        if not recs:
            return None
        d = None
        if path is None:
            d = trace_dir()
            if not d:
                return None
        pid = os.getpid()
        events = [{"ph": "M", "name": "process_name", "pid": pid,
                   "tid": 0, "args": {"name": "mxnet_tpu_torch"}}]
        with _lock:
            names = dict(_thread_names)
        for tid in sorted({r["tid"] for r in recs}):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": names.get(tid, str(tid))}})
        n_dropped = dropped()
        for r in recs:
            args = dict(r["args"] or {})
            for k in ("trace_id", "span_id", "parent_id"):
                if r[k] is not None:
                    args[k] = r[k]
            events.append({"name": r["name"], "cat": r["cat"],
                           "ph": "X", "ts": round(r["ts"], 3),
                           "dur": round(r["dur"], 3), "pid": pid,
                           "tid": r["tid"], "args": args})
        tree = {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"producer":
                              "mxnet_tpu_torch.telemetry.trace",
                              "dropped_spans": n_dropped}}
        with _lock:
            if path is None:
                _exports += 1
                path = os.path.join(d, f"trace-{pid}-{_exports:05d}.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        from ..base import atomic_write
        with atomic_write(path, mode="w") as f:
            json.dump(tree, f)
        registry.counter("trace::exports").inc()
        registry.counter("trace::spans_exported").inc(len(recs))
        if n_dropped:
            registry.counter("trace::dropped").inc(n_dropped)
        if clear:
            with _lock:
                _count = 0
                _ring = [None] * _cap if _cap else []
        return path
    except Exception:
        try:
            from .. import fault
            fault.count("telemetry.write_errors")
        except Exception:
            pass
        return None


def trace_files(directory=None):
    """Exported trace files, oldest first."""
    import glob
    d = directory or trace_dir()
    if not d:
        return []
    return sorted(glob.glob(os.path.join(d, "trace-*.json")),
                  key=os.path.getmtime)


def read_trace(path):
    """Load one exported file back as its event list (CLI/test
    round-trip helper)."""
    with open(path, encoding="utf-8") as f:
        tree = json.load(f)
    return tree.get("traceEvents", [])


def reset():
    """Empty the ring and the export sequence (between test cases).
    Also drops the allocated capacity so the next record re-reads
    ``MXTPU_TRACE_RING`` — tests resize the ring through this."""
    global _ring, _cap, _count, _exports
    with _lock:
        _cap = 0
        _count = 0
        _exports = 0
        _ring = []
        _thread_names.clear()
