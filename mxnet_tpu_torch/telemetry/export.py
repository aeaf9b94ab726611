"""Durable telemetry export: rotating JSONL events + snapshots + scrape
text (counterpart of ``mxnet_tpu/telemetry/export.py``; the files are the
JAX package's line for line, so its ``read_events`` and
``tools/telemetry.py`` read the port's directories unchanged).

With ``MXTPU_TELEMETRY_DIR`` set, this module maintains:

- ``events-NNNNN.jsonl``: an append-only, size-rotated event log. One
  JSON object per line (``{"ts", "kind", ...}``); writers append a full
  line and flush, so a SIGKILL can tear at most the final line: readers
  skip an unparseable trailing line and a restarted writer repairs it
  (newline-terminates) before appending. Rotation closes the current
  file and opens the next index; a kill between the two loses nothing
  that was written. Event kinds: ``train_step`` milestones
  (StepTimeline), ``epoch``, ``timeline_close``, ``serving_batch`` /
  ``serving_overloaded`` / ``serving_deadline`` (DynamicBatcher),
  ``serving_generation`` (DecodeBatcher) and ``checkpoint`` (save /
  restore). The JAX package's ``compile`` event is not written: its
  writer passes ``kind`` twice to ``emit_event`` and drops the error, so
  that event never lands in its log either (``compile_report()`` has
  the captures).
- ``snapshot-*.json``: full ``telemetry.report()`` trees, written
  atomically (``base.atomic_write``).
- :func:`render_prometheus`: the registry in Prometheus text exposition
  format.

**Multi-process layout:** in a run with an initialised
``torch.distributed`` process group of more than one rank, every
exporter writes under ``MXTPU_TELEMETRY_DIR/rank-<r>/``, so ranks
pointed at one shared directory never interleave their logs
(``tools/telemetry.py fleet`` merges them). Single-process runs keep
the flat layout.

The ``telemetry_write`` fault-injection site (faultinject.py) is
consulted on every event write (``event=N`` ordinal) and every rotation
(``rotation=K``): ``action=kill`` SIGKILLs mid-write / mid-rotation, a
raise models a transient I/O failure that the next event recovers from.
Export failures are counted (``fault::telemetry.write_errors``) and do
not propagate: observability must not take down training.
"""
from __future__ import annotations

import glob
import io
import json
import os
import re
import threading
import time

from . import registry

__all__ = ["enabled", "telemetry_dir", "rank_subdir", "emit_event",
           "export_snapshot", "render_prometheus", "event_files",
           "snapshot_files", "read_events", "release", "reset_exporter"]

_lock = threading.Lock()
_log = None          # the singleton _EventLog (created on first emit)

_EVENT_RE = re.compile(r"events-(\d+)\.jsonl$")


def rank_subdir(base):
    """``base/rank-<r>`` in a multi-process run (an initialised
    ``torch.distributed`` group of more than one rank), ``base``
    otherwise: the one rule behind the multi-process layout (trace
    export uses it too, so traces and events from rank r land side by
    side)."""
    if not base:
        return base
    try:
        import torch.distributed as tdist
        if not (tdist.is_available() and tdist.is_initialized()):
            return base
        r, w = tdist.get_rank(), tdist.get_world_size()
    except Exception:
        return base
    if w > 1:
        return os.path.join(base, f"rank-{r}")
    return base


def telemetry_dir():
    """The effective export directory for THIS process: the configured
    ``MXTPU_TELEMETRY_DIR``, rank-qualified in multi-process runs."""
    from .. import config
    return rank_subdir(str(config.get("MXTPU_TELEMETRY_DIR") or ""))


def enabled():
    from .. import config
    return bool(str(config.get("MXTPU_TELEMETRY_DIR") or ""))


def event_files(directory=None):
    """Event-log segments in rotation order (oldest first)."""
    d = directory or telemetry_dir()
    if not d:
        return []
    files = []
    for p in glob.glob(os.path.join(d, "events-*.jsonl")):
        m = _EVENT_RE.search(p)
        if m:
            files.append((int(m.group(1)), p))
    return [p for _, p in sorted(files)]


def snapshot_files(directory=None):
    d = directory or telemetry_dir()
    if not d:
        return []
    return sorted(glob.glob(os.path.join(d, "snapshot-*.json")),
                  key=os.path.getmtime)


class _EventLog:
    """Append-only rotating JSONL writer (one per process)."""

    def __init__(self, directory, rotate_bytes):
        self.dir = directory
        self.rotate_bytes = int(rotate_bytes)
        os.makedirs(directory, exist_ok=True)
        self._f = None
        self._size = 0
        self._events = 0
        existing = event_files(directory)
        if existing:
            self._idx = int(_EVENT_RE.search(existing[-1]).group(1))
            self._open(repair=True)
        else:
            self._idx = 1
            self._open(repair=False)

    def _path(self):
        return os.path.join(self.dir, f"events-{self._idx:05d}.jsonl")

    def _open(self, repair):
        path = self._path()
        if repair and os.path.exists(path):
            # a predecessor killed mid-write may have left a torn final
            # line; newline-terminate it so our first line starts clean
            # (readers skip the torn fragment either way)
            with open(path, "rb") as f:
                try:
                    f.seek(-1, io.SEEK_END)
                    torn = f.read(1) != b"\n"
                except OSError:
                    torn = False
            if torn:
                with open(path, "ab") as f:
                    f.write(b"\n")
        self._f = open(path, "a", encoding="utf-8")
        self._size = self._f.tell()

    def _rotate(self):
        from .. import faultinject
        f, self._f = self._f, None
        if f is not None:
            f.close()
        self._idx += 1
        self._size = 0
        # a kill here (mid-rotation: old segment closed, new one not yet
        # open) loses no written event — the chaos drill's target window.
        # event=0 pins the coordinate space: a spec armed on event=N
        # must not also fire here (fire() matches absent keys vacuously).
        # A raise-action spec models a transient I/O failure (ENOSPC):
        # emit() recovers on the next event
        if faultinject.fire("telemetry_write", rotation=self._idx,
                            event=0):
            raise faultinject.FaultInjected("telemetry_write",
                                            rotation=self._idx)
        self._open(repair=False)

    def emit(self, kind, fields):
        from .. import faultinject
        line = json.dumps({"ts": round(time.time(), 6), "kind": kind,
                           **fields}, default=str) + "\n"
        with _lock:
            self._events += 1
            if self._f is None:
                # a prior rotation or open failed (transient ENOSPC, an
                # injected raise): the index was already advanced, so
                # reopen it — one failed write must not end durable
                # export for the rest of the process
                self._open(repair=True)
            if self._size + len(line) > self.rotate_bytes and \
                    self._size > 0:
                self._rotate()
            if faultinject.fire("telemetry_write", event=self._events,
                                rotation=0):
                raise faultinject.FaultInjected("telemetry_write",
                                                event=self._events)
            self._f.write(line)
            self._f.flush()
            self._size += len(line)


def _get_log():
    global _log
    with _lock:
        d = telemetry_dir()
        # re-check the directory every time: repointing
        # MXTPU_TELEMETRY_DIR mid-process (a second run/experiment)
        # must move the event log WITH the snapshots, not silently
        # split the export across both directories
        if _log is None or _log.dir != d:
            if _log is not None and _log._f is not None:
                _log._f.close()
            from .. import config
            _log = _EventLog(d,
                             config.get("MXTPU_TELEMETRY_ROTATE_BYTES"))
    return _log


def reset_exporter():
    """Drop the cached event log (tests that repoint
    MXTPU_TELEMETRY_DIR between cases)."""
    global _log
    with _lock:
        if _log is not None and _log._f is not None:
            _log._f.close()
        _log = None


def release():
    """Close the event log's open file, keeping its place: the next
    event reopens the same segment. A run's end calls it (the timeline's
    close, a batcher's stop) so that turning export off afterwards
    leaves no file open."""
    with _lock:
        if _log is not None and _log._f is not None:
            _log._f.close()
            _log._f = None


def emit_event(kind, **fields):
    """Append one event line (no-op unless MXTPU_TELEMETRY_DIR is set).
    Never raises: export failure counts ``telemetry.write_errors`` and
    the caller's step/batch proceeds."""
    if not enabled():
        return False
    try:
        _get_log().emit(kind, fields)
        return True
    except Exception:
        try:
            from .. import fault
            fault.count("telemetry.write_errors")
        except Exception:
            pass
        return False


def export_snapshot(tag=None, directory=None, reset=False):
    """Write the full unified report atomically as
    ``snapshot-<tag|ts>.json``; returns the path (None when disabled
    or failed). These files are the inputs to ``tools/telemetry.py
    diff``."""
    d = directory or telemetry_dir()
    if not d:
        return None
    try:
        tree = registry.report(reset=reset)
        name = tag if tag else f"{time.time():.0f}"
        name = re.sub(r"[^A-Za-z0-9._-]", "_", str(name))
        path = os.path.join(d, f"snapshot-{name}.json")
        os.makedirs(d, exist_ok=True)
        from ..base import atomic_write
        with atomic_write(path, mode="w") as f:
            json.dump(tree, f, indent=1, default=str)
        return path
    except Exception:
        try:
            from .. import fault
            fault.count("telemetry.write_errors")
        except Exception:
            pass
        return None


def read_events(directory=None, skip_torn=True):
    """Parse every event across the rotated segments, oldest first.
    Returns ``(events, torn)`` — torn counts unparseable lines (at most
    the final line of a segment a kill tore; readers never fail on
    them)."""
    events, torn = [], 0
    for path in event_files(directory):
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        torn += 1
                        if not skip_torn:
                            raise
        except OSError:
            continue
    return events, torn


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name):
    return "mxtpu_" + _PROM_BAD.sub("_", name)


def render_prometheus(snapshot=None):
    """The registry as Prometheus text format. Counters/gauges map
    directly; timers/histograms expose ``_count``/``_sum`` (+quantile
    series for histograms) in the summary-metric convention."""
    snap = registry.snapshot() if snapshot is None else snapshot
    lines = []
    for name, m in snap.items():
        base = _prom_name(name)
        kind = m.get("kind")
        if kind in ("counter", "gauge"):
            prom_kind = "counter" if kind == "counter" else "gauge"
            lines.append(f"# TYPE {base} {prom_kind}")
            lines.append(f"{base} {float(m['value'])}")
        elif kind in ("timer", "histogram"):
            lines.append(f"# TYPE {base} summary")
            lines.append(f"{base}_count {int(m['count'])}")
            lines.append(f"{base}_sum {float(m['total'])}")
            if kind == "histogram":
                for q, key in ((0.5, "p50"), (0.99, "p99")):
                    v = m.get(key)
                    if v is not None:
                        lines.append(
                            f"{base}{{quantile=\"{q}\"}} {float(v)}")
    return "\n".join(lines) + "\n"
