"""Profiler facade (counterpart of ``mxnet_tpu/profiler.py``; reference:
python/mxnet/profiler.py:28-400). Two layers:

- **Device tracing** rides ``torch.profiler``: ``set_state("run")``
  starts a ``torch.profiler.profile`` with the CPU activity and, where
  CUDA is available, the CUDA activity (CUPTI: the kernels of a CUDA
  graph replay appear one by one). ``set_state("stop")`` (and ``dump()``)
  stops it and writes its Chrome trace into the directory the JAX
  package names, ``<filename minus .json>_trace/``, as
  ``profile-<pid>-NNN.json`` (Perfetto / chrome://tracing). While it
  runs, ``Domain`` tasks and the telemetry trace spans enter
  ``torch.profiler.record_function`` under ``<domain>::<name>``, so the
  host's names line up with the card's kernels. A profiler that fails
  to start raises: tracing is never switched off behind the caller's
  back.
- **Host-side op aggregation**: the reference's "aggregate stats" table
  (operator name -> count, total / min / max ms) by timing the
  imperative op dispatch (``ndarray._PROFILE_HOOK``). It times host
  dispatch, not device time (the card runs asynchronously; per-kernel
  device time is in the trace above).

Both host-side stores live in the telemetry registry: span / op
aggregates are registry ``Timer`` metrics under ``prof::`` and
:class:`Counter` values are registry gauges, so ``counters()``,
``telemetry.report()`` and every subsystem mirror (``data::wait_s``,
``ft::skipped_steps``) read one store, and ``dumps(reset=True)`` is the
registry's atomic snapshot-and-clear.

Also provides the Domain / Task / Frame / Event / Counter / Marker
object API (reference: profiler.py:151-400) and the deprecated
``profiler_set_config`` / ``profiler_set_state`` / ``dump_profile``.
"""
from __future__ import annotations

import atexit
import json
import os
import time
import threading
from typing import Dict, Optional

from .base import MXNetError
from .telemetry import registry as _treg

__all__ = ["set_config", "set_state", "dump", "dumps", "pause", "resume",
           "state", "counters", "Domain", "Task", "Frame", "Event",
           "Counter", "Marker"]

_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": False,
    "profile_imperative": False,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": False,
}
_state = "stop"
_trace_dir: Optional[str] = None
_prof = None               # the running torch.profiler.profile
_dumps_written = 0
_paused = False
_state_lock = threading.Lock()

# aggregate entries live in the telemetry registry as Timers under this
# namespace; dumps() strips it so table keys stay the bare op/span names
_PROF = "prof::"


def _agg_record(name, dt):
    _treg.timer(_PROF + name).record(dt)


def set_config(**kwargs):
    """Configure the profiler (reference: profiler.py:28-59). Recognized
    keys: filename (trace output dir/file), profile_all, profile_symbolic,
    profile_imperative, profile_memory, profile_api, aggregate_stats."""
    for k, v in kwargs.items():
        if k not in _config:
            raise ValueError(f"unknown profiler config key {k!r}")
        _config[k] = v


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """Deprecated alias (reference: profiler.py:60)."""
    set_config(filename=filename,
               profile_symbolic="symbolic" in (mode, "all"),
               profile_all=mode == "all")


def state():
    return _state


def set_state(state="stop"):
    """Start/stop profiling (reference: profiler.py:79-91).

    ``"run"`` starts a ``torch.profiler.profile`` (CPU and, with CUDA,
    CUDA activities) and turns on host-side op aggregation when
    ``aggregate_stats`` is configured; a profiler that fails to start
    raises ``MXNetError``. ``"stop"`` stops it and writes its Chrome
    trace into :func:`trace_dir`."""
    global _state, _trace_dir, _prof
    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    with _state_lock:
        if state == _state:
            return
        if state == "run":
            base = _config["filename"]
            # the reference writes one JSON file; the trace goes into a
            # directory beside it, as in the JAX package
            _trace_dir = base if not base.endswith(".json") else \
                base[:-len(".json")] + "_trace"
            os.makedirs(_trace_dir, exist_ok=True)
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            try:
                prof.start()
            except Exception as e:
                raise MXNetError(
                    f"profiler.set_state('run'): torch.profiler failed to "
                    f"start: {e}") from e
            _prof = prof
            _install_op_timer()
            _state = state
        else:
            _uninstall_op_timer()
            prof, _prof = _prof, None
            _state = state
            if prof is not None:
                prof.stop()
                _write_trace(prof)


def _write_trace(prof):
    global _dumps_written
    _dumps_written += 1
    path = os.path.join(_trace_dir, f"profile-{os.getpid()}-"
                                    f"{_dumps_written:03d}.json")
    prof.export_chrome_trace(path)
    return path


def profiler_set_state(state="stop"):
    """Deprecated alias (reference: profiler.py:92)."""
    set_state(state)


def pause():
    """Suspend aggregation inside a run (reference: profiler.py:141)."""
    global _paused
    _paused = True


def resume():
    global _paused
    _paused = False


def dump(finished=True):
    """Stop tracing and flush (reference: profiler.py:105-118): the
    Chrome trace lands in :func:`trace_dir` when the profiler stops; the
    aggregate table is returned by ``dumps()``."""
    if _state == "run" and finished:
        set_state("stop")


def dump_profile():
    """Deprecated alias (reference: profiler.py:119)."""
    dump(True)


def aggregate(reset=False):
    """The aggregate table as ``{name: (count, total_s, min_s, max_s)}``
    — one atomic registry snapshot (``reset=True`` clears in the same
    lock acquisition, so a concurrent span/op can never land in neither
    or both windows). Zero-count rows (a handle created but nothing
    recorded this window, e.g. right after a reset) are omitted: they
    carry no data and their undefined min must never render as
    ``inf``."""
    snap = _treg.snapshot(reset=reset, prefix=_PROF,
                          kinds=("timer", "histogram"))
    return {name[len(_PROF):]: (m["count"], m["total"], m["min"], m["max"])
            for name, m in snap.items() if m["count"]}


def dumps(reset=False, format="table"):
    """Return aggregate operator stats (reference: profiler.py:127-140;
    native aggregate_stats.cc table). Rows sort by total time
    descending with the name as tiebreaker (stable across identical
    totals); zero-count rows render 0.0, never ``inf``."""
    rows = sorted(aggregate(reset=reset).items(),
                  key=lambda kv: (-kv[1][1], kv[0]))
    if format == "json":
        out = json.dumps({
            name: {"count": int(c), "total_ms": t * 1e3,
                   "min_ms": mn * 1e3, "max_ms": mx * 1e3}
            for name, (c, t, mn, mx) in rows})
    else:
        lines = [f"{'operator':<32}{'count':>8}{'total_ms':>12}"
                 f"{'avg_ms':>10}{'min_ms':>10}{'max_ms':>10}"]
        for name, (c, t, mn, mx) in rows:
            avg = t / c if c else 0.0
            lines.append(f"{name:<32}{int(c):>8}{t * 1e3:>12.3f}"
                         f"{avg * 1e3:>10.3f}{mn * 1e3:>10.3f}"
                         f"{mx * 1e3:>10.3f}")
        out = "\n".join(lines)
    return out


def trace_dir():
    """Directory holding the last profiler trace (None before a run)."""
    return _trace_dir


def trace_files(directory=None):
    """The Chrome traces the profiler wrote into ``directory`` (default
    :func:`trace_dir`), oldest first."""
    import glob
    d = directory or _trace_dir
    if not d:
        return []
    return sorted(glob.glob(os.path.join(d, "profile-*.json")),
                  key=os.path.getmtime)


def _annotating():
    """True while the torch profiler runs: spans then mirror into
    ``record_function``."""
    return _prof is not None and not _paused


def _annotation(name):
    """An entered ``torch.profiler.record_function(name)`` (a host-side
    record; inside a CUDA-graph capture it adds nothing to the graph)."""
    import torch
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


# ---------------------------------------------------------------------------
# op-dispatch timing hook (host-side aggregate table)
# ---------------------------------------------------------------------------
def _install_op_timer():
    if not (_config["aggregate_stats"] or _config["profile_imperative"]
            or _config["profile_all"]):
        return
    from .ndarray import ndarray as _nd_mod
    handles: Dict[str, object] = {}   # op name -> registry Timer

    def timing_hook(impl, name, nd_inputs, attrs):
        if _paused:
            return impl(name, nd_inputs, attrs)
        t0 = time.perf_counter()
        out = impl(name, nd_inputs, attrs)
        dt = time.perf_counter() - t0
        h = handles.get(name)
        if h is None:
            h = handles[name] = _treg.timer(_PROF + name)
        h.record(dt)
        return out

    _nd_mod._PROFILE_HOOK = timing_hook


def _uninstall_op_timer():
    from .ndarray import ndarray as _nd_mod
    _nd_mod._PROFILE_HOOK = None


atexit.register(lambda: _state == "run" and set_state("stop"))


# ---------------------------------------------------------------------------
# object API (reference: profiler.py:151-400)
# ---------------------------------------------------------------------------
class Domain:
    """Profiling domain — a namespace for tasks/counters
    (reference: profiler.py:151)."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_event(self, name):
        return Event(name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)

    def __str__(self):
        return self.name


class _Span:
    """start()/stop() span recorded into the aggregate table and, while
    the profiler runs, as a ``record_function`` in its trace."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._t0 = None
        self._ann = None
        self._timer = None     # registry handle, resolved at first stop

    def start(self):
        self._t0 = time.perf_counter()
        self._ann = _annotation(f"{self.domain}::{self.name}") \
            if _annotating() else None
        return self

    def stop(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            if self._timer is None:
                self._timer = _treg.timer(
                    f"{_PROF}{self.domain}::{self.name}")
            self._timer.record(dt)
            self._t0 = None
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class Task(_Span):
    """(reference: profiler.py:210)"""


class Frame(_Span):
    """(reference: profiler.py:252)"""


class Event(_Span):
    """(reference: profiler.py:294)"""

    def __init__(self, name):
        super().__init__("event", name)


def counters():
    """Last value of every live gauge, keyed ``domain::name`` — how the
    subsystem gauges (``ft::skipped_steps``, ``data::wait_s``,
    ``step::bytes_accessed``…) surface without a trace viewer. Reads
    the one telemetry registry: a :class:`Counter` created here and a
    gauge set anywhere else under the same name are the SAME metric."""
    return {name: m["value"]
            for name, m in _treg.snapshot(kinds=("gauge",)).items()}


class Counter:
    """Numeric counter (reference: profiler.py:330). Backed by a
    telemetry registry gauge named ``domain::name`` — the process-wide
    :func:`counters` table IS the registry's gauge namespace."""

    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        # the registry gauge starts at 0; do NOT zero it here — a
        # second facade over an existing domain::name (the mirrors are
        # the SAME metric) must never erase another producer's value
        self._gauge = _treg.gauge(f"{domain}::{name}")
        if value is not None:
            self.set_value(value)

    @property
    def value(self):
        return self._gauge.get()

    def set_value(self, value):
        self._gauge.set(value)

    def increment(self, delta=1):
        self._gauge.inc(delta)

    def decrement(self, delta=1):
        self._gauge.inc(-delta)

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    """Instant marker (reference: profiler.py:400)."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        # a zero-length record: count advances, totals stay 0 — the
        # reference's instant-marker row in the aggregate table
        _agg_record(f"{self.domain}::{self.name}::marks", 0.0)


def _collect(reset=False):
    """The ``profiler`` subsystem view in ``mx.telemetry.report()``:
    the live gauge table + the aggregate span/op table."""
    return {
        "counters": counters(),
        "aggregate": {
            name: {"count": int(c), "total_s": round(t, 6),
                   "min_s": round(mn, 6), "max_s": round(mx, 6)}
            for name, (c, t, mn, mx) in aggregate(reset=reset).items()},
    }


_treg.register_collector("profiler", _collect)
