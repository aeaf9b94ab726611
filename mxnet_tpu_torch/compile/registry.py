"""Program registry: captured programs and their observability
(counterpart of ``mxnet_tpu/compile/registry.py``).

On the card the counterpart of a compiled XLA program is a CUDA graph.
``FusedSymbolStep`` (module/fused.py) captures one per feed signature,
``serving.Predictor`` one per bucket and ``DecodePredictor``
(serving/decode/engine.py) one per program of kind ``decode`` (prefill
per bucket, decode, verify per width, reprefill), each under a canonical
:class:`~.key.ProgramKey`, through :class:`CapturedProgram`. On the CPU
both run eagerly and still key their programs, so the retrace guard
reports the same events there.

- :class:`ProgramRecord` per key: captures, capture seconds, replays and
  the kernel launches its capture recorded.
- :func:`note_entry_point`: the retrace guard. An entry point (a fused
  step, a predictor bucket) that acquires a program under a new key or
  argument signature after it already held one has retraced; the count
  and what diverged are kept (``changed``: the key materials; where one
  of them is a dict, ``detail`` names its entries, such as
  ``extra.metrics`` for a metric attached to the fused step).
- :func:`compile_report` (exported as ``mxnet_tpu_torch.compile_report``):
  ``programs``, ``retraces``, ``totals`` (``fresh_compiles`` counts
  captures) and ``cache``.

Kernel launch counts: a capture calls each kernel wrapper once and runs
nothing; a replay runs every kernel and calls no wrapper. So the wrapper
calls that launch onto the capturing stream go to a tally of their own
(``ops.fused_bn_conv.capture_tally``), not to the counters, and each
replay adds the tally: the counters say how many kernels ran, also
while other threads launch kernels on their streams during a capture.

Not ported: the persistent program cache (``cache.py``, the ``.mxprog``
files and ``load_or_compile``'s loads). A CUDA graph cannot be
serialized, so every process captures its programs anew.
"""
from __future__ import annotations

import threading
import time

import torch

__all__ = ["ProgramRecord", "CapturedProgram", "note_entry_point",
           "compile_report", "reset", "CACHE_REASON"]

CACHE_REASON = ("a CUDA graph cannot be serialized; every process "
                "captures its programs anew (the persistent .mxprog "
                "cache of the JAX package is not ported)")

_lock = threading.Lock()
_records = {}            # digest -> ProgramRecord
_entry_points = {}       # name -> (ProgramKey, arg_sig)
_retraces = {}           # name -> {"count": int, "events": [...]}
_MAX_RETRACE_EVENTS = 8


class ProgramRecord:
    """Counters of one canonical program (one key digest)."""

    __slots__ = ("name", "kind", "digest", "captures", "capture_s",
                 "replays", "launches", "arg_sig")

    def __init__(self, key):
        self.name = key.name
        self.kind = key.kind
        self.digest = key.digest
        self.captures = 0        # CUDA graphs captured under this key
        self.capture_s = 0.0     # host seconds those captures took
        self.replays = 0
        self.launches = {}       # kernel wrapper -> launches a replay runs
        self.arg_sig = None

    def as_dict(self):
        return {"name": self.name, "kind": self.kind,
                "digest": self.digest[:10], "captures": self.captures,
                "capture_s": round(self.capture_s, 4),
                "replays": self.replays, "launches": dict(self.launches)}


def _ensure(key):
    with _lock:
        rec = _records.get(key.digest)
        if rec is None:
            rec = _records[key.digest] = ProgramRecord(key)
        return rec


def note_entry_point(name, key, sig=None):
    """Retrace guard: an entry point acquiring a program under a NEW key
    or argument signature after it already held one is a retrace; record
    how many and what diverged. Returns the program's record."""
    rec = _ensure(key)
    with _lock:
        rec.arg_sig = sig
        prev = _entry_points.get(name)
        _entry_points[name] = (key, sig)
        if prev is None:
            return rec
        prev_key, prev_sig = prev
        if prev_key.digest == key.digest and prev_sig == sig:
            return rec
        ent = _retraces.setdefault(name, {"count": 0, "events": []})
        ent["count"] += 1
        if len(ent["events"]) < _MAX_RETRACE_EVENTS:
            ev = {"changed": key.diff(prev_key),
                  "from_sig": _sig_summary(prev_sig),
                  "to_sig": _sig_summary(sig)}
            detail = key.diff_detail(prev_key)
            if detail != ev["changed"]:
                # which entries of a dict material (extra.metrics)
                ev["detail"] = detail
            ent["events"].append(ev)
    return rec


def _sig_summary(sig, limit=6):
    if sig is None:
        return None
    sig = list(sig)
    body = [f"{tuple(s)}:{d}" for s, d in sig[:limit]]
    if len(sig) > limit:
        body.append(f"...+{len(sig) - limit}")
    return body


class CapturedProgram:
    """One program of ``key`` as a CUDA graph: ``capture(fn)`` records
    ``fn``'s kernels without running them (its return value, tensors in
    the graph's memory, becomes ``outputs``), ``replay()`` runs them.

    ``pool``: a graph memory pool (``torch.cuda.graph_pool_handle()``)
    shared with other programs that never run at the same time."""

    def __init__(self, key, pool=None):
        self.key = key
        self.record = _ensure(key)
        self.pool = pool
        self.graph = None
        self.outputs = None
        self.launches = {}
        self.static = None       # the caller's static input buffers

    @property
    def captured(self):
        return self.graph is not None

    def capture(self, fn, capture_error_mode="global"):
        """Capture ``fn()`` on the current device. A capture that fails
        raises (the error of ``torch.cuda.graph``); the launch counters
        are left as they were."""
        from ..ops import fused_bn_conv
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        t0 = time.perf_counter()
        with fused_bn_conv.capture_tally(stream) as delta, \
                torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                 capture_error_mode=capture_error_mode):
            out = fn()
        secs = time.perf_counter() - t0
        self.graph, self.outputs, self.launches = graph, out, delta
        with _lock:
            rec = self._live_record()
            rec.captures += 1
            rec.capture_s += secs
            rec.launches = dict(delta)
        return out

    def _live_record(self):
        """The registry's record of this key; after a ``reset()`` a new
        one that counts from there (call under ``_lock``)."""
        rec = _records.get(self.key.digest)
        if rec is None:
            rec = _records[self.key.digest] = ProgramRecord(self.key)
            rec.launches = dict(self.launches)
        self.record = rec
        return rec

    def replay(self):
        """Run the captured kernels on the current stream (asynchronous,
        like a launch); the counters gain the capture's launches."""
        from ..ops import fused_bn_conv
        self.graph.replay()
        fused_bn_conv.add_counts(self.launches)
        with _lock:
            self._live_record().replays += 1


def compile_report(reset=False):
    """Program observability (``mxnet_tpu_torch.compile_report()``):

    - ``programs``: one row per canonical program (captures, capture
      seconds, replays, kernel launches per replay);
    - ``retraces``: per entry point, how often it acquired a program
      anew, with the key materials and signatures that diverged;
    - ``totals``: summed counters (``fresh_compiles`` counts captures);
    - ``cache``: the persistent cache, which does not apply here.

    ``reset=True`` reads and clears under one lock acquisition."""
    with _lock:
        programs = [r.as_dict() for r in _records.values()]
        retraces = {n: {"count": e["count"], "events": list(e["events"])}
                    for n, e in _retraces.items()}
        if reset:
            _records.clear()
            _entry_points.clear()
            _retraces.clear()
    totals = {
        "programs": len(programs),
        "fresh_compiles": sum(p["captures"] for p in programs),
        "replays": sum(p["replays"] for p in programs),
        "capture_s": round(sum(p["capture_s"] for p in programs), 4),
        "retraces": sum(e["count"] for e in retraces.values()),
    }
    return {
        "programs": sorted(programs,
                           key=lambda p: (-p["capture_s"], p["name"])),
        "retraces": retraces,
        "totals": totals,
        "cache": {"enabled": False, "reason": CACHE_REASON},
    }


def reset():
    """Clear every record and retrace counter. Live programs keep
    running; their records recreate on the next acquisition."""
    with _lock:
        _records.clear()
        _entry_points.clear()
        _retraces.clear()
