"""Per-program device-memory accounting of the captured CUDA graphs
(counterpart of ``mxnet_tpu/telemetry/memory.py``).

The JAX package reads XLA's buffer assignment off every compiled
executable (``memory_analysis()``). A CUDA graph has no such analysis;
what it holds is the memory pool its capture allocated from. So
:class:`~mxnet_tpu_torch.compile.registry.CapturedProgram` reads the
caching allocator just before its capture starts and right after it
ends (never during it: a call inside a capture is one the capture must
not see), and :func:`analyze` turns that into a row:

- ``pool_bytes``: the segments of the graph's memory pool after the
  capture (``torch.cuda.memory_snapshot()``, the segments whose
  ``segment_pool_id`` is the graph's pool): its intermediates and
  outputs. A predictor's buckets share one pool, so each bucket's row
  shows the whole pool as it stood after that bucket's capture;
- ``pool_gained_bytes``: what that pool gained across this capture;
- ``argument_bytes``: the program's static input buffers plus the state
  it reads in place (the fused step's flat masters, optimizer state and
  aux; a predictor's parameters), each storage once;
- ``output_bytes``: the captured outputs (they live in the pool);
- ``temp_bytes``: ``pool_bytes - output_bytes``;
- ``peak_bytes``: ``argument_bytes + pool_bytes``, the derived working
  set of one replay.

The row is recorded once, right after the capture ends, from the program
in hand: never from a second capture. On the CPU a program is not
captured and :func:`analyze` returns ``{}``, as the JAX package's does
for a backend without ``memory_analysis``; nothing is recorded.

Exposed as ``memory_report()`` (per-program rows and the process view),
the ``mem::`` gauges (``mem::process_peak_bytes``, ``mem::programs``,
per-program ``mem::<name>::peak_bytes``) in the flat registry, and the
``decode_state`` row a ``DecodePredictor`` records for its KV-cache.
"""
from __future__ import annotations

import threading

from . import registry

__all__ = ["analyze", "record", "programs", "process_peak",
           "memory_report", "reset", "pool_reading", "tensor_bytes"]

_lock = threading.Lock()
_programs = {}       # digest -> {name, kind, digest, ...bytes}


def pool_reading(pool):
    """Bytes of the segments of memory pool ``pool`` (a graph pool
    handle; 0 for None, a pool not made yet). A read of the caching
    allocator's state on the host (``torch.cuda.memory_snapshot()``), no
    device call; taken before and after a capture, never inside one."""
    if pool is None:
        return 0
    import torch
    pid = tuple(pool)
    return int(sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pid))


def tensor_bytes(tensors):
    """Bytes of the distinct storages behind ``tensors`` (views of one
    flat buffer count once)."""
    seen = {}
    for t in tensors:
        if t is None or not hasattr(t, "untyped_storage"):
            continue
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def analyze(prog):
    """The memory row of one captured program as a plain dict (see the
    module docstring), or ``{}`` when it was not captured (the CPU).
    Pure read: no capture, no device call."""
    before = getattr(prog, "pool_before", None)
    after = getattr(prog, "pool_after", None)
    if not getattr(prog, "captured", False) or before is None or \
            after is None:
        return {}
    outs = prog.outputs
    if outs is None:
        outs = []
    elif not isinstance(outs, (list, tuple)):
        outs = [outs]
    flat = []
    for o in outs:
        flat.extend(o if isinstance(o, (list, tuple)) else [o])
    pool = after
    args = list(getattr(prog, "arguments", None) or ())
    static = prog.static
    if isinstance(static, dict):
        args.extend(static.values())
    elif isinstance(static, (list, tuple)):
        args.extend(static)
    elif static is not None:
        args.append(static)
    out_b = tensor_bytes(flat)
    arg_b = tensor_bytes(args)
    return {"argument_bytes": arg_b, "output_bytes": out_b,
            "temp_bytes": max(0, pool - out_b), "pool_bytes": pool,
            "pool_gained_bytes": max(0, pool - before),
            "peak_bytes": arg_b + pool}


def record(name, kind, digest, prog_or_stats):
    """Record one program's memory row (keyed by digest, so a program of
    the same key overwrites rather than duplicates). Returns the stats
    dict (``{}`` when there is none: nothing is recorded)."""
    stats = (dict(prog_or_stats) if isinstance(prog_or_stats, dict)
             else analyze(prog_or_stats))
    if not stats:
        return {}
    row = {"name": str(name), "kind": str(kind),
           "digest": str(digest)[:12], **stats}
    with _lock:
        _programs[str(digest)] = row
        progs = list(_programs.values())
    _refresh_gauges(progs)
    return stats


def _refresh_gauges(progs):
    registry.gauge("mem::programs").set(len(progs))
    registry.gauge("mem::process_peak_bytes").set(
        max((p["peak_bytes"] for p in progs), default=0))
    registry.gauge("mem::donation_saved_bytes").set(
        sum(p.get("donation_saved_bytes", 0) for p in progs))
    for p in progs:
        registry.gauge(f"mem::{p['name']}::peak_bytes").set(p["peak_bytes"])


def programs():
    """Recorded per-program rows, largest peak first."""
    with _lock:
        rows = [dict(p) for p in _programs.values()]
    rows.sort(key=lambda p: (-p.get("peak_bytes", 0), p["name"]))
    return rows


def process_peak():
    """max over recorded programs' ``peak_bytes`` (0 when none)."""
    with _lock:
        return max((p.get("peak_bytes", 0)
                    for p in _programs.values()), default=0)


def _collect(reset=False):
    rows = programs()
    tree = {
        "programs": rows,
        "process": {
            "programs": len(rows),
            "peak_bytes": max((p.get("peak_bytes", 0) for p in rows),
                              default=0),
            "donation_saved_bytes": sum(
                p.get("donation_saved_bytes", 0) for p in rows),
            "temp_bytes": sum(p.get("temp_bytes", 0) for p in rows),
        },
    }
    if reset:
        with _lock:
            _programs.clear()
        registry.remove("mem::")
    return tree


memory_report = registry.collector_view("memory", _collect)


def reset():
    """Drop every recorded program and the ``mem::`` gauges (tests)."""
    _collect(reset=True)
