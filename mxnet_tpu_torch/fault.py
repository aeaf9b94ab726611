"""Fault-tolerance observability: process-wide counters and
``fault_report`` (counterpart of ``mxnet_tpu/fault.py``).

The one sink the fault-tolerance mechanisms report into: the
non-finite step guard (``module/fused.py``), the CheckpointManager
(``checkpoint.py``) and the fault-injection harness
(``faultinject.py``). ``mxnet_tpu_torch.fault_report()`` is the one sync
point: it reads the guards' device counters (the guard itself never
syncs the host per step).

Counters live in the telemetry registry (telemetry/registry.py) under
the ``fault::`` namespace, so ``fault_report`` is the ``fault`` subtree
of ``telemetry.report()`` and ``reset=True`` is the registry's atomic
snapshot-and-clear: a concurrent ``count()`` lands in exactly one
window. Each read also mirrors the guard's skip total into the
``ft::skipped_steps`` gauge (a profiler ``Counter``), beside the
checkpoint's ``ft::save`` / ``ft::load`` tasks.
"""
from __future__ import annotations

import threading
import weakref

from .telemetry import registry as _treg

__all__ = ["count", "counters", "register_guard", "fault_report"]

_lock = threading.Lock()
_guards = []        # weakrefs to live FusedSymbolStep instances
_PREFIX = "fault::"


def count(name, delta=1):
    """Bump a named counter (dot-namespaced: ``ckpt.saves``,
    ``injected.nan_grad``, ...)."""
    _treg.counter(_PREFIX + name).inc(delta)



def counters():
    snap = _treg.snapshot(prefix=_PREFIX, kinds=("counter",))
    return {k[len(_PREFIX):]: m["value"] for k, m in snap.items()}


def register_guard(step):
    """Track a live FusedSymbolStep; ``fault_report`` sums the skip
    counters over every live one."""
    with _lock:
        _guards[:] = [wr for wr in _guards if wr() is not None]
        _guards.append(weakref.ref(step))


_prof_counter = [None]


def _update_prof_counter(val):
    """Mirror the guard's skip total into the ``ft::skipped_steps``
    registry gauge (through the profiler Counter facade)."""
    from . import profiler
    if _prof_counter[0] is None:
        _prof_counter[0] = profiler.Counter(profiler.Domain("ft"),
                                            "skipped_steps")
    _prof_counter[0].set_value(val)


def _collect(reset=False):
    """Fault-tolerance state:

    - ``skipped_steps`` / ``consecutive_skips``: non-finite training
      steps the in-step guard skipped (summed / maxed over live steps;
      reading them syncs their device counters);
    - ``guard_active``: whether any live step runs the guard;
    - ``checkpoint``: saves, async saves, fallbacks, corrupt checkpoints
      detected, restores, prunes (``ckpt.*`` counters);
    - ``dist``: the transport's retries and fallbacks (empty: the
      port's multi-device transport is not ported);
    - ``injected``: fire counts per fault-injection site.

    ``reset=True`` zeroes the guards' device counters and clears the
    counters after reading them."""
    with _lock:
        guards = [wr() for wr in _guards]
    skipped = consec = 0
    guard_active = False
    for g in guards:
        if g is None or g.fault_state is None:
            continue
        guard_active = guard_active or g.guard_enabled
        total, cons = (int(x) for x in g.fault_state.tolist())
        skipped += total
        consec = max(consec, cons)
        if reset:
            g.reset_fault_state()
    _update_prof_counter(skipped)
    snap = _treg.snapshot(reset=reset, prefix=_PREFIX, kinds=("counter",))
    # a counter that counted nothing in this window is left out
    cs = {k[len(_PREFIX):]: m["value"] for k, m in snap.items()
          if m["value"]}

    def _sub(prefix):
        plen = len(prefix) + 1
        return {k[plen:]: v for k, v in cs.items()
                if k.startswith(prefix + ".")}

    return {"skipped_steps": skipped, "consecutive_skips": consec,
            "guard_active": guard_active, "checkpoint": _sub("ckpt"),
            "dist": _sub("dist"), "injected": _sub("injected")}


fault_report = _treg.collector_view("fault", _collect)
