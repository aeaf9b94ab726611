"""Fault-tolerance observability: process-wide counters and
``fault_report`` (counterpart of ``mxnet_tpu/fault.py``).

The one sink the fault-tolerance mechanisms report into: the
non-finite step guard (``module/fused.py``), the CheckpointManager
(``checkpoint.py``) and the fault-injection harness
(``faultinject.py``). ``mxnet_tpu_torch.fault_report()`` is the one sync
point: it reads the guards' device counters (the guard itself never
syncs the host per step).

The JAX package keeps these counters in its telemetry registry; the
port has none yet (ROADMAP queue A item 5), so they live in a dict under
a lock, and ``reset=True`` snapshots and clears them under it.
"""
from __future__ import annotations

import threading
import weakref

__all__ = ["count", "counters", "register_guard", "fault_report"]

_lock = threading.Lock()
_counters = {}
_guards = []        # weakrefs to live FusedSymbolStep instances


def count(name, delta=1):
    """Bump a named counter (dot-namespaced: ``ckpt.saves``,
    ``injected.nan_grad``, ...)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + delta



def counters():
    with _lock:
        return dict(_counters)


def register_guard(step):
    """Track a live FusedSymbolStep; ``fault_report`` sums the skip
    counters over every live one."""
    with _lock:
        _guards[:] = [wr for wr in _guards if wr() is not None]
        _guards.append(weakref.ref(step))


def fault_report(reset=False):
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
    with _lock:
        cs = dict(_counters)
        if reset:
            _counters.clear()

    def _sub(prefix):
        plen = len(prefix) + 1
        return {k[plen:]: v for k, v in cs.items()
                if k.startswith(prefix + ".")}

    return {"skipped_steps": skipped, "consecutive_skips": consec,
            "guard_active": guard_active, "checkpoint": _sub("ckpt"),
            "dist": _sub("dist"), "injected": _sub("injected")}
