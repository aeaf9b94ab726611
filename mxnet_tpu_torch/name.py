"""Automatic naming of Symbols (a copy of ``mxnet_tpu/name.py``, so the
port's automatic names come out identical).

Reference: python/mxnet/name.py — ``NameManager`` (counter-based auto names)
and ``Prefix`` (prepend a prefix within a scope).
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Assigns unique names per op-type hint (reference: name.py:25)."""

    _current_tls = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = f"{hint}{self._counter[hint]}"
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = getattr(NameManager._current_tls, "value", None)
        NameManager._current_tls.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current_tls.value = self._old_manager


class _CurrentProxy:
    """``NameManager.current`` — the active manager (thread-local)."""

    def get(self, name, hint):
        mgr = getattr(NameManager._current_tls, "value", None)
        if mgr is None:
            mgr = NameManager()
            NameManager._current_tls.value = mgr
        return mgr.get(name, hint)


NameManager.current = _CurrentProxy()


class Prefix(NameManager):
    """Auto-names with a fixed prefix (reference: name.py:70)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
