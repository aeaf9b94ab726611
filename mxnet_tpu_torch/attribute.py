"""Attribute scoping for symbols (a copy of ``mxnet_tpu/attribute.py``).

``with AttrScope(ctx_group='dev1'):`` annotates symbols created inside;
the annotations travel in each node's ``user_attrs``.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]


class AttrScope:
    """(reference: attribute.py:27)"""

    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be a string")
        self._attr = {f"__{k}__" if not k.startswith("__") else k: v
                      for k, v in kwargs.items()}

    def get(self, attr=None):
        if attr:
            ret = self._attr.copy()
            ret.update(attr)
            return ret
        return self._attr.copy()

    def __enter__(self):
        self._old_scope = getattr(AttrScope._current, "value", None)
        attr = self._attr.copy()
        if self._old_scope is not None:
            merged = self._old_scope._attr.copy()
            merged.update(attr)
            self._attr = merged
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope


def apply_scope_attrs(node):
    """Merge the active AttrScope's attributes into a graph node's
    user_attrs (single definition for ops and variables — reference:
    symbol creation + Variable both consult AttrScope.current)."""
    scope_attrs = current_attrs()
    if scope_attrs:
        merged = dict(scope_attrs)
        merged.update(node.user_attrs)  # explicit attrs win over scope
        node.user_attrs = merged


def current_attrs():
    scope = getattr(AttrScope._current, "value", None)
    return scope._attr.copy() if scope is not None else {}
