"""Operator registry (counterpart of ``mxnet_tpu/ops/registry.py``).

Each op is a plain function over torch tensors, ``fn(*tensors, **attrs)
-> tensor | tuple``, registered under its MXNet name. The symbol layer
builds graph nodes from the same table. An op registered ``no_grad``
(the index outputs, the samplers, the creation ops and the update ops)
records no gradient: the ``nd`` dispatch runs it outside autograd, as
the JAX package's does.
"""
from __future__ import annotations

import ast

__all__ = ["OpDef", "register_op", "get_op", "has_op", "alias", "parse_attr"]

_OPS = {}


class OpDef:
    __slots__ = ("name", "fn", "aliases", "no_grad", "num_outputs")

    def __init__(self, name, fn, aliases=(), no_grad=False, num_outputs=1):
        self.name = name
        self.fn = fn
        self.aliases = tuple(aliases)
        self.no_grad = no_grad
        self.num_outputs = num_outputs


def register_op(name, aliases=(), no_grad=False, num_outputs=1):
    """Register an operator implementation under its MXNet name(s)."""

    def _reg(fn):
        opdef = OpDef(name, fn, aliases, no_grad, num_outputs)
        _OPS[name] = opdef
        for a in aliases:
            _OPS[a] = opdef
        return fn

    return _reg


def get_op(name):
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError(f"Operator '{name}' is not registered in "
                       "mxnet_tpu_torch") from None


def has_op(name):
    return name in _OPS


def alias(existing, *names):
    """Register more names for an existing op."""
    for n in names:
        _OPS[n] = _OPS[existing]


def parse_attr(value):
    """Parse a string-typed attribute as it appears in Symbol JSON
    (kernel="(3, 3)", no_bias="True", num_hidden="64")."""
    if not isinstance(value, str):
        return value
    v = value.strip()
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return value
