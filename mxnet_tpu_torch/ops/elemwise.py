"""Elementwise ops (counterpart of ``mxnet_tpu/ops/elemwise.py``): the
residual add of the symbol paths, and the unary, broadcasting binary,
comparison and scalar ops behind NDArray's operators and the Gluon
layers and losses. Comparisons return 0/1 in the left operand's dtype,
as the reference's do."""
from __future__ import annotations

import torch

from .registry import register_op

_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "square": torch.square,
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "negative": torch.neg, "relu": torch.relu, "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}

for _name, _fn in _UNARY.items():
    register_op(_name)((lambda f: lambda data, **kw: f(data))(_fn))


@register_op("broadcast_add", aliases=["elemwise_add", "_plus"])
def broadcast_add(lhs, rhs, **kw):
    return torch.add(lhs, rhs)


_BINARY = {
    "broadcast_sub": (torch.sub, ["elemwise_sub", "_minus"]),
    "broadcast_mul": (torch.mul, ["elemwise_mul", "_mul"]),
    "broadcast_div": (torch.div, ["elemwise_div", "_div"]),
    "broadcast_mod": (torch.fmod, ["_mod"]),
    "broadcast_power": (torch.pow, ["_power", "pow"]),
    "broadcast_maximum": (torch.maximum, ["_maximum", "maximum"]),
}
for _name, (_fn, _al) in _BINARY.items():
    register_op(_name, aliases=_al)(
        (lambda f: lambda lhs, rhs, **kw: f(lhs, rhs))(_fn))


def _cmp(f):
    def impl(lhs, rhs, **kw):
        return f(lhs, rhs).to(lhs.dtype)
    return impl


for _name, _fn in (("equal", torch.eq), ("not_equal", torch.ne),
                   ("greater", torch.gt), ("greater_equal", torch.ge),
                   ("lesser", torch.lt), ("lesser_equal", torch.le)):
    register_op("broadcast_" + _name, aliases=["_" + _name])(_cmp(_fn))
    register_op(f"_{_name}_scalar", aliases=[f"{_name}_scalar"])(
        (lambda f: lambda data, scalar=0.0, **kw:
         f(data, scalar).to(data.dtype))(_fn))


def _rpow(x, s):
    return torch.pow(torch.as_tensor(s, dtype=x.dtype, device=x.device), x)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.fmod(x, s),
    "_rmod_scalar": lambda x, s: torch.fmod(
        torch.as_tensor(s, dtype=x.dtype, device=x.device), x),
    "_power_scalar": lambda x, s: x ** s,
    "_rpower_scalar": _rpow,
}
for _name, _fn in _SCALAR.items():
    register_op(_name, aliases=[_name.lstrip("_")])(
        (lambda f: lambda data, scalar=0.0, **kw: f(data, scalar))(_fn))


@register_op("Cast", aliases=["cast"])
def cast(data, dtype="float32", **kw):
    from ..dtype import resolve_dtype
    return data.to(resolve_dtype(dtype))
