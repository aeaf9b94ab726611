"""Elementwise ops (counterpart of ``mxnet_tpu/ops/elemwise.py``): the
residual add of the symbol paths, and the unary math, broadcasting
binary, comparison, logical and scalar ops behind NDArray's operators,
the Gluon layers and losses and the legacy symbol names. Comparisons and
logical ops return 0/1 in the left operand's dtype, as the reference's
do. ``rint`` rounds half to even and ``fix`` toward zero, as the JAX
package's ``jnp.rint`` / ``jnp.trunc``; ``gamma`` is ``exp(gammaln)``
(|Γ| for negative inputs), as there."""
from __future__ import annotations

import torch

from .registry import register_op, alias


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


class _Abs(torch.autograd.Function):
    """``|x|`` with JAX's gradient: the cotangent where ``x >= 0`` (0 and
    -0 included), its negation elsewhere (``torch.abs`` gives 0 at 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x):
    return _Abs.apply(x) if x.is_floating_point() else torch.abs(x)


class _Pow(torch.autograd.Function):
    """``x ** y`` with JAX's gradients (``lax.pow``'s float rules): base
    ``y x^(y-1)`` everywhere (NaN at x = y = 0, where ``torch.pow`` gives
    0), exponent ``log(x or 1) x^y``."""

    @staticmethod
    def forward(ctx, x, y):
        out = torch.pow(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, out = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = (g * (y * torch.pow(x, y - 1))).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            one = torch.ones((), dtype=x.dtype, device=x.device)
            gy = (g * (torch.log(torch.where(x == 0, one, x)) * out)) \
                .sum_to_size(y.shape)
        return gx, gy


def power(x, y):
    if x.is_floating_point() and y.is_floating_point() \
            and x.dtype == y.dtype:
        return _Pow.apply(x, y)
    return torch.pow(x, y)


def hypot(x, y):
    """``jnp.hypot`` operation for operation, so its gradient is JAX's
    (finite at (0, 0), where ``torch.hypot``'s is NaN)."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if not y.is_floating_point():
        y = y.to(x.dtype)
    x, y = abs_(x), abs_(y)
    inf = torch.isposinf(x) | torch.isposinf(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    one = torch.ones((), dtype=hi.dtype, device=hi.device)
    r = hi * torch.sqrt(1 + torch.square(lo / torch.where(hi == 0, one, hi)))
    out = torch.where(hi == 0, hi, r)
    return torch.where(inf, torch.full((), float("inf"), dtype=out.dtype,
                                       device=out.device), out)


_UNARY = {
    "abs": abs_, "sign": torch.sign, "square": torch.square,
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "negative": torch.neg, "relu": torch.relu, "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "rint": torch.round, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "fix": torch.trunc,
    "rsqrt": torch.rsqrt, "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "log10": torch.log10, "log2": torch.log2, "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "erf": torch.erf, "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "reciprocal": torch.reciprocal,
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
}

for _name, _fn in _UNARY.items():
    register_op(_name)((lambda f: lambda data, **kw: f(data))(_fn))

alias("relu", "Relu")
register_op("identity", aliases=["_copy"])(lambda data, **kw: data)
register_op("BlockGrad", aliases=["stop_gradient"])(
    lambda data, **kw: data.detach())
# the JAX package's MakeLoss is the identity: grad_scale, normalization
# and valid_thresh are accepted and ignored (ROADMAP C-ref-8)
register_op("make_loss", aliases=["MakeLoss"])(lambda data, **kw: data)


@register_op("add_n", aliases=["ElementWiseSum", "_sum"])
def add_n(*args, num_args=None, **kw):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register_op("smooth_l1")
def smooth_l1(data, scalar=1.0, **kw):
    """0.5 s² x² where |x| < 1/s², else |x| - 0.5/s² (reference:
    mshadow_op.h smooth_l1)."""
    s2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data * data,
                       absd - 0.5 / s2)


@register_op("broadcast_add", aliases=["elemwise_add", "_add", "_plus",
                                       "_Plus"])
def broadcast_add(lhs, rhs, **kw):
    return torch.add(lhs, rhs)


_BINARY = {
    "broadcast_sub": (torch.sub, ["elemwise_sub", "_sub", "_minus",
                                  "_Minus"]),
    "broadcast_mul": (torch.mul, ["elemwise_mul", "_mul", "_Mul"]),
    "broadcast_div": (torch.div, ["elemwise_div", "_div", "_Div"]),
    "broadcast_mod": (torch.fmod, ["_mod"]),
    "broadcast_power": (power, ["_power", "_Power", "pow"]),
    "broadcast_maximum": (torch.maximum, ["_maximum", "maximum"]),
    "broadcast_minimum": (torch.minimum, ["_minimum", "minimum"]),
    "broadcast_hypot": (hypot, []),
    "arctan2": (torch.atan2, []),
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


def _logical(f):
    """A logical op over nonzero-ness, as ``jnp.logical_*``."""
    return lambda a, b: f(a != 0, b != 0)


for _name, _fn in (("and", torch.logical_and), ("or", torch.logical_or),
                   ("xor", torch.logical_xor)):
    register_op(f"broadcast_logical_{_name}", aliases=[f"_logical_{_name}"],
                no_grad=True)(_cmp(_logical(_fn)))
    register_op(f"_logical_{_name}_scalar",
                aliases=[f"logical_{_name}_scalar"])(
        (lambda f: lambda data, scalar=0.0, **kw:
         f(data != 0, torch.full((), bool(scalar), device=data.device))
         .to(data.dtype))(_fn))


def _scalar_like(s, x):
    """The Python scalar ``s`` as a 0-dim tensor of ``x``'s dtype on its
    device (a fill, never a host copy: it can be captured)."""
    return torch.full((), s, dtype=x.dtype, device=x.device)


def _rpow(x, s):
    return torch.pow(_scalar_like(s, x), x)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.fmod(x, s),
    "_rmod_scalar": lambda x, s: torch.fmod(_scalar_like(s, x), x),
    "_power_scalar": lambda x, s: x ** s,
    "_rpower_scalar": _rpow,
    "_maximum_scalar": lambda x, s: torch.maximum(x, _scalar_like(s, x)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _scalar_like(s, x)),
}
for _name, _fn in _SCALAR.items():
    register_op(_name, aliases=[_name.lstrip("_")])(
        (lambda f: lambda data, scalar=0.0, **kw: f(data, scalar))(_fn))


@register_op("Cast", aliases=["cast"])
def cast(data, dtype="float32", **kw):
    from ..dtype import resolve_dtype
    return data.to(resolve_dtype(dtype))
