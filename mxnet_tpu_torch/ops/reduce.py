"""Reductions (counterpart of ``mxnet_tpu/ops/reduce.py``; reference:
broadcast_reduce_op_value.cc / _index.cc): sum, mean, max, min, norm,
argmax, argmin and pick, with ``axis`` / ``keepdims`` / ``exclude``."""
from __future__ import annotations

import torch

from .registry import register_op


def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % ndim for a in axis)
    if exclude:
        axis = tuple(a for a in range(ndim) if a not in axis)
    return axis


def _reduce(fn):
    def impl(data, axis=None, keepdims=False, exclude=False, **kw):
        ax = _norm_axis(axis, data.dim(), exclude)
        if ax == ():
            return data          # no axis left: nothing to reduce
        if ax is None:
            ax = tuple(range(data.dim()))
        return fn(data, dim=ax, keepdim=bool(keepdims))
    return impl


# result dtypes of the JAX package's integer sums (jnp.sum without x64):
# narrower integers widen to 32 bits, int32 and uint32 keep their type;
# torch.sum gives int64 for every integer input
_SUM_DTYPES = {torch.bool: torch.int32, torch.int8: torch.int32,
               torch.int16: torch.int32, torch.int32: torch.int32,
               torch.uint8: torch.uint32, torch.uint16: torch.uint32,
               torch.uint32: torch.uint32}


def _sum(data, dim, keepdim):
    out = torch.sum(data, dim=dim, keepdim=keepdim)
    want = _SUM_DTYPES.get(data.dtype)
    return out if want is None else out.to(want)


def _mean(data, dim, keepdim):
    """The mean of an integer or bool array is float32 and, as jnp.mean's
    on XLA, the float32 sum times the float32 reciprocal of the count."""
    if data.is_floating_point() or data.is_complex():
        return torch.mean(data, dim=dim, keepdim=keepdim)
    n = 1
    for d in dim:
        n *= data.shape[d]
    return torch.sum(data.to(torch.float32), dim=dim, keepdim=keepdim) \
        * (1.0 / n)


register_op("sum", aliases=["sum_axis"])(_reduce(_sum))
register_op("mean")(_reduce(_mean))
register_op("max", aliases=["max_axis"])(_reduce(torch.amax))
register_op("min", aliases=["min_axis"])(_reduce(torch.amin))


@register_op("norm")
def norm(data, ord=2, axis=None, keepdims=False, **kw):
    ax = _norm_axis(axis, data.dim())
    ax = tuple(range(data.dim())) if ax is None else ax
    if ord == 1:
        return torch.sum(torch.abs(data), dim=ax, keepdim=bool(keepdims))
    return torch.sqrt(torch.sum(torch.square(data), dim=ax,
                                keepdim=bool(keepdims)))


def _index_reduce(fn):
    def impl(data, axis=None, keepdims=False, **kw):
        if axis is None:
            out = fn(data.reshape(-1), dim=0)
        else:
            out = fn(data, dim=axis, keepdim=bool(keepdims))
        return out.to(torch.float32)   # float indices, as the reference
    return impl


register_op("argmax")(_index_reduce(torch.argmax))
register_op("argmin")(_index_reduce(torch.argmin))


@register_op("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip", **kw):
    """Elements along ``axis`` at ``index`` (reference: pick,
    broadcast_reduce_op_index.cc); out-of-range indices clip or wrap."""
    axis = axis % data.dim()
    n = data.shape[axis]
    idx = index.to(torch.int64)
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx.remainder(n)
    picked = torch.gather(data, axis, idx.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)


def _prod(data, dim, keepdim):
    """The product over the axes ``dim``: moved last and flattened into
    one, since ``torch.prod`` takes one axis. Its gradient is finite
    where inputs are zero, as ``jax.grad``'s."""
    n = data.dim()
    d = tuple(sorted(dim))
    moved = torch.movedim(data, d, tuple(range(n - len(d), n)))
    out = moved.reshape(tuple(moved.shape[:n - len(d)]) + (-1,)).prod(-1)
    if keepdim:
        out = out.reshape(tuple(1 if i in d else s
                                for i, s in enumerate(data.shape)))
    want = _SUM_DTYPES.get(data.dtype)
    return out if want is None else out.to(want)


def _nanprod(data, dim, keepdim):
    return _prod(torch.where(torch.isnan(data), torch.ones_like(data), data),
                 dim, keepdim)


register_op("prod")(_reduce(_prod))
register_op("nansum")(_reduce(torch.nansum))
register_op("nanprod")(_reduce(_nanprod))


@register_op("argmax_channel", no_grad=True)
def argmax_channel(data, **kw):
    """The argmax over axis 1, as float indices."""
    return torch.argmax(data, dim=1).to(torch.float32)


# the broadcasting "expand" ops (with the reductions in the reference);
# each result is materialized, so later in-place writes see one element
# per location, as a JAX array's value
@register_op("broadcast_to")
def broadcast_to(data, shape=None, **kw):
    """``data`` broadcast to ``shape``; a 0 in ``shape`` keeps that
    dimension."""
    tgt = tuple(int(s) if int(s) != 0 else d
                for s, d in zip(shape, data.shape))
    return data.expand(tgt).contiguous()


@register_op("broadcast_axis", aliases=["broadcast_axes"])
def broadcast_axis(data, axis=(), size=(), **kw):
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    tgt = list(data.shape)
    for a, s in zip(axis, size):
        tgt[a % data.dim()] = int(s)
    return data.expand(tuple(tgt)).contiguous()


@register_op("broadcast_like")
def broadcast_like(lhs, rhs, **kw):
    return lhs.expand(tuple(rhs.shape)).contiguous()
