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


register_op("sum", aliases=["sum_axis"])(_reduce(torch.sum))
register_op("mean")(_reduce(torch.mean))
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
