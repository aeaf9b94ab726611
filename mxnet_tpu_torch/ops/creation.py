"""Array creation and the ordering ops (counterpart of
``mxnet_tpu/ops/creation.py``; reference: init_op.cc, ordering_op.cc).

A creation op has no tensor input, so it takes the device to build on:
``device`` (the symbol walk's, or the ``nd`` call's context), else the
current context's. Index outputs are float32 unless ``dtype`` says
otherwise. The ordering follows the JAX package's, ties included:
``sort`` and ``argsort`` are stable ascending sorts, flipped for
``is_ascend=False`` (so tied values come out with the higher index
first), and ``topk`` gives the lower index first among ties, as
``lax.top_k``.
"""
from __future__ import annotations

import torch

from ..dtype import resolve_dtype
from .registry import register_op


def _device(device):
    if device is not None:
        return torch.device(device)
    from ..context import current_context
    return current_context().device


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else \
        tuple(int(s) for s in shape)


@register_op("_zeros", aliases=["zeros"], no_grad=True)
def zeros(shape=(), ctx=None, dtype="float32", device=None, **kw):
    return torch.zeros(_shape(shape), dtype=resolve_dtype(dtype),
                       device=_device(device))


@register_op("_ones", aliases=["ones"], no_grad=True)
def ones(shape=(), ctx=None, dtype="float32", device=None, **kw):
    return torch.ones(_shape(shape), dtype=resolve_dtype(dtype),
                      device=_device(device))


@register_op("_full", aliases=["full"], no_grad=True)
def full(shape=(), value=0.0, ctx=None, dtype="float32", device=None,
         **kw):
    return torch.full(_shape(shape), value, dtype=resolve_dtype(dtype),
                      device=_device(device))


@register_op("_arange", aliases=["arange"], no_grad=True)
def arange(start=0, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32", infer_range=False, device=None, **kw):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=resolve_dtype(dtype),
                       device=_device(device))
    if int(repeat) != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register_op("_eye", aliases=["eye"], no_grad=True)
def eye(N=0, M=0, k=0, ctx=None, dtype="float32", device=None, **kw):
    n, m = int(N), int(M) if M else int(N)
    dev = _device(device)
    rows = torch.arange(n, device=dev)[:, None] + int(k)
    return (rows == torch.arange(m, device=dev)[None, :]) \
        .to(resolve_dtype(dtype))


@register_op("_linspace", aliases=["linspace"], no_grad=True)
def linspace(start=0.0, stop=1.0, num=50, endpoint=True, ctx=None,
             dtype="float32", device=None, **kw):
    """``start (1 - s) + stop s`` at ``s = i / div`` (div = num - 1 with
    the endpoint, which is then ``stop``, else num), in float32, as
    ``jnp.linspace``."""
    num = int(num)
    dev = _device(device)
    div = (num - 1) if endpoint else num
    if num > 1:
        s = torch.arange(div, dtype=torch.float32, device=dev) / div
        out = float(start) * (1 - s) + float(stop) * s
        if endpoint:
            out = torch.cat([out, torch.full((1,), float(stop), device=dev)])
    else:
        out = torch.full((num,), float(start), device=dev)
    return out.to(resolve_dtype(dtype))


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------
def _flat_axis(data, axis):
    if axis is None:
        return data.reshape(-1), 0
    return data, axis % data.dim()


@register_op("sort")
def sort(data, axis=-1, is_ascend=True, **kw):
    data, axis = _flat_axis(data, axis)
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register_op("argsort", no_grad=True)
def argsort(data, axis=-1, is_ascend=True, dtype="float32", **kw):
    data, axis = _flat_axis(data, axis)
    idx = torch.sort(data, dim=axis, stable=True).indices
    if not is_ascend:
        idx = torch.flip(idx, (axis,))
    return idx.to(resolve_dtype(dtype))


def topk_indices(x, k):
    """The indices of the ``k`` largest entries along the last axis,
    largest first and the lower index first among ties (``lax.top_k``'s
    order). ``torch.topk`` gives the k-th value, which no tie order
    changes. Every entry above it is taken, and of those equal to it the
    lowest-indexed ones that fill k: a second ``topk`` over an int32 key
    (n + 1 above the k-th value; n - i at it; 0 below) picks them. The k
    taken, put in index order, are then stably sorted by value. ``k`` 0
    takes none."""
    n = x.shape[-1]
    if k == 0:
        return torch.empty(x.shape[:-1] + (0,), dtype=torch.int64,
                           device=x.device)
    kth = torch.topk(x, k, dim=-1, sorted=True).values[..., k - 1:k]
    rank = torch.arange(n, 0, -1, device=x.device, dtype=torch.int32)
    key = torch.where(x > kth, n + 1,
                      torch.where(x == kth, rank, 0)).to(torch.int32)
    cand = torch.sort(torch.topk(key, k, dim=-1, sorted=False).indices,
                      dim=-1).values
    order = torch.sort(torch.gather(x, -1, cand), dim=-1, descending=True,
                       stable=True).indices
    return torch.gather(cand, -1, order)


@register_op("topk", no_grad=True)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32", **kw):
    """The k largest (``is_ascend``: smallest) entries along ``axis``
    (reference: ordering_op.cc TopK); ``ret_typ`` is ``value``,
    ``indices``, ``mask`` (1 at the k positions) or ``both`` (values,
    indices)."""
    data, axis = _flat_axis(data, axis)
    k = int(k)
    moved = torch.movedim(data, axis, -1)
    idx = topk_indices(-moved if is_ascend else moved, k)
    values = torch.movedim(torch.gather(moved, -1, idx), -1, axis)
    indices = torch.movedim(idx, -1, axis).to(resolve_dtype(dtype))
    if ret_typ == "value":
        return values
    if ret_typ == "indices":
        return indices
    if ret_typ == "mask":
        mask = torch.zeros(moved.shape, dtype=resolve_dtype(dtype),
                           device=data.device)
        mask.scatter_(-1, idx, 1.0)
        return torch.movedim(mask, -1, axis)
    return values, indices
