"""``nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``):
uniform and normal draws from the explicit generator of the target
device (``mxnet_tpu_torch.random``)."""
from __future__ import annotations

import torch

from .. import random as _random
from ..context import as_context
from ..dtype import resolve_dtype
from .ndarray import NDArray

__all__ = ["uniform", "normal", "randn"]


def _empty(shape, dtype, ctx):
    dev = as_context(ctx).device
    shape = (shape,) if isinstance(shape, int) else tuple(shape or (1,))
    return torch.empty(shape, dtype=resolve_dtype(dtype), device=dev), dev


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    t, dev = _empty(shape, dtype, ctx)
    t.uniform_(low, high, generator=_random.generator(dev))
    return NDArray(t)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    t, dev = _empty(shape, dtype, ctx)
    t.normal_(loc, scale, generator=_random.generator(dev))
    return NDArray(t)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **kw):
    return normal(loc, scale, shape, dtype, ctx)
