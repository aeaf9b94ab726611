"""``nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``): the
samplers as NDArray functions, drawing from the explicit generator of
the target device (``mxnet_tpu_torch.random``)."""
from __future__ import annotations

import torch

from .. import random as _random
from ..context import as_context
from ..dtype import resolve_dtype
from ..ops.registry import get_op
from .ndarray import NDArray, _invoke_op

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "randn"]


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


def _draw(name, ctx, **attrs):
    """A registry sampler with no tensor input, on ``ctx``'s device."""
    return NDArray(get_op(name).fn(device=as_context(ctx).device, **attrs))


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, **kw):
    return _draw("_random_gamma", ctx, alpha=alpha, beta=beta, shape=shape,
                 dtype=dtype)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None,
                **kw):
    return _draw("_random_exponential", ctx, lam=1.0 / scale, shape=shape,
                 dtype=dtype)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None, **kw):
    return _draw("_random_poisson", ctx, lam=lam, shape=shape, dtype=dtype)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None, **kw):
    return _draw("_random_negative_binomial", ctx, k=k, p=p, shape=shape,
                 dtype=dtype)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None, **kw):
    return _draw("_random_generalized_negative_binomial", ctx, mu=mu,
                 alpha=alpha, shape=shape, dtype=dtype)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    return _invoke_op("_sample_multinomial", [data],
                      {"shape": shape, "get_prob": get_prob, "dtype": dtype})


def shuffle(data, **kw):
    return _invoke_op("_shuffle", [data], {})
