"""Random sampling ops (counterpart of ``mxnet_tpu/ops/random_ops.py``;
reference: src/operator/random/sample_op.cc, multisample_op.cc,
shuffle_op.cc, unique_sample_op.cc).

Every draw takes an explicit ``generator=``: the op's ``generator``
attribute, else ``random.generator(device)`` (which inside
``random.use_generator`` is the caller's). A captured program registers
that generator with its graph, so each replay draws anew and
``random.seed`` reproduces a run. Draws cannot equal the JAX package's
(other generators); the distributions and the shapes and dtypes do.
The gamma-Poisson mixtures are the JAX package's: negative binomial
``NB(k, p) = Poisson(Gamma(k) (1 - p) / p)``; ``multinomial`` is the
Gumbel-max draw of ``jax.random.categorical``. The ops with no tensor
input build on ``device`` (the symbol walk's or the ``nd`` call's),
else the current context's.
"""
from __future__ import annotations

import math

import torch

from ..dtype import resolve_dtype
from .creation import _device
from .registry import register_op


def gen_of(device, generator=None):
    """The generator a draw on ``device`` takes (None on ``meta``
    tensors: shape inference draws nothing)."""
    if generator is not None or torch.device(device).type == "meta":
        return generator
    from .. import random as _random
    return _random.generator(device)


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def uniform_(shape, device, gen, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        generator=gen)


def normal_(shape, device, gen, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        generator=gen)


def exponential_(shape, device, gen):
    return torch.empty(shape, dtype=torch.float32, device=device) \
        .exponential_(generator=gen)


def standard_gamma(alpha, gen):
    """Gamma(alpha, 1) draws of ``alpha``'s shape (float32)."""
    if alpha.device.type == "meta":
        return torch.empty(alpha.shape, device="meta")
    return torch._standard_gamma(alpha.to(torch.float32).contiguous(),
                                 generator=gen)


def poisson(lam, gen):
    if lam.device.type == "meta":
        return torch.empty(lam.shape, device="meta")
    return torch.poisson(lam.to(torch.float32).contiguous(), generator=gen)


@register_op("_random_uniform", aliases=["random_uniform", "uniform"],
             no_grad=True)
def random_uniform(low=0.0, high=1.0, shape=None, ctx=None, dtype="float32",
                   device=None, generator=None, **kw):
    dev = _device(device)
    out = torch.empty(_shape(shape), dtype=resolve_dtype(dtype), device=dev)
    return out.uniform_(float(low), float(high),
                        generator=gen_of(dev, generator))


@register_op("_random_normal", aliases=["random_normal", "normal"],
             no_grad=True)
def random_normal(loc=0.0, scale=1.0, shape=None, ctx=None, dtype="float32",
                  device=None, generator=None, **kw):
    dev = _device(device)
    out = torch.empty(_shape(shape), dtype=resolve_dtype(dtype), device=dev)
    return out.normal_(float(loc), float(scale),
                       generator=gen_of(dev, generator))


def _full(shape, value, device):
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=device)


@register_op("_random_gamma", aliases=["random_gamma"], no_grad=True)
def random_gamma(alpha=1.0, beta=1.0, shape=None, ctx=None, dtype="float32",
                 device=None, generator=None, **kw):
    dev = _device(device)
    g = standard_gamma(_full(_shape(shape), alpha, dev),
                       gen_of(dev, generator))
    return (g * float(beta)).to(resolve_dtype(dtype))


@register_op("_random_exponential", aliases=["random_exponential"],
             no_grad=True)
def random_exponential(lam=1.0, shape=None, ctx=None, dtype="float32",
                       device=None, generator=None, **kw):
    dev = _device(device)
    e = exponential_(_shape(shape), dev, gen_of(dev, generator))
    return (e / float(lam)).to(resolve_dtype(dtype))


@register_op("_random_poisson", aliases=["random_poisson"], no_grad=True)
def random_poisson(lam=1.0, shape=None, ctx=None, dtype="float32",
                   device=None, generator=None, **kw):
    dev = _device(device)
    return poisson(_full(_shape(shape), lam, dev),
                   gen_of(dev, generator)).to(resolve_dtype(dtype))


def gamma_poisson(shape_param, scale, gen):
    """Poisson(Gamma(shape_param) * scale): the negative binomial."""
    return poisson(standard_gamma(shape_param, gen) * scale, gen)


@register_op("_random_negative_binomial",
             aliases=["random_negative_binomial"], no_grad=True)
def random_negative_binomial(k=1, p=1.0, shape=None, ctx=None,
                             dtype="float32", device=None, generator=None,
                             **kw):
    dev = _device(device)
    p = float(p)
    return gamma_poisson(_full(_shape(shape), k, dev), (1 - p) / p,
                         gen_of(dev, generator)).to(resolve_dtype(dtype))


@register_op("_random_generalized_negative_binomial",
             aliases=["random_generalized_negative_binomial"], no_grad=True)
def random_gen_neg_binomial(mu=1.0, alpha=1.0, shape=None, ctx=None,
                            dtype="float32", device=None, generator=None,
                            **kw):
    dev = _device(device)
    r = 1.0 / float(alpha)
    p = r / (r + float(mu))
    return gamma_poisson(_full(_shape(shape), r, dev), (1 - p) / p,
                         gen_of(dev, generator)).to(resolve_dtype(dtype))


@register_op("_sample_multinomial",
             aliases=["sample_multinomial", "multinomial"], no_grad=True)
def sample_multinomial(data, shape=None, get_prob=False, dtype="int32",
                       generator=None, **kw):
    """Class draws from the probabilities on ``data``'s last axis, by
    Gumbel-max over ``log(max(p, 1e-37))`` as ``jax.random.categorical``:
    one draw per row (``shape`` None), else ``prod(shape)`` draws on a
    new last axis. ``get_prob`` also returns each draw's log
    probability."""
    if not shape:
        n = 1
    elif isinstance(shape, int):
        n = shape
    else:
        n = math.prod(int(s) for s in shape)
    logits = torch.log(torch.clamp_min(data.to(torch.float32), 1e-37))
    e = exponential_((n,) + tuple(data.shape), data.device,
                     gen_of(data.device, generator))
    samples = torch.argmax(logits - torch.log(e), dim=-1)
    samples = torch.movedim(samples, 0, -1)
    if n == 1 and not shape:
        samples = samples[..., 0]
    out = samples.to(resolve_dtype(dtype))
    if get_prob:
        logp = torch.log_softmax(logits, dim=-1)
        idx = samples.reshape(tuple(data.shape[:-1]) + (-1,))
        lp = torch.gather(logp, -1, idx).reshape(samples.shape)
        return out, lp
    return out


@register_op("_shuffle", aliases=["shuffle"], no_grad=True)
def shuffle(data, generator=None, **kw):
    """``data``'s rows (axis 0) in a random order."""
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=gen_of(data.device, generator))
    return torch.index_select(data, 0, perm)


@register_op("_sample_unique_zipfian", no_grad=True)
def sample_unique_zipfian(range_max=1, shape=None, device=None,
                          generator=None, **kw):
    """Log-uniform class draws in [0, range_max), int32 (the JAX
    package's int64 without x64)."""
    dev = _device(device)
    n = int(shape[0]) if isinstance(shape, (tuple, list)) else int(shape)
    u = uniform_((n,), dev, gen_of(dev, generator))
    s = torch.exp(u * math.log(float(range_max) + 1.0)) - 1.0
    return torch.remainder(s.to(torch.int32), int(range_max))
