"""Functional optimizer rules for the fused training step (counterpart
of ``mxnet_tpu/parallel/functional_opt.py``), SGD only.

``create(name, **kwargs)`` / ``from_optimizer(opt)`` return a rule with

    init(param)                         -> state tuple (fp32 tensors)
    update(param, grad, state, lr, t, wd) -> (new_param, new_state)
    update_(params, grads, states, lr, wd, out=None)  on lists

``update`` is pure; ``update_`` applies the same arithmetic, in the same
order, in place over lists of tensors with ``torch._foreach_*`` (one
launch per operation for a whole group of parameters), or into ``out``
lists (the fused step's guard selects them into the state). Gradients are
taken in fp32, multiplied by ``rescale_grad``, clipped, then ``wd * p``
is added (``_g32``); momentum is ``mom = momentum*mom - lr*g`` and then
``p += mom``. The other rules of the JAX package are not ported yet.

``lr`` is a Python float (the eager paths: ``Optimizer.update``, the
Gluon Trainer) or a 0-dim fp32 tensor on the parameters' device (the
fused step, whose captured CUDA graph reads it at every replay, as the
JAX package's compiled step takes lr as a run-time argument). One body
serves both: ``lr * g`` is one multiply either way. Momentum, wd,
rescale and clip stay constants of the rule.
"""
from __future__ import annotations

import torch

__all__ = ["FunctionalOptimizer", "create", "from_optimizer", "supported"]


class FunctionalOptimizer:
    """A pure optimizer rule: closures over static hyperparameters."""

    def __init__(self, name, init_fn, update_fn, update_inplace_fn):
        self.name = name
        self.init = init_fn
        self._update = update_fn
        self._update_ = update_inplace_fn

    def update(self, p, g, s, lr, t, wd=0.0):
        return self._update(p, g, s, lr, t, wd)

    def update_(self, params, grads, states, lr, wd=0.0, out=None):
        """Over lists: ``params`` (fp32), their ``grads`` (fp32,
        overwritten) and ``states`` (one state tuple per param), all with
        the same ``lr`` (a float or a 0-dim fp32 device tensor) and
        ``wd``. In place; or, with ``out=(new_params, new_states)``
        (lists shaped as ``params`` and ``states``), the same arithmetic
        written there, leaving ``params`` and ``states`` as they were:
        bit for bit the values the in-place update would leave."""
        self._update_(params, grads, states, lr, wd, out)


_FACTORIES = {}
_COMMON_KEYS = {"rescale_grad", "clip_gradient"}
_PARAM_KEYS = {"sgd": {"momentum", "lazy_update"}}
_ATTR_MAP = {"sgd": ("momentum", "lazy_update")}


def supported():
    return sorted(_FACTORIES)


def create(name, **kwargs):
    name = name.lower()
    if name not in _FACTORIES:
        raise ValueError(
            f"no functional rule for optimizer '{name}'; supported: "
            f"{supported()}")
    unknown = set(kwargs) - _PARAM_KEYS[name] - _COMMON_KEYS
    if unknown:
        raise TypeError(
            f"optimizer '{name}' got unexpected parameters {sorted(unknown)}"
            f"; accepted: {sorted(_PARAM_KEYS[name] | _COMMON_KEYS)}")
    return _FACTORIES[name](kwargs)


def _g32(g, p, kw):
    """Common gradient preprocessing: fp32, rescale, clip."""
    g = g.float() * kw.get("rescale_grad", 1.0)
    clip = kw.get("clip_gradient")
    if clip is not None and clip > 0:
        g = torch.clamp(g, -clip, clip)
    return g


def _g32_(grads, kw):
    """``_g32`` in place over a list of fp32 gradients."""
    torch._foreach_mul_(grads, float(kw.get("rescale_grad", 1.0)))
    clip = kw.get("clip_gradient")
    if clip is not None and clip > 0:
        torch._foreach_clamp_min_(grads, -float(clip))
        torch._foreach_clamp_max_(grads, float(clip))


def _make_sgd(kw):
    momentum = kw.get("momentum", 0.0)

    def init(p):
        return (torch.zeros_like(p, dtype=torch.float32),) \
            if momentum else ()

    def update(p, g, s, lr, t, wd):
        g = _g32(g, p, kw) + wd * p
        if momentum:
            (mom,) = s
            mom = momentum * mom - lr * g
            return p + mom, (mom,)
        return p - lr * g, ()

    def update_(params, grads, states, lr, wd, out=None):
        _g32_(grads, kw)
        if wd:
            torch._foreach_add_(grads, params, alpha=float(wd))
        # lr * g, in place in the gradients (a float or a device scalar)
        torch._foreach_mul_(grads, lr if isinstance(lr, torch.Tensor)
                            else float(lr))
        moms = [s[0] for s in states] if momentum else None
        if out is not None:
            # the same operations, in the same order, on copies
            new_p, new_s = out
            torch._foreach_copy_(new_p, params)
            params = new_p
            if momentum:
                new_m = [s[0] for s in new_s]
                torch._foreach_copy_(new_m, moms)
                moms = new_m
        if momentum:
            torch._foreach_mul_(moms, float(momentum))
            torch._foreach_sub_(moms, grads)
            torch._foreach_add_(params, moms)
        else:
            torch._foreach_sub_(params, grads)

    return FunctionalOptimizer("sgd", init, update, update_)


_FACTORIES["sgd"] = _make_sgd


def from_optimizer(opt):
    """The functional rule of an ``Optimizer`` instance, hyperparameters
    read off it; lr and wd stay per call so the caller applies the
    schedule and the per-parameter multipliers."""
    name = type(opt).__name__.lower()
    if name not in _ATTR_MAP:
        raise ValueError(
            f"no functional rule for optimizer class {type(opt).__name__}; "
            f"supported: {supported()}")
    kw = {a: getattr(opt, a) for a in _ATTR_MAP[name] if hasattr(opt, a)}
    kw["rescale_grad"] = getattr(opt, "rescale_grad", 1.0)
    kw["clip_gradient"] = getattr(opt, "clip_gradient", None)
    return create(name, **kw)
