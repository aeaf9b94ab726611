"""Optimizers (counterpart of ``mxnet_tpu/optimizer.py``; reference:
python/mxnet/optimizer.py:34-1506): the ``Optimizer`` base with its
per-parameter ``lr_mult`` / ``wd_mult``, the fifteen registered classes
(SGD, Signum, FTML, DCASGD, NAG, SGLD, Adam, AdaGrad, RMSProp, AdaDelta,
Ftrl, Adamax, Nadam, LBSGD, Test), ``multi_precision`` and the
``Updater``.

Two forms of each rule, as in the JAX package:

- the eager classes here: ``update(index, weight, grad, state)`` applies
  the class's own arithmetic (the ``*_update`` ops of
  ``ops/optimizer_ops.py`` where the reference calls one) to one
  parameter, counting updates per index in Python, and writes the new
  weight and state into their NDArrays in place (an executor or a Gluon
  parameter holds those buffers by address). ``Updater`` keeps each
  index's state and is what ``Module(fused=False)`` calls;
- ``parallel/functional_opt.py``'s rule, read off the instance
  (``functional_opt.from_optimizer``): the fused training step and the
  Gluon Trainer apply it over lists of parameters.

The eager classes take their bias corrections in Python floats
(float64), as the reference's do; the functional rules take them in
fp32 on the device.

``Updater.get_states`` / ``set_states`` keep the reference's pickle
(numpy leaves); ``set_states`` reads the JAX package's pickles too, its
``_MPState`` mapped to this module's class without importing that
package. A pickle written here names this module's ``_MPState``, so
``multi_precision`` states cross from the JAX package to the port only;
``dump_optimizer=True`` pickles the optimizer object, which cannot
cross packages in either direction.
"""
from __future__ import annotations

import io
import math
import pickle
import warnings

import numpy as np
import torch

from .base import MXNetError
from .ops import get_op

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "DCASGD", "NAG", "SGLD",
           "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax",
           "Nadam", "LBSGD", "Test", "Updater", "get_updater", "create",
           "register"]


def _nd(t):
    from .ndarray import NDArray
    return NDArray(t)


def _op(name, *arrays, **attrs):
    """Run an optimizer update op on the arrays' tensors (no autograd)."""
    raw = [a._data if hasattr(a, "_data") else a for a in arrays]
    with torch.no_grad():
        return get_op(name).fn(*raw, **attrs)


def _set(arr, value):
    """Write ``value`` into ``arr``'s buffer in place."""
    with torch.no_grad():
        arr._data.copy_(value)


def _zeros_like(weight):
    return _nd(torch.zeros_like(weight._data))


class _MPState:
    """Multi-precision state: the fp32 master weight and the optimizer's
    own state."""

    __slots__ = ("master", "inner")

    def __init__(self, master, inner):
        self.master = master
        self.inner = inner


class Optimizer:
    """Base optimizer: learning rate (or schedule), weight decay,
    gradient rescale and clip, and the per-parameter multipliers."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        """Register an optimizer under its lowercase class name."""
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            warnings.warn(f"WARNING: New optimizer {klass.__name__} is "
                          f"overriding existing optimizer "
                          f"{Optimizer.opt_registry[name].__name__}")
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name}")

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict), \
            "param_idx2name should be a dict of param indexes to names."
        self.idx2name = param_idx2name.copy()
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        """Per-weight state: None, an NDArray or a tuple of them."""
        return None

    @staticmethod
    def _is_low_precision(weight):
        return weight._data.dtype in (torch.float16, torch.bfloat16)

    def create_state_multi_precision(self, index, weight):
        """An fp32 master copy and the state of that copy when
        ``multi_precision`` and the weight is fp16/bf16."""
        if self.multi_precision and self._is_low_precision(weight):
            master = _nd(weight._data.to(torch.float32))
            return _MPState(master, self.create_state(index, master))
        if weight._data.dtype == torch.float16 and not self.multi_precision:
            warnings.warn("Accumulating with float16 in optimizer can lead "
                          "to poor accuracy or slow convergence. Consider "
                          "using multi_precision=True option of the "
                          "optimizer")
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if isinstance(state, _MPState):
            grad32 = _nd(grad._data.to(torch.float32))
            self.update(index, state.master, grad32, state.inner)
            _set(weight, state.master._data.to(weight._data.dtype))
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined. Note that set_learning_rate can mutate "
                              "the value of the learning rate of the optimizer "
                              "only when the LRScheduler of the optimizer is "
                              "undefined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        """Per-name learning-rate multipliers: the symbol's
        ``__lr_mult__`` attributes, then ``args_lr_mult``."""
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Per-name weight-decay multipliers. Every parameter whose name
        ends neither in ``_weight`` nor in ``_gamma`` (biases, betas)
        gets 0, by name alone; then the symbol's ``__wd_mult__``
        attributes and ``args_wd_mult``."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _common(self, index):
        """Count the update; (lr, wd, the update ops' common kwargs)."""
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        return lr, wd, dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                            clip_gradient=self.clip_gradient or -1.0)

    def _g(self, grad):
        """The rescaled, clipped gradient tensor."""
        g = grad._data * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def __getstate__(self):
        # the Gluon parameters are not pickled (a Trainer's load_states
        # sets them again)
        ret = self.__dict__.copy()
        ret["param_dict"] = {}
        return ret


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum: ``g = rescale*grad`` (clipped) ``+ wd*w``,
    ``mom = momentum*mom - lr*g``, ``w += mom`` (``w -= lr*g`` without
    momentum)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        _, _, kw = self._common(index)
        if state is not None:
            w, m = _op("sgd_mom_update", weight, grad, state,
                       momentum=self.momentum, **kw)
            _set(weight, w)
            _set(state, m)
        else:
            _set(weight, _op("sgd_update", weight, grad, **kw))


@register
class Signum(Optimizer):
    """Sign-based SGD."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        _, _, kw = self._common(index)
        if state is not None:
            w, m = _op("signum_update", weight, grad, state,
                       momentum=self.momentum, wd_lh=self.wd_lh, **kw)
            _set(weight, w)
            _set(state, m)
        else:
            _set(weight, _op("signsgd_update", weight, grad, **kw))


@register
class FTML(Optimizer):
    """Follow the Moving Leader."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr, wd, _ = self._common(index)
        t = self._index_update_count[index]
        d, v, z = state
        w, dn, vn, zn = _op("ftml_update", weight, grad, d, v, z, lr=lr,
                            beta1=self.beta1, beta2=self.beta2,
                            epsilon=self.epsilon, wd=wd, t=t,
                            rescale_grad=self.rescale_grad,
                            clip_grad=self.clip_gradient or -1.0)
        for a, x in ((weight, w), (d, dn), (v, vn), (z, zn)):
            _set(a, x)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = _nd(weight._data.clone())
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros_like(weight), prev)

    def update(self, index, weight, grad, state):
        lr, wd, _ = self._common(index)
        mom, previous_weight = state
        with torch.no_grad():
            g = self._g(grad)
            w = weight._data
            comp = g + self.lamda * g * g * (w - previous_weight._data)
            step = -lr * (comp + wd * w)
            if mom is not None:
                _set(mom, mom._data * self.momentum + step)
                step = mom._data
            else:
                assert self.momentum == 0.0
            previous_weight._data.copy_(w)
            w.add_(step)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        _, _, kw = self._common(index)
        if state is not None:
            w, m = _op("nag_mom_update", weight, grad, state,
                       momentum=self.momentum, **kw)
            _set(weight, w)
            _set(state, m)
        else:
            _set(weight, _op("sgd_update", weight, grad, **kw))


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics; the noise comes from the
    weight's device generator (``random.generator``)."""

    def update(self, index, weight, grad, state):
        from . import random as _random
        lr, wd, _ = self._common(index)
        with torch.no_grad():
            g = self._g(grad)
            w = weight._data
            noise = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                                generator=_random.generator(w.device)) \
                * math.sqrt(lr)
            _set(weight, w - lr / 2 * (g + wd * w) + noise)


@register
class Adam(Optimizer):
    """Adam; the bias correction is folded into lr in Python floats."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr, wd, _ = self._common(index)
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        mean, var = state
        w, m, v = _op("adam_update", weight, grad, mean, var, lr=lr,
                      beta1=self.beta1, beta2=self.beta2,
                      epsilon=self.epsilon, wd=wd,
                      rescale_grad=self.rescale_grad,
                      clip_gradient=self.clip_gradient or -1.0)
        for a, x in ((weight, w), (mean, m), (var, v)):
            _set(a, x)


@register
class AdaGrad(Optimizer):
    """AdaGrad."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr, wd, _ = self._common(index)
        with torch.no_grad():
            g = self._g(grad)
            _set(state, state._data + g * g)
            w = weight._data
            _set(weight, w - lr * (g / torch.sqrt(
                state._data + self.float_stable_eps) + wd * w))


@register
class RMSProp(Optimizer):
    """RMSProp, centered or not."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        _, _, kw = self._common(index)
        kw.update(gamma1=self.gamma1, epsilon=self.epsilon,
                  clip_weights=self.clip_weights or -1.0)
        if not self.centered:
            w, nn_ = _op("rmsprop_update", weight, grad, state, **kw)
            _set(weight, w)
            _set(state, nn_)
        else:
            n, g, delta = state
            w, nn_, gn, dn = _op("rmspropalex_update", weight, grad, n, g,
                                 delta, gamma2=self.gamma2, **kw)
            for a, x in ((weight, w), (n, nn_), (g, gn), (delta, dn)):
                _set(a, x)


@register
class AdaDelta(Optimizer):
    """AdaDelta."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        _, wd, _ = self._common(index)
        acc_g, acc_delta = state
        with torch.no_grad():
            g = self._g(grad)
            _set(acc_g, self.rho * acc_g._data + (1.0 - self.rho) * g * g)
            cur = torch.sqrt(acc_delta._data + self.epsilon) / \
                torch.sqrt(acc_g._data + self.epsilon) * g
            _set(acc_delta, self.rho * acc_delta._data
                 + (1.0 - self.rho) * cur * cur)
            w = weight._data
            _set(weight, w - cur - wd * w)


@register
class Ftrl(Optimizer):
    """FTRL."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        _, _, kw = self._common(index)
        z, n = state
        w, zn, nn_ = _op("ftrl_update", weight, grad, z, n,
                         lamda1=self.lamda1, beta=self.beta, **kw)
        for a, x in ((weight, w), (z, zn), (n, nn_)):
            _set(a, x)


@register
class Adamax(Optimizer):
    """AdaMax."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr, wd, _ = self._common(index)
        t = self._index_update_count[index]
        lr /= (1.0 - self.beta1 ** t)
        m_t, u_t = state
        with torch.no_grad():
            w = weight._data
            g = grad._data * self.rescale_grad + wd * w
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            _set(m_t, self.beta1 * m_t._data + (1.0 - self.beta1) * g)
            _set(u_t, torch.maximum(self.beta2 * u_t._data, torch.abs(g)))
            _set(weight, w - lr * m_t._data / (u_t._data + 1e-8))


@register
class Nadam(Optimizer):
    """Nesterov Adam; ``m_schedule`` lives on the optimizer, as in the
    reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr, wd, _ = self._common(index)
        t = self._index_update_count[index]
        with torch.no_grad():
            w = weight._data
            g = grad._data * self.rescale_grad + wd * w
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            momentum_t = self.beta1 * (
                1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
            momentum_t_1 = self.beta1 * (
                1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
            self.m_schedule = self.m_schedule * momentum_t
            m_schedule_next = self.m_schedule * momentum_t_1
            m_t, v_t = state
            _set(m_t, self.beta1 * m_t._data + (1.0 - self.beta1) * g)
            _set(v_t, self.beta2 * v_t._data + (1.0 - self.beta2) * g * g)
            grad_prime = g / (1.0 - self.m_schedule)
            m_t_prime = m_t._data / (1.0 - m_schedule_next)
            v_t_prime = v_t._data / (1.0 - self.beta2 ** t)
            m_t_bar = (1.0 - momentum_t) * grad_prime \
                + momentum_t_1 * m_t_prime
            _set(weight, w - lr * m_t_bar / (torch.sqrt(v_t_prime)
                                             + self.epsilon))


@register
class LBSGD(Optimizer):
    """Large-batch SGD with LARS layer-wise adaptive rate and warmup."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0
        self.cumgrads = {}
        self.adaptive = warmup_strategy == "lars"
        self.admult = 1.0

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def _get_lbmult(self, nup):
        """The warmup multiplier."""
        nwup = self.warmup_epochs * self.updates_per_epoch
        strategy = self.warmup_strategy
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            mult = maxmult
        elif nwup <= 1:
            mult = 1.0
        elif strategy == "linear":
            mult = 1.0 + (maxmult - 1) * nup / nwup
        elif strategy == "power2":
            mult = 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        elif strategy == "sqrt":
            mult = 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        else:
            mult = 1.0
        return mult

    @staticmethod
    def _get_lars(weight, g, wd):
        """The LARS trust ratio (a device scalar: no sync)."""
        w_norm = torch.linalg.norm(weight._data.reshape(-1))
        g_norm = torch.linalg.norm(g.reshape(-1))
        return torch.where((w_norm > 0.0) & (g_norm > 0.0),
                           w_norm / (g_norm + wd * w_norm + 1e-9), 1.0)

    def update(self, index, weight, grad, state):
        lr, wd, _ = self._common(index)
        with torch.no_grad():
            g = self._g(grad)
            if self.warmup_strategy == "lars":
                lbmult = self._get_lars(weight, g, wd)
            else:
                lbmult = self._get_lbmult(self.num_update)
            lr = lr * lbmult
            w = weight._data
            if state is not None:
                _set(state, self.momentum * state._data - lr * (g + wd * w))
                w.add_(state._data)
            else:
                _set(weight, w - lr * (g + wd * w))


@register
class Test(Optimizer):
    """The reference's test optimizer: ``w -= rescale * grad``."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            _set(weight, weight._data - self.rescale_grad * grad._data)
            _set(state, weight._data)


class _StatesUnpickler(pickle.Unpickler):
    """Reads either package's ``Updater`` pickle: the JAX package's
    ``_MPState`` becomes this module's; a pickled optimizer object of
    that package cannot be rebuilt here and raises."""

    def find_class(self, module, name):
        if module == "mxnet_tpu.optimizer" and name == "_MPState":
            return _MPState
        if module == "mxnet_tpu" or module.startswith("mxnet_tpu."):
            raise MXNetError(
                f"optimizer states pickle the JAX package's {module}."
                f"{name} (Updater.get_states(dump_optimizer=True) or a "
                "Trainer's save_states): an optimizer object cannot cross "
                "packages; save with dump_optimizer=False")
        return super().find_class(module, name)


def loads_states(data):
    """Unpickle an ``Updater`` states blob of either package."""
    return _StatesUnpickler(io.BytesIO(data)).load()


class Updater:
    """Applies an optimizer to (index, grad, weight), owning the states
    (reference: optimizer.py:1452)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states, device=None):
        """Load ``get_states``' bytes (either package's): numpy leaves
        become NDArrays on ``device`` (default: the current context's)."""
        from .context import current_context
        states = loads_states(states) \
            if isinstance(states, (bytes, bytearray)) else states
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer = states
        dev = torch.device(device) if device is not None \
            else current_context().device

        def to_nd(s):
            if isinstance(s, np.ndarray):
                return _nd(torch.from_numpy(np.array(s)).to(dev))
            if isinstance(s, _MPState):
                return _MPState(to_nd(s.master), to_nd(s.inner))
            if isinstance(s, (tuple, list)):
                return type(s)(to_nd(x) for x in s)
            return s

        self.states = {k: to_nd(v) for k, v in states.items()}
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        """The states pickled with numpy leaves (with the optimizer
        object too when ``dump_optimizer``)."""
        def to_np(s):
            if hasattr(s, "asnumpy"):
                return s.asnumpy()
            if isinstance(s, _MPState):
                return _MPState(to_np(s.master), to_np(s.inner))
            if isinstance(s, (tuple, list)):
                return type(s)(to_np(x) for x in s)
            return s
        states = {k: to_np(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)


def get_updater(optimizer):
    return Updater(optimizer)

