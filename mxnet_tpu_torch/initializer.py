"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``;
reference: python/mxnet/initializer.py): name-dispatched callables that
fill a tensor in place.

``init(desc, tensor, generator=None)`` dispatches on the name: a
``__init__`` attribute on the descriptor names the initializer to use;
otherwise ``*weight`` takes the initializer's rule, ``*bias`` its
``_init_bias`` (0 unless overridden, as ``LSTMBias`` does), ``*beta``
0, ``*gamma`` 1, ``*moving_mean`` / ``*running_mean`` 0,
``*moving_var`` / ``*running_var`` 1. Random draws come from
``generator`` (a ``torch.Generator``; the global one when None), on the
generator's device, and are copied into the tensor.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "FusedRNN", "Load", "Mixed"]

_INIT_REGISTRY = {}


def register(klass):
    """Register an initializer under its lowercase class name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(name):
    def wrapper(klass):
        _INIT_REGISTRY[name] = klass
        return klass
    return wrapper


def create(init, **kwargs):
    """An initializer from a name, an ``Initializer.dumps()`` string, an
    instance, a class, any other callable ``(name, arr, generator)``
    (``Load``, ``Mixed``) or None."""
    if init is None or isinstance(init, Initializer):
        return init
    if callable(init) and not isinstance(init, type):
        return init
    if isinstance(init, str):
        if init.startswith("["):
            name, kwargs = json.loads(init)
        else:
            name = init
        name = name.lower()
        if name not in _INIT_REGISTRY:
            raise ValueError(f"Unknown initializer {name!r}; known: "
                             f"{sorted(_INIT_REGISTRY)}")
        return _INIT_REGISTRY[name](**kwargs)
    if isinstance(init, type) and issubclass(init, Initializer):
        return init(**kwargs)
    raise TypeError(f"Cannot create initializer from {init!r}")


class InitDesc(str):
    """The name of the parameter being initialized, with its ``attrs``
    and ``global_init``, the initializer that dispatched it."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base initializer: dispatches on the parameter's name."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """Serialize as JSON [name, kwargs]."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, generator=None):
        """Fill ``arr`` (a tensor, or an NDArray: its tensor, in place)."""
        arr = getattr(arr, "_data", arr)
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr, generator)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr, generator)
        elif desc.endswith("bias"):
            self._init_bias(desc, arr, generator)
        elif desc.endswith("beta"):
            self._init_zero(desc, arr)
        elif desc.endswith("gamma"):
            self._init_one(desc, arr)
        elif desc.endswith("running_mean") or desc.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif desc.endswith("running_var") or desc.endswith("moving_var"):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr, generator)

    @staticmethod
    def _draw(kind, shape, generator, a, b):
        """A float32 tensor of ``shape``: uniform in [a, b) or normal
        with mean a and std b."""
        dev = generator.device if generator is not None else "cpu"
        if kind == "uniform":
            return torch.empty(shape, device=dev).uniform_(a, b,
                                                           generator=generator)
        return torch.empty(shape, device=dev).normal_(a, b,
                                                      generator=generator)

    @staticmethod
    def _set(arr, value):
        arr = getattr(arr, "_data", arr)
        with torch.no_grad():
            arr.copy_(value.to(arr.device) if isinstance(value, torch.Tensor)
                      else torch.as_tensor(value))

    def _init_zero(self, name, arr):
        self._set(arr, torch.zeros(arr.shape))

    def _init_one(self, name, arr):
        self._set(arr, torch.ones(arr.shape))

    def _init_bias(self, name, arr, generator=None):
        self._init_zero(name, arr)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError("Must override _init_weight")

    def _init_default(self, name, arr, generator):
        raise ValueError(
            f"Unknown initialization pattern for {name}. Default init "
            "supports names ending with weight/bias/gamma/beta/mean/var; "
            "set the parameter's __init__ attribute for others.")


@_alias("zeros")
@register
class Zero(Initializer):
    def _init_weight(self, name, arr, generator=None):
        self._init_zero(name, arr)

    _init_default = _init_weight


@_alias("ones")
@register
class One(Initializer):
    def _init_weight(self, name, arr, generator=None):
        self._init_one(name, arr)

    _init_default = _init_weight


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr, generator=None):
        v = torch.as_tensor(self.value, dtype=torch.float32)
        self._set(arr, v.expand(arr.shape))

    _init_default = _init_weight


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, generator=None):
        self._set(arr, self._draw("uniform", arr.shape, generator,
                                  -self.scale, self.scale))


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr, generator=None):
        self._set(arr, self._draw("normal", arr.shape, generator, 0.0,
                                  self.sigma))


@register
class Xavier(Initializer):
    """Xavier/Glorot: scale ``sqrt(magnitude / factor)`` with factor the
    fan in, the fan out or their mean (``factor_type`` in/out/avg);
    uniform in [-scale, scale] or normal with std scale (``rnd_type``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator=None):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise ValueError(
                f"Xavier initializer cannot be applied to vector {name}: "
                "it requires at least 2D shape")
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._set(arr, self._draw("uniform", shape, generator, -scale,
                                      scale))
        elif self.rnd_type == "gaussian":
            self._set(arr, self._draw("normal", shape, generator, 0.0,
                                      scale))
        else:
            raise ValueError("Unknown random type")


@register
class Orthogonal(Initializer):
    """``scale`` times the orthogonal factor of a random (out, in) matrix
    (uniform in [-1, 1] or normal, ``rand_type``), by SVD in float64 on
    the host (reference: initializer.py:508; Saxe et al.)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr, generator=None):
        shape = tuple(arr.shape)
        nout, nin = shape[0], math.prod(shape[1:])
        tmp = self._draw("uniform", (nout, nin), generator, -1.0, 1.0) \
            if self.rand_type == "uniform" \
            else self._draw("normal", (nout, nin), generator, 0.0, 1.0)
        u, _, v = torch.linalg.svd(tmp.double().cpu(), full_matrices=False)
        res = u if tuple(u.shape) == (nout, nin) else v
        self._set(arr, (self.scale * res).reshape(shape).float())


@register
class MSRAPrelu(Xavier):
    """He initialization for PReLU: Xavier gaussian with magnitude
    ``2 / (1 + slope^2)`` (reference: initializer.py:611)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel (reference: initializer.py:635)."""

    def _init_weight(self, name, arr, generator=None):
        shape = tuple(arr.shape)
        i = np.arange(int(np.prod(shape)))
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        self._set(arr, torch.from_numpy(w.astype(np.float32).reshape(shape)))


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter (the second) set to
    ``forget_bias`` (reference: initializer.py:653-675)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr, generator=None):
        b = torch.zeros(tuple(arr.shape))
        h = arr.shape[0] // 4
        b[h:2 * h] = self.forget_bias
        self._set(arr, b)

    _init_default = _init_weight
    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """The flat cuDNN-layout vector of a ``FusedRNNCell``: each per-gate
    view takes the inner initializer (or the dispatching one, or
    ``Uniform(0.07)``), and lstm's forget-gate biases ``forget_bias``
    (reference: initializer.py:676-726)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            init = create(init)
        super().__init__(
            init=init.dumps() if init is not None else None,
            num_hidden=num_hidden, num_layers=num_layers, mode=mode,
            bidirectional=bidirectional, forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr, generator=None):
        from .rnn.rnn_cell import FusedRNNCell
        cell = FusedRNNCell(self._num_hidden, self._num_layers, self._mode,
                            self._bidirectional,
                            forget_bias=self._forget_bias, prefix="")
        flat = arr.detach().to("cpu", torch.float32).clone().reshape(-1)
        views = cell._slice_weights(flat, cell._num_input(flat.numel()),
                                    self._num_hidden)
        gi = getattr(desc, "global_init", None)
        for name, view in views.items():
            sub = InitDesc(name, global_init=gi)
            if self._mode == "lstm" and name.endswith("_f_bias"):
                view.fill_(self._forget_bias)
            elif self._init is not None:
                self._init(sub, view, generator)
            elif gi is not None:
                gi(sub, view, generator)
            else:
                Uniform(0.07)(sub, view, generator)
        self._set(arr, flat.reshape(tuple(arr.shape)))

    _init_default = _init_weight


@register
class Load:
    """Initialize from a dict of arrays by name (``arg:`` / ``aux:``
    prefixes dropped), else from ``default_init`` (reference:
    initializer.py:287)."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr, generator=None):
        if name in self.param:
            p = self.param[name]
            src = p._data if hasattr(p, "_data") and isinstance(
                p._data, torch.Tensor) else torch.as_tensor(
                    np.asarray(p.asnumpy() if hasattr(p, "asnumpy") else p))
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError(f"Parameter {name} cannot be initialized "
                                 "from loading. Shape mismatch, target "
                                 f"{tuple(arr.shape)} vs loaded "
                                 f"{tuple(src.shape)}")
            Initializer._set(arr, src)
        elif self.default_init is None:
            raise ValueError(f"Cannot Initialize parameter {name}. Not found "
                             "in loaded param and no default initializer is "
                             "provided.")
        else:
            self.default_init(name, arr, generator)


@register
class Mixed:
    """The first initializer whose pattern matches the name (reference:
    initializer.py:334)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must have same "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr, generator=None):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr, generator)
                return
        raise ValueError(f"Parameter name {name} did not match any pattern. "
                         "Consider adding a \".*\" pattern at the end with "
                         "default Initializer.")
