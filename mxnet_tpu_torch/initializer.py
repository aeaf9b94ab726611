"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``;
reference: python/mxnet/initializer.py): name-dispatched callables that
fill a tensor in place.

``init(desc, tensor, generator=None)`` dispatches on the name: a
``__init__`` attribute on the descriptor names the initializer to use;
otherwise ``*weight`` takes the initializer's rule, ``*bias`` and
``*beta`` 0, ``*gamma`` 1, ``*moving_mean`` / ``*running_mean`` 0,
``*moving_var`` / ``*running_var`` 1. Random draws come from
``generator`` (a ``torch.Generator``; the global one when None), on the
generator's device, and are copied into the tensor.
"""
from __future__ import annotations

import json
import math

import torch

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Xavier"]

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
    instance, a class or None."""
    if init is None or isinstance(init, Initializer):
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
    """The name of the parameter being initialized, with its ``attrs``."""

    def __new__(cls, name, attrs=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        return obj


class Initializer:
    """Base initializer: dispatches on the parameter's name."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """Serialize as JSON [name, kwargs]."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, generator=None):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init = desc.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr, generator)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr, generator)
        elif desc.endswith("bias") or desc.endswith("beta"):
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
        with torch.no_grad():
            arr.copy_(value.to(arr.device) if isinstance(value, torch.Tensor)
                      else torch.as_tensor(value))

    def _init_zero(self, name, arr):
        self._set(arr, torch.zeros(arr.shape))

    def _init_one(self, name, arr):
        self._set(arr, torch.ones(arr.shape))

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
