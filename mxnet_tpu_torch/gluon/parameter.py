"""Gluon Parameter / Constant / ParameterDict (counterpart of
``mxnet_tpu/gluon/parameter.py``; reference:
python/mxnet/gluon/parameter.py).

A Parameter holds one NDArray on one device. Its data tensor is a
leaf that requires grad (for ``grad_req`` "write" or "add"); the
optimizer updates it in place. Shapes with 0s are completed at the first
forward (deferred init). Initial values come from the initializer's
name rules, drawn from the device's explicit generator
(``mxnet_tpu_torch.random``). ``ParameterDict.save`` / ``load`` read and
write the ``.params`` format of ``ndarray/param_file.py`` (the JAX
package's files load here and the port's there).
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .. import autograd, initializer
from .. import random as _random
from ..base import MXNetError
from ..context import as_context, current_context
from ..dtype import resolve_dtype
from ..ndarray.ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "tensor_types"]

tensor_types = (NDArray,)


class DeferredInitializationError(MXNetError):
    """Deferred initialization is not finished yet (reference:
    parameter.py:37)."""


class Parameter:
    """A parameter's data and gradient (reference: parameter.py:44)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True, stype="default", grad_stype="default"):
        self._data = None
        self._grad = None
        self._deferred_init = ()
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._grad_req = None
        self.name = name
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req
        self.init = init
        if stype != "default" or grad_stype != "default":
            raise NotImplementedError("sparse parameters are not ported")

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, dtype={self.dtype})"

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write/add/null, got {req}")
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
            if self._data is not None:
                self._data._grad = None
                self._data._grad_req = "null"
                self._data._data = self._data._data.detach()
        elif self._data is not None:
            self._init_grad()

    # -- init ----------------------------------------------------------------
    def initialize(self, init=None, ctx=None,
                   default_init=initializer.Uniform(), force_reinit=False):
        """Initialize the data (reference: parameter.py:286); with an
        unknown shape and ``allow_deferred_init``, at the first
        forward."""
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if not isinstance(ctx, (list, tuple)):
            ctx = [ctx]
        ctx = [as_context(c) for c in ctx]
        if len(ctx) > 1:
            raise MXNetError("a Parameter lives on one device in the port; "
                             "several contexts are not ported")
        if init is None:
            init = default_init if self.init is None else self.init
        init = initializer.create(init) or default_init
        self._deferred_init = (init, ctx, default_init, None)
        if not self.shape_is_known():
            if self._allow_deferred_init:
                return
            self._deferred_init = ()
            raise ValueError(f"Cannot initialize Parameter '{self.name}' "
                             f"because it has invalid shape: {self.shape}.")
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init, data = self._deferred_init
        self._deferred_init = ()
        if not self.shape_is_known():
            raise ValueError(f"Cannot initialize Parameter '{self.name}' "
                             f"because it has invalid shape: {self.shape}.")
        dev = ctx[0].device
        dt = resolve_dtype(self.dtype)
        with torch.no_grad():
            if data is None:
                t = torch.zeros(self.shape, dtype=dt, device=dev)
                init(initializer.InitDesc(self.name), t,
                     _random.generator(dev))
            else:
                t = data._data.detach().to(device=dev, dtype=dt, copy=True)
        self._init_impl(NDArray(t), ctx)

    def _init_impl(self, data, ctx_list):
        self._ctx_list = list(ctx_list)
        self._data = data
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._data.attach_grad(self._grad_req)
        self._grad = self._data.grad

    def _check_and_get(self, ctx=None):
        if self._data is not None:
            return self._data
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                "because initialization was deferred. Actual initialization "
                "happens during the first forward pass. Please pass one "
                "batch of data through the network before accessing "
                "Parameters.")
        raise RuntimeError(
            f"Parameter '{self.name}' has not been initialized. Note that "
            "you should initialize parameters and create Trainer with "
            "Block.collect_params() instead of Block.params because the "
            "later does not include Parameters of nested child Blocks")

    def _infer_shape(self, known_shape):
        """Complete the 0 dims of ``shape`` from an observed shape."""
        if self.shape is None:
            self.shape = tuple(known_shape)
            return
        if len(known_shape) != len(self.shape):
            raise ValueError(f"Parameter {self.name}: rank mismatch "
                             f"{self.shape} vs {known_shape}")
        new = []
        for s, k in zip(self.shape, known_shape):
            if s > 0 and k > 0 and s != k:
                raise ValueError(f"Parameter {self.name}: shape mismatch "
                                 f"{self.shape} vs {known_shape}")
            new.append(s if s > 0 else k)
        self.shape = tuple(new)

    def shape_is_known(self):
        return self.shape is not None and all(s > 0 for s in self.shape)

    # -- data access ---------------------------------------------------------
    def data(self, ctx=None):
        """The parameter's NDArray (reference: parameter.py:389)."""
        return self._check_and_get(ctx)

    def list_data(self):
        return [self._check_and_get()]

    def grad(self, ctx=None):
        d = self._check_and_get(ctx)
        if d.grad is None:
            raise RuntimeError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                "because grad_req='null'")
        return d.grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise RuntimeError(f"Parameter '{self.name}' has not been "
                               "initialized")
        return self._ctx_list

    def zero_grad(self):
        """Set the gradient to 0 (reference: parameter.py:447)."""
        if self._grad is not None:
            self._grad._data = torch.zeros_like(self._grad._data)

    def set_data(self, data):
        """Set the value (reference: parameter.py:419): copied into the
        existing tensor, or the initial value of a parameter not
        initialized yet."""
        src = data if isinstance(data, NDArray) else NDArray(
            torch.as_tensor(data))
        self._infer_shape(src.shape)
        if self._data is not None:
            with torch.no_grad():
                self._data._data.copy_(src._data)
            return
        if self._deferred_init:
            init, ctx, default_init, _ = self._deferred_init
        else:
            init, ctx, default_init = None, [src.context], None
        self._deferred_init = (init, ctx, default_init, src)
        self._finish_deferred_init()

    def reset_ctx(self, ctx):
        """Move to another device (reference: parameter.py:431)."""
        ctx = [as_context(c) for c in
               (ctx if isinstance(ctx, (list, tuple)) else [ctx])]
        if self._data is not None:
            self._data = NDArray(self._data._data.detach().to(ctx[0].device))
            self._ctx_list = ctx
            if self._grad_req != "null":
                self._init_grad()
        elif self._deferred_init:
            init, _, default_init, data = self._deferred_init
            self._deferred_init = (init, ctx, default_init, data)

    def cast(self, dtype):
        """Cast the data and gradient (reference: parameter.py:469)."""
        self.dtype = dtype
        if self._data is None:
            return
        with autograd.pause():
            self._data = NDArray(self._data._data.detach().to(
                resolve_dtype(dtype)))
            if self._grad_req != "null":
                self._init_grad()


class Constant(Parameter):
    """A constant parameter, never trained (reference:
    parameter.py:600)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = NDArray(torch.as_tensor(value))
        self.value = value

        class _Init(initializer.Initializer):
            def _init_weight(self2, _, arr, generator=None):
                self2._set(arr, value._data)

            _init_default = _init_weight

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=str(value._data.dtype).replace("torch.", ""),
                         init=_Init(), differentiable=False)


class ParameterDict:
    """Parameters by name, with a prefix shared by nested Blocks
    (reference: parameter.py:509)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        body = "\n".join(f"  {v!r}" for v in self.values())
        return f"{name}(\n{body}\n)"

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The Parameter ``prefix + name``, created on first use
        (reference: parameter.py:557)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                if v is not None:
                    setattr(param, k, v)
                continue
            if k == "shape" and v is not None:
                v = (v,) if isinstance(v, int) else tuple(v)
                if len(v) == len(existing):
                    for a, b in zip(existing, v):
                        if a > 0 and b > 0 and a != b:
                            raise AssertionError(
                                f"Parameter '{name}' already exists with "
                                f"shape {existing}, incompatible with "
                                f"requested {v}")
                    param.shape = tuple(a if a > 0 else b
                                        for a, b in zip(existing, v))
            elif k == "dtype" and v is not None and v != existing:
                param.cast(v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"No constant named '{name}'")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        """Add every Parameter of ``other`` (reference: parameter.py:627)."""
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    "Cannot update self with other because they have "
                    f"different Parameters with the same name '{k}'")
            self._params[k] = v

    def initialize(self, init=initializer.Uniform(), ctx=None, verbose=False,
                   force_reinit=False):
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Write every parameter to a ``.params`` file (the format of
        ``ndarray/param_file.py``, the JAX package's), named without
        ``strip_prefix`` (reference: parameter.py:713)."""
        from .. import ndarray as nd
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    f"Prefix '{strip_prefix}' is to be stripped before "
                    f"saving, but Parameter's name '{param.name}' does not "
                    f"start with '{strip_prefix}'")
            arg_dict[param.name[len(strip_prefix):]] = param._check_and_get()
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Read a ``.params`` file: names get ``restore_prefix`` in front
        and lose a Module file's ``arg:`` / ``aux:`` marker; each value is
        copied into its parameter's storage, or is the initial value of
        a parameter not initialized yet, on ``ctx`` when given
        (reference: parameter.py:740)."""
        from .. import ndarray as nd
        from .block import set_param
        arg_dict = nd.load(filename)
        if restore_prefix:
            arg_dict = {restore_prefix + k: v for k, v in arg_dict.items()}
        arg_dict = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                    for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise IOError(f"Parameter '{name}' is missing in file "
                                  f"'{filename}'")
        for name, v in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError(
                        f"Parameter '{name}' loaded from file '{filename}' "
                        "is not present in ParameterDict")
                continue
            set_param(self._params[name], v, ctx)
