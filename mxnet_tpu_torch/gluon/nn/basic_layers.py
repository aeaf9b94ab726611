"""Basic Gluon layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): Sequential, HybridSequential,
Dense, Dropout, BatchNorm, InstanceNorm, LayerNorm, Embedding, Flatten,
Lambda, HybridLambda, HybridConcurrent, Concurrent and Identity. Every
HybridBlock here also runs with ``F = sym`` (export).

BatchNorm in training mode normalises with the batch statistics (mean
and biased variance, as the JAX op's ``jnp.var``) and folds them into
the running statistics in place, outside the graph:
``running = running * momentum + batch * (1 - momentum)``, the JAX
package's formula, through ``block.stateful_write`` (inside a staged
forward the write is returned instead of applied; a symbolic forward
writes nothing).
"""
from __future__ import annotations

import numpy as np
import torch

from ... import autograd
from ...ndarray.ndarray import NDArray
from ..block import Block, HybridBlock, stateful_write
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "Embedding", "Flatten", "Lambda",
           "HybridLambda", "HybridConcurrent", "Concurrent", "Identity"]


class Sequential(Block):
    """Stacks Blocks (reference: basic_layers.py:29)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    """Stacks HybridBlocks (reference: basic_layers.py:92)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    add = Sequential.add
    forward = Sequential.forward
    __len__ = Sequential.__len__
    __getitem__ = Sequential.__getitem__
    __iter__ = Sequential.__iter__

    def hybrid_forward(self, F, x):
        return self.forward(x)


class Dense(HybridBlock):
    """``act(x @ W.T + b)``, W of shape (units, in_units) (reference:
    basic_layers.py:128)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        self._in_units = in_units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def infer_shape(self, x):
        in_units = int(np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight._infer_shape((self._units, in_units))
        if self.bias is not None:
            self.bias._infer_shape((self._units,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        shape = self.weight.shape
        return (f"{self.__class__.__name__}"
                f"({shape[1] if len(shape) > 1 and shape[1] else None} -> "
                f"{shape[0]}, "
                f"{'linear' if self.act is None else self.act._act_type})")


class Dropout(HybridBlock):
    """(reference: basic_layers.py:219)"""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return (f"{self.__class__.__name__}(p = {self._rate}, "
                f"axes={self._axes})")


class BatchNorm(HybridBlock):
    """Batch normalization with running statistics (reference:
    basic_layers.py:262)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self._momentum = momentum
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p._infer_shape((c,))

    def cast(self, dtype):
        if np.dtype(dtype).name == "float16":
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = autograd.is_training()
        out, batch_mean, batch_var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, training=training,
            **self._kwargs)
        if training and not self._kwargs["use_global_stats"] and \
                isinstance(x, NDArray):
            m = self._momentum
            with torch.no_grad():
                for p, run, batch in ((self.running_mean, running_mean,
                                       batch_mean),
                                      (self.running_var, running_var,
                                       batch_var)):
                    stateful_write(p, run._data * m
                                   + batch._data.detach() * (1 - m))
        return out

    def __repr__(self):
        in_channels = self.gamma.shape[0] if self.gamma.shape else None
        return (f"{self.__class__.__name__}(axis={self._axis}, "
                f"eps={self._kwargs['eps']}, momentum={self._momentum}, "
                f"in_channels={in_channels})")


class InstanceNorm(HybridBlock):
    """Instance normalization over the spatial dims of each sample and
    channel (reference: basic_layers.py:415)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._epsilon = epsilon
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x):
        c = x.shape[self._axis]
        self.gamma._infer_shape((c,))
        self.beta._infer_shape((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis != 1:
            x = x.swapaxes(1, self._axis)
        out = F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        return out if self._axis == 1 else out.swapaxes(1, self._axis)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` (reference:
    basic_layers.py:497)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x):
        c = x.shape[self._axis]
        self.gamma._infer_shape((c,))
        self.beta._infer_shape((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    """Index -> dense vector lookup (reference: basic_layers.py:565; the
    ``Embedding`` op of ``ops/shape_ops.py``)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)

    def infer_shape(self, x):
        pass

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        return (f"{self.__class__.__name__}({self._input_dim} -> "
                f"{self._output_dim}, {self._kwargs['dtype']})")


class Flatten(HybridBlock):
    """(reference: basic_layers.py:629)"""

    def hybrid_forward(self, F, x):
        return x.reshape((0, -1))

    def __repr__(self):
        return self.__class__.__name__


class HybridConcurrent(HybridBlock):
    """Runs every child on the same input and concatenates their outputs
    along ``axis`` (reference: gluon/contrib/nn/basic_layers.py)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Concurrent(HybridConcurrent):
    """``HybridConcurrent`` under the reference's non-hybrid name."""


class Identity(HybridBlock):
    """Returns its input (reference: gluon/contrib/nn Identity)."""

    def hybrid_forward(self, F, x):
        return x


def _named_function(function, owner):
    """``(name, function of F and the inputs)`` of a Lambda's
    ``function``: a callable, or the name of an ``nd`` function."""
    if isinstance(function, str):
        from ... import ndarray as nd
        if not hasattr(nd, function):
            raise ValueError(f"Function name {function} is not found in "
                             "ndarray namespace")
        return function, (lambda F, *args: getattr(F, function)(*args))
    if callable(function):
        return function.__name__, None
    raise ValueError(f"Unrecognized function in {owner}: {function} of "
                     f"type {type(function)}")


class Lambda(Block):
    """Wraps a function of NDArrays as a Block (reference:
    basic_layers.py:647)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_name, by_name = _named_function(function, "lambda")
        if by_name is None:
            self._func_impl = function
        else:
            from ... import ndarray as nd
            self._func_impl = getattr(nd, function)

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._func_name})"


class HybridLambda(HybridBlock):
    """Wraps a function ``f(F, *inputs)`` as a HybridBlock (reference:
    basic_layers.py:694)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_name, by_name = _named_function(function, "lambda")
        self._func = function if by_name is None else by_name

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._func_name})"
