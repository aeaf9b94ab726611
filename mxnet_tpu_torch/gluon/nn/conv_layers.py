"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): the 2-D ones ResNet uses, NCHW.
The convolution goes to ``F.conv2d`` (cuDNN), as the JAX package leaves
it to XLA."""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _to_tuple(val, n):
    if isinstance(val, (int, np.integer)):
        return (int(val),) * n
    return tuple(int(v) for v in val)


class _Conv(HybridBlock):
    """Base convolution layer (reference: conv_layers.py:33)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if layout != "NCHW":
            raise NotImplementedError(f"layout {layout!r}: the port's "
                                      "convolution takes NCHW")
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias}
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // groups)
                + kernel_size, init=weight_initializer,
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def infer_shape(self, x):
        groups = self._kwargs["num_group"]
        self.weight._infer_shape((self._channels, x.shape[1] // groups)
                                 + self._kwargs["kernel"])
        if self.bias is not None:
            self.bias._infer_shape((self._channels,))

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            act = F.Convolution(x, weight, **self._kwargs)
        else:
            act = F.Convolution(x, weight, bias, **self._kwargs)
        return self.act(act) if self.act is not None else act

    def _alias(self):
        return "conv"

    def __repr__(self):
        shape = self.weight.shape
        return (f"{self.__class__.__name__}"
                f"({shape[1] if shape[1] else None} -> {shape[0]}, "
                f"kernel_size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']})")


class Conv2D(_Conv):
    """(reference: conv_layers.py:227)"""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 2), _to_tuple(strides, 2),
            _to_tuple(padding, 2), _to_tuple(dilation, 2), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    """Base pooling layer (reference: conv_layers.py:656)."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", count_include_pad=None,
                 **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return (f"{self.__class__.__name__}(size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"padding={self._kwargs['pad']})")


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(
            _to_tuple(pool_size, 2),
            None if strides is None else _to_tuple(strides, 2),
            _to_tuple(padding, 2), ceil_mode, False, "max", **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(
            _to_tuple(pool_size, 2),
            None if strides is None else _to_tuple(strides, 2),
            _to_tuple(padding, 2), ceil_mode, False, "avg",
            count_include_pad, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", **kwargs)
