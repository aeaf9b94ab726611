"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): 1-, 2- and 3-D convolutions,
transposed convolutions and pools, the global pools and
``ReflectionPad2D``, in the NC* layouts (NCW, NCHW, NCDHW). The
convolutions go to ``F.conv{1,2,3}d`` / ``F.conv_transpose{1,2,3}d``
(cuDNN), as the JAX package leaves them to XLA. A transposed
convolution's weight has MXNet's ``(in_channels, channels / groups,
*kernel)`` layout."""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]

_LAYOUTS = ("NCW", "NCHW", "NCDHW")


def _to_tuple(val, n):
    if isinstance(val, (int, np.integer)):
        return (int(val),) * n
    return tuple(int(v) for v in val)


class _Conv(HybridBlock):
    """Base convolution layer (reference: conv_layers.py:33)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if layout != _LAYOUTS[len(kernel_size) - 1]:
            raise NotImplementedError(
                f"layout {layout!r}: the port's convolutions take "
                f"{_LAYOUTS[len(kernel_size) - 1]}")
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            ndim = len(kernel_size)
            self._layout = layout
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias}
            if adj is not None:
                self._kwargs["adj"] = adj
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups) + kernel_size
            else:  # Deconvolution weight layout is (in, out/g, *k)
                wshape = (in_channels, channels // groups) + kernel_size
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x):
        in_c = x.shape[1]  # NC* layout
        groups = self._kwargs["num_group"]
        if self._op_name == "Convolution":
            self.weight._infer_shape(
                (self._channels, in_c // groups) + self._kwargs["kernel"])
        else:
            self.weight._infer_shape(
                (in_c, self._channels // groups) + self._kwargs["kernel"])
        if self.bias is not None:
            self.bias._infer_shape((self._channels,))

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            act = op(x, weight, **self._kwargs)
        else:
            act = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def _alias(self):
        return "conv"

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        len_kernel_size = len(self._kwargs["kernel"])
        if self._kwargs["pad"] != (0,) * len_kernel_size:
            s += ", padding={pad}"
        if self._kwargs["dilate"] != (1,) * len_kernel_size:
            s += ", dilation={dilate}"
        if self._kwargs["num_group"] != 1:
            s += ", groups={num_group}"
        if self.bias is None:
            s += ", bias=False"
        s += ")"
        shape = self.weight.shape
        return s.format(
            name=self.__class__.__name__,
            mapping=f"{shape[1] if shape[1] else None} -> {shape[0]}",
            **self._kwargs)


class Conv1D(_Conv):
    """(reference: conv_layers.py:153)"""

    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 1), _to_tuple(strides, 1),
            _to_tuple(padding, 1), _to_tuple(dilation, 1), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


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


class Conv3D(_Conv):
    """(reference: conv_layers.py:306)"""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 3), _to_tuple(strides, 3),
            _to_tuple(padding, 3), _to_tuple(dilation, 3), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    """(reference: conv_layers.py:388)"""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 1), _to_tuple(strides, 1),
            _to_tuple(padding, 1), _to_tuple(dilation, 1), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name="Deconvolution",
            adj=_to_tuple(output_padding, 1), **kwargs)
        self.outpad = _to_tuple(output_padding, 1)


class Conv2DTranspose(_Conv):
    """(reference: conv_layers.py:476)"""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 2), _to_tuple(strides, 2),
            _to_tuple(padding, 2), _to_tuple(dilation, 2), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name="Deconvolution",
            adj=_to_tuple(output_padding, 2), **kwargs)
        self.outpad = _to_tuple(output_padding, 2)


class Conv3DTranspose(_Conv):
    """(reference: conv_layers.py:566)"""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 3), _to_tuple(strides, 3),
            _to_tuple(padding, 3), _to_tuple(dilation, 3), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name="Deconvolution",
            adj=_to_tuple(output_padding, 3), **kwargs)
        self.outpad = _to_tuple(output_padding, 3)


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
                f"padding={self._kwargs['pad']}, "
                f"ceil_mode="
                f"{self._kwargs['pooling_convention'] == 'full'})")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(
            _to_tuple(pool_size, 1),
            None if strides is None else _to_tuple(strides, 1),
            _to_tuple(padding, 1), ceil_mode, False, "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(
            _to_tuple(pool_size, 2),
            None if strides is None else _to_tuple(strides, 2),
            _to_tuple(padding, 2), ceil_mode, False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(
            _to_tuple(pool_size, 3),
            None if strides is None else _to_tuple(strides, 3),
            _to_tuple(padding, 3), ceil_mode, False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(
            _to_tuple(pool_size, 1),
            None if strides is None else _to_tuple(strides, 1),
            _to_tuple(padding, 1), ceil_mode, False, "avg", count_include_pad,
            **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(
            _to_tuple(pool_size, 2),
            None if strides is None else _to_tuple(strides, 2),
            _to_tuple(padding, 2), ceil_mode, False, "avg", count_include_pad,
            **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(
            _to_tuple(pool_size, 3),
            None if strides is None else _to_tuple(strides, 3),
            _to_tuple(padding, 3), ceil_mode, False, "avg", count_include_pad,
            **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max", **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         **kwargs)


class ReflectionPad2D(HybridBlock):
    """(reference: conv_layers.py:1042; op Pad mode='reflect')"""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
