"""Neural-network ops of the ResNet serving path (counterpart of
``mxnet_tpu/ops/nn.py``), as plain PyTorch on NCHW tensors.

Attributes, defaults and output arity are the JAX ops'. Convolution and
FullyConnected go to ``F.conv2d`` / ``torch.matmul``, as the JAX package
leaves them to XLA outside any Pallas kernel. Each op keeps the dtype of
its data input, like the JAX ops do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register_op


def _tup(v, n):
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _need_4d(op, data):
    if data.dim() != 4:
        raise MXNetError(f"{op}: the port supports 4-D NCHW data only "
                         f"(got shape {tuple(data.shape)})")


@register_op("FullyConnected")
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **kw):
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    out = torch.matmul(x, weight.to(x.dtype).t())
    if not no_bias and bias is not None:
        out = out + bias.to(out.dtype)
    return out


@register_op("Convolution")
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, cudnn_tune=None, cudnn_off=False,
                workspace=None, layout=None, **kw):
    _need_4d("Convolution", data)
    if layout not in (None, "NCHW"):
        raise MXNetError(f"Convolution: layout {layout!r} is not supported")
    out = F.conv2d(data, weight.to(data.dtype), None,
                   stride=_tup(stride, 2) or (1, 1),
                   padding=_tup(pad, 2) or (0, 0),
                   dilation=_tup(dilate, 2) or (1, 1),
                   groups=int(num_group))
    if not no_bias and bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out


@register_op("Pooling")
def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            cudnn_off=False, count_include_pad=True, **kw):
    _need_4d("Pooling", data)
    if global_pool:
        if pool_type == "max":
            return torch.amax(data, dim=(2, 3), keepdim=True)
        if pool_type == "sum":
            return torch.sum(data, dim=(2, 3), keepdim=True)
        return torch.mean(data, dim=(2, 3), keepdim=True)
    if pooling_convention != "valid":
        raise MXNetError(f"Pooling: pooling_convention="
                         f"{pooling_convention!r} is not supported")
    kernel = _tup(kernel, 2)
    stride = _tup(stride, 2) or (1, 1)
    pad = _tup(pad, 2) or (0, 0)
    if pool_type == "max":
        # padding counts as -inf, as the JAX op's reduce_window init does
        return F.max_pool2d(data, kernel, stride, pad)
    if pool_type == "avg":
        return F.avg_pool2d(data, kernel, stride, pad,
                            count_include_pad=bool(count_include_pad))
    if pool_type == "sum":
        return F.avg_pool2d(data, kernel, stride, pad,
                            count_include_pad=True) \
            * (kernel[0] * kernel[1])
    raise MXNetError(f"Pooling: pool_type {pool_type!r} is not supported")


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


@register_op("Activation")
def activation(data, act_type="relu", **kw):
    return _ACTIVATIONS[act_type](data)


@register_op("SoftmaxOutput", aliases=["Softmax"])
def softmax_output(data, label=None, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0, **kw):
    """Inference forward of SoftmaxOutput: the softmax (the label is not
    read)."""
    return torch.softmax(data, dim=1 if multi_output else -1)


@register_op("BatchNorm", num_outputs=3)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               training=False, **kw):
    """Returns (out, mean, var) in eval mode, from the moving statistics
    (batch statistics belong to the training slice)."""
    if training and not use_global_stats:
        raise NotImplementedError("training comes in the next slice")
    ax = axis % data.dim()
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    mean, var = moving_mean, moving_var
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt(var + eps)
    out = (data - mean.reshape(bshape)) * (g * inv).reshape(bshape) \
        + beta.reshape(bshape)
    return out.to(data.dtype), mean, var
