"""Neural-network ops of the ResNet serving and training paths
(counterpart of ``mxnet_tpu/ops/nn.py``), as plain PyTorch on NCHW
tensors, differentiable by autograd.

Attributes, defaults and output arity are the JAX ops'. Convolution,
FullyConnected and the space-to-depth stem go to ``F.conv2d`` /
``torch.matmul``, as the JAX package leaves them to XLA outside any
Pallas kernel. Each op keeps the dtype of its data input, like the JAX
ops do.
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


@register_op("conv_s2d_stem", aliases=["_contrib_conv_s2d_stem"])
def conv_s2d_stem(data, weight, **kw):
    """The exact space-to-depth rewrite of the 7x7/s2/pad3 ImageNet stem
    conv (the JAX op's arithmetic): block-2 space-to-depth on the input,
    the same (O, C, 7, 7) weight front-padded to 8x8 and folded to
    (O, 4C, 4, 4), then a stride-1 conv with block-space pads (2, 1).
    Identical output to Convolution(kernel=7, stride=2, pad=3) for even
    H, W, from the same weight."""
    def _is(name, want):
        v = kw.get(name)
        return v is None or tuple(v) == want
    if not (_is("kernel", (7, 7)) and _is("stride", (2, 2))
            and _is("pad", (3, 3)) and _is("dilate", (1, 1))
            and int(kw.get("num_group", 1)) == 1):
        raise ValueError(
            "conv_s2d_stem implements exactly Convolution(kernel=(7,7), "
            "stride=(2,2), pad=(3,3), no dilation/groups); use the plain "
            "Convolution op for other geometries")
    _need_4d("conv_s2d_stem", data)
    b, c, h, w = data.shape
    if h % 2 or w % 2:
        raise ValueError(f"conv_s2d_stem needs even spatial dims "
                         f"(space-to-depth block 2); got input {h}x{w}")
    o = weight.shape[0]
    xs = data.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 1, 3, 5, 2, 4).reshape(b, c * 4, h // 2, w // 2)
    w8 = F.pad(weight.to(data.dtype), (1, 0, 1, 0))
    wf = w8.reshape(o, c, 4, 2, 4, 2).permute(0, 1, 3, 5, 2, 4).reshape(
        o, c * 4, 4, 4)
    return F.conv2d(F.pad(xs, (2, 1, 2, 1)), wf).to(data.dtype)


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
    """Forward of SoftmaxOutput: the softmax (the label is not read).
    Its backward (p - y) is the gradient of ``softmax_output_loss``,
    which the training step pairs with the head."""
    return torch.softmax(data, dim=1 if multi_output else -1)


def softmax_output_loss(data, label, grad_scale=1.0, ignore_label=-1.0,
                        use_ignore=False, multi_output=False,
                        normalization="null", smooth_alpha=0.0, **kw):
    """Cross-entropy whose gradient wrt data equals SoftmaxOutput's
    backward. Normalization "null" (the default) is the SUM of the rows'
    cross-entropies, so each row's gradient is its unscaled p - y (the
    optimizer's rescale_grad = 1/batch averages); "batch" takes the
    mean; "valid" with ``use_ignore`` divides by the rows kept."""
    axis = 1 if multi_output else -1
    logp = torch.log_softmax(data, dim=axis)
    lab = label.to(torch.int64)
    nll = -torch.gather(logp, axis, lab.unsqueeze(axis)).squeeze(axis)
    if use_ignore:
        mask = (lab != int(ignore_label)).to(data.dtype)
        nll = nll * mask
        if normalization == "valid":
            return grad_scale * nll.sum() / torch.clamp_min(mask.sum(), 1.0)
    if normalization == "batch":
        return grad_scale * nll.mean()
    return grad_scale * nll.sum()


@register_op("BatchNorm", num_outputs=3)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               training=False, **kw):
    """Returns (out, mean, var): batch statistics in training (the mean
    and the biased variance, as ``jnp.var``), the moving statistics
    otherwise. The running-statistics fold is the caller's
    (``Symbol._bn_aux_updates``), never done here."""
    ax = axis % data.dim()
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    if training and not use_global_stats:
        red = tuple(i for i in range(data.dim()) if i != ax)
        var, mean = torch.var_mean(data, dim=red, unbiased=False)
    else:
        mean, var = moving_mean, moving_var
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt(var + eps)
    out = (data - mean.reshape(bshape)) * (g * inv).reshape(bshape) \
        + beta.reshape(bshape)
    return out.to(data.dtype), mean, var
