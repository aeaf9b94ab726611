"""Neural-network ops of the ResNet serving and training paths and of
the Gluon layers (counterpart of ``mxnet_tpu/ops/nn.py``), as plain
PyTorch on NC* tensors, differentiable by autograd.

Attributes, defaults and output arity are the JAX ops'. Convolution and
Deconvolution (1-, 2- and 3-D), FullyConnected and the space-to-depth
stem go to ``F.conv{1,2,3}d`` / ``F.conv_transpose{1,2,3}d`` /
``torch.matmul``, as the JAX package leaves them to XLA outside any
Pallas kernel. Each op keeps the dtype of its data input, like the JAX
ops do, with the JAX ops' promotions where the dtypes mix: a
convolution runs in its data's dtype and a float32 bias added to a
bf16 result promotes it to float32, and FullyConnected computes in the
promoted dtype of its data and weight (``jnp.matmul``'s rule).
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


# the convolutions and pools of 1, 2 and 3 spatial dims, NC* layouts
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _spatial(op, data, layout=None):
    """The count of spatial dims of NC* ``data`` (1 to 3)."""
    sdims = data.dim() - 2
    if sdims not in _CONV:
        raise MXNetError(f"{op}: data of 3 to 5 dims (NCW, NCHW, NCDHW), "
                         f"got shape {tuple(data.shape)}")
    if layout not in (None, _LAYOUTS[sdims]):
        raise MXNetError(f"{op}: layout {layout!r} is not supported")
    return sdims


def _bias_add(out, bias, sdims):
    return out + bias.reshape((1, -1) + (1,) * sdims)


@register_op("FullyConnected")
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **kw):
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt).t())
    if not no_bias and bias is not None:
        out = out + bias
    return out


@register_op("Convolution")
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, cudnn_tune=None, cudnn_off=False,
                workspace=None, layout=None, **kw):
    n = _spatial("Convolution", data, layout)
    out = _CONV[n](data, weight.to(data.dtype), None,
                   stride=_tup(stride, n) or (1,) * n,
                   padding=_tup(pad, n) or (0,) * n,
                   dilation=_tup(dilate, n) or (1,) * n,
                   groups=int(num_group))
    if not no_bias and bias is not None:
        out = _bias_add(out, bias, n)
    return out


def deconv_geometry(in_shape, kernel, stride, dilate, pad, adj,
                    target_shape=None):
    """``(pad, adj)`` of a Deconvolution over the spatial ``in_shape``.
    With a ``target_shape`` (all dims > 0) the output takes that size and
    the pads and adjustments come from it, as the reference's
    ``DeconvolutionParam::InferPad`` computes them: total = stride *
    (in - 1) + dilated kernel - target, adj = total % 2, pad = (total +
    1) // 2."""
    if not target_shape or not all(int(t) > 0 for t in target_shape):
        return pad, adj
    pads, adjs = [], []
    for x, k, s, d, t in zip(in_shape, kernel, stride, dilate,
                             target_shape):
        total = s * (x - 1) + d * (k - 1) + 1 - int(t)
        if total < 0:
            raise MXNetError(f"Deconvolution: target_shape {target_shape} "
                             f"is larger than the kernel can reach")
        adjs.append(total % 2)
        pads.append((total + 1) // 2)
    return tuple(pads), tuple(adjs)


@register_op("Deconvolution")
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_filter=None, num_group=1, no_bias=True, workspace=None,
                  cudnn_tune=None, cudnn_off=False, layout=None, **kw):
    """Transposed convolution (reference: src/operator/nn/
    deconvolution.cc). The weight keeps MXNet's ``(Cin, Cout / groups,
    *kernel)`` layout, which is ``F.conv_transpose*d``'s own; the output
    size is ``(in - 1) * stride - 2 * pad + dilate * (kernel - 1) + adj
    + 1`` (the JAX op's gradient-of-convolution form gives the same).
    ``target_shape`` sets pad and adj as the reference does
    (``deconv_geometry``)."""
    n = _spatial("Deconvolution", data, layout)
    stride = _tup(stride, n) or (1,) * n
    dilate = _tup(dilate, n) or (1,) * n
    kernel = _tup(kernel, n) or tuple(weight.shape[2:])
    pad, adj = deconv_geometry(tuple(data.shape[2:]), kernel, stride,
                               dilate, _tup(pad, n) or (0,) * n,
                               _tup(adj, n) or (0,) * n,
                               _tup(target_shape, n))
    out = _CONV_T[n](data, weight.to(data.dtype), None, stride=stride,
                     padding=pad, output_padding=adj, groups=int(num_group),
                     dilation=dilate)
    if not no_bias and bias is not None:
        out = _bias_add(out, bias, n)
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
            cudnn_off=False, count_include_pad=True, layout=None, **kw):
    n = _spatial("Pooling", data, layout)
    if global_pool:
        dims = tuple(range(2, 2 + n))
        if pool_type == "max":
            return torch.amax(data, dim=dims, keepdim=True)
        if pool_type == "sum":
            return torch.sum(data, dim=dims, keepdim=True)
        return torch.mean(data, dim=dims, keepdim=True)
    if pooling_convention not in ("valid", "full"):
        raise MXNetError(f"Pooling: pooling_convention="
                         f"{pooling_convention!r} is not supported")
    kernel = _tup(kernel, n)
    stride = _tup(stride, n) or (1,) * n
    pad = _tup(pad, n) or (0,) * n
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"Pooling: pool_type {pool_type!r} is not "
                         "supported")
    if pooling_convention == "full":
        return _pool_full(data, n, kernel, pool_type, stride, pad,
                          count_include_pad)
    window = 1
    for k in kernel:
        window *= k
    if pool_type == "max":
        # padding counts as -inf, as the JAX op's reduce_window init does
        return _MAX_POOL[n](data, kernel, stride, pad)
    if pool_type == "avg":
        return _AVG_POOL[n](data, kernel, stride, pad,
                            count_include_pad=bool(count_include_pad))
    return _AVG_POOL[n](data, kernel, stride, pad,
                        count_include_pad=True) * window


def _pool_full(data, n, kernel, pool_type, stride, pad, count_include_pad):
    """Pooling with ``pooling_convention="full"`` (ceil-mode output
    size), as the JAX op computes it: each spatial axis is padded by
    ``pad`` in front and behind by what ``ceil((x + 2p - k) / s) + 1``
    windows need (at least ``pad``), then pooled without padding. Max
    pads with -inf (the dtype's minimum for integers); avg divides by
    the window size with ``count_include_pad``, else by the count of
    input elements in the window; sum adds."""
    pads = []
    for x, k, s, p in zip(reversed(data.shape[2:]), reversed(kernel),
                          reversed(stride), reversed(pad)):
        out = -(-(x + 2 * p - k) // s) + 1
        pads += [p, max((out - 1) * s + k - x - p, p)]
    if pool_type == "max":
        fill = float("-inf") if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        return _MAX_POOL[n](F.pad(data, pads, value=fill), kernel, stride)
    window = 1
    for k in kernel:
        window *= k
    avg = _AVG_POOL[n](F.pad(data, pads), kernel, stride)
    if pool_type == "avg" and count_include_pad:
        return avg
    summed = avg * window
    if pool_type == "sum":
        return summed
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    counts = _AVG_POOL[n](F.pad(ones, pads), kernel, stride) * window
    return summed / counts


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


@register_op("Activation")
def activation(data, act_type="relu", **kw):
    return _ACTIVATIONS[act_type](data)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register_op("LeakyReLU")
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, **kw):
    """leaky / elu / prelu / selu / rrelu (reference:
    src/operator/leaky_relu-inl.h), the JAX op's math: prelu's ``gamma``
    is per channel (axis 1) when 1-D; rrelu takes the mean of its slope
    bounds, the reference's inference slope, in every mode."""
    pos = data > 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(pos, data, g.to(data.dtype) * data)
    if act_type == "selu":
        return _SELU_SCALE * torch.where(pos, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "rrelu":
        s = (lower_bound + upper_bound) / 2.0
        return torch.where(pos, data, s * data)
    raise MXNetError(f"LeakyReLU: unknown act_type {act_type!r}")


@register_op("SoftmaxOutput", aliases=["Softmax"])
def softmax_output(data, label=None, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0, **kw):
    """Forward of SoftmaxOutput: the softmax (the label is not read).
    Its backward (p - y) is the gradient of ``softmax_output_loss``,
    which the training step pairs with the head."""
    return torch.softmax(data, dim=1 if multi_output else -1)


@register_op("SVMOutput")
def svm_output(data, label=None, margin=1.0, regularization_coefficient=1.0,
               use_linear=False, **kw):
    """Forward of SVMOutput: the scores; its hinge backward is an
    implicit loss (``executor._IMPLICIT_LOSS``)."""
    return data


@register_op("LinearRegressionOutput")
def linear_regression_output(data, label=None, grad_scale=1.0, **kw):
    return data


@register_op("MAERegressionOutput")
def mae_regression_output(data, label=None, grad_scale=1.0, **kw):
    return data


@register_op("LogisticRegressionOutput")
def logistic_regression_output(data, label=None, grad_scale=1.0, **kw):
    return torch.sigmoid(data)


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


@register_op("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kw):
    """Local response normalisation across channels (the JAX package's
    ``ops/nn.py`` ``lrn``): ``x / (knorm + alpha/nsize * sum of x**2 over
    the nsize channels centred on x) ** beta``, zeros beyond the edges.
    Plain PyTorch, differentiable by autograd."""
    nsize = int(nsize)
    half = nsize // 2
    sq = data * data
    padded = F.pad(sq, (0, 0) * (data.dim() - 2) + (half, half))
    c = data.shape[1]
    window = padded[:, 0:c]
    for i in range(1, nsize):
        window = window + padded[:, i:i + c]
    return data / torch.pow(knorm + alpha / nsize * window, beta)


@register_op("LayerNorm")
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
               **kw):
    """Normalise over ``axis`` with the population variance (``jnp.var``,
    not ``torch.var``'s unbiased default); with ``output_mean_var`` also
    the mean and variance, ``axis`` squeezed."""
    ax = axis % data.dim()
    var, mean = torch.var_mean(data, dim=ax, keepdim=True, correction=0)
    inv = torch.rsqrt(var + eps)
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    out = (data - mean) * inv * gamma.reshape(bshape) + beta.reshape(bshape)
    if output_mean_var:
        return out, mean.squeeze(ax), var.squeeze(ax)
    return out


@register_op("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3, **kw):
    """Normalise each sample's channel over its spatial dims with the
    population variance (reference: src/operator/instance_norm-inl.h),
    then scale by ``gamma`` and shift by ``beta`` per channel."""
    red = tuple(range(2, data.dim()))
    var, mean = torch.var_mean(data, dim=red, keepdim=True, correction=0)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


# the additive mask of the JAX package's ring attention
# (``mxnet_tpu/parallel/ring.py``): a masked logit's exp underflows to an
# exact 0.0
_NEG = -1e30


def local_attention_block(q, k, v, bias=None, scale=None):
    """Dense softmax attention of one (q-block, kv-block) pair, the JAX
    package's ``parallel/ring.py`` ``local_attention_block``: q (B, Tq, H,
    D), k / v (B, Tk, H, D); returns (out, row_max, row_sum). The row max
    only stabilises the exponent (the result does not depend on it), so
    it is taken detached and the backward keeps the probabilities
    alone."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    m = torch.amax(s, dim=-1).detach()
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m, l


@register_op("CausalSelfAttention")
def causal_self_attention(data, num_heads=1, scale=None, **kw):
    """Causal multi-head self-attention over packed QKV (the JAX
    package's math: einsum, the ``-1e30`` additive mask, a max-stable
    softmax; the whole (B, H, S, S) score matrix is materialised).

    data: (B, S, 3 * num_heads * head_dim), the fused QKV projection.
    Returns (B, S, num_heads * head_dim); position i attends to
    positions <= i."""
    b, s, three_hd = data.shape
    h = int(num_heads)
    d = three_hd // (3 * h)
    q, k, v = data.reshape(b, s, 3, h, d).unbind(2)
    pos = torch.arange(s, device=data.device)
    bias = torch.where(pos[:, None] >= pos[None, :],
                       torch.zeros((), dtype=data.dtype, device=data.device),
                       torch.full((), _NEG, dtype=data.dtype,
                                  device=data.device))
    o, _, l = local_attention_block(q, k, v, bias=bias[None, None],
                                    scale=scale)
    out = o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.reshape(b, s, h * d).to(data.dtype)


@register_op("softmax")
def softmax(data, axis=-1, temperature=None, length=None, **kw):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


@register_op("log_softmax")
def log_softmax(data, axis=-1, temperature=None, **kw):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


@register_op("CTCLoss", aliases=["ctc_loss", "_contrib_CTCLoss",
                                 "_contrib_ctc_loss"])
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first", **kw):
    """CTC negative log-likelihood per sample: data (T, N, C) unnormalised
    (softmax taken here, in fp32), label (N, L) padded token ids; blank is
    class 0 ("first", padding 0) or C-1 ("last", padding -1). Returns
    (N,)."""
    t, n, c = data.shape
    logp = torch.log_softmax(data.float(), dim=-1)
    blank = 0 if blank_label == "first" else c - 1
    pad_val = 0 if blank_label == "first" else -1
    lab = label.to(torch.int64)
    if use_data_lengths and data_lengths is not None:
        t_lens = data_lengths.to(torch.int64)
    else:
        t_lens = torch.full((n,), t, dtype=torch.int64, device=data.device)
    if use_label_lengths and label_lengths is not None:
        l_lens = label_lengths.to(torch.int64)
    else:
        l_lens = (lab != pad_val).sum(dim=1)
    return F.ctc_loss(logp, lab.clamp_min(0), t_lens, l_lens, blank=blank,
                      reduction="none")


# ---------------------------------------------------------------------------
# Dropout and the fused RNN (the JAX package's ops/nn.py:411-568)
# ---------------------------------------------------------------------------
def _generator(device, generator):
    if generator is not None:
        return generator
    from .. import random as _random
    return _random.generator(device)


def _keep_mask(shape, keep, dtype, device, generator):
    """``bernoulli(keep) / keep`` of ``shape``, drawn from ``generator``
    (the device's explicit generator when None)."""
    u = torch.rand(shape, device=device,
                   generator=_generator(device, generator))
    return (u < keep).to(dtype) / keep


@register_op("Dropout")
def dropout(data, p=0.5, mode="training", axes=None, training=None,
            generator=None, **kw):
    """Inverted dropout (reference: src/operator/nn/dropout.cc): in
    training (or ``mode="always"``) each element, or each slice along
    the dims not in ``axes``, is kept with probability 1 - p and scaled
    by 1 / (1 - p). The mask draws from ``generator``; the op is the
    identity at p = 0, outside training and on meta tensors."""
    is_training = training if training is not None else True
    if (not is_training and mode != "always") or p <= 0.0 \
            or data.device.type == "meta":
        return data
    shape = tuple(data.shape)
    if axes:
        shape = tuple(1 if i in tuple(axes) else s
                      for i, s in enumerate(shape))
    return data * _keep_mask(shape, 1.0 - p, data.dtype, data.device,
                             generator)


def _rnn_gate_count(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_unpack_params(params, mode, num_layers, input_size, state_size,
                      bidirectional=False):
    """Per layer and direction ``[wx, wh, bx, bh]``, views of the flat
    cuDNN-layout vector: every layer's weights, then every layer's
    biases (reference: rnn-inl.h GetRnnParamSize)."""
    ngates = _rnn_gate_count(mode)
    dirs = 2 if bidirectional else 1
    layers = []
    off = 0
    for layer in range(num_layers):
        for _ in range(dirs):
            isz = input_size if layer == 0 else state_size * dirs
            wx_n = ngates * state_size * isz
            wh_n = ngates * state_size * state_size
            wx = params[off:off + wx_n].reshape(ngates * state_size, isz)
            off += wx_n
            wh = params[off:off + wh_n].reshape(ngates * state_size,
                                                state_size)
            off += wh_n
            layers.append([wx, wh, None, None])
    for layer in range(num_layers):
        for d in range(dirs):
            b_n = ngates * state_size
            layers[layer * dirs + d][2] = params[off:off + b_n]
            off += b_n
            layers[layer * dirs + d][3] = params[off:off + b_n]
            off += b_n
    return layers


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False):
    """Length of the flat parameter vector."""
    ngates = _rnn_gate_count(mode)
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        total += dirs * ngates * state_size * (isz + state_size + 2)
    return total


@register_op("_rnn_zero_state")
def rnn_zero_state(data, state_size=0, num=0, batch_axis=0, **kw):
    """Zero initial state from a data symbol's batch dim: (num, N,
    state_size) from (T, N, C) data when ``num`` > 0, else
    (data.shape[batch_axis], state_size)."""
    n = data.shape[1] if num else data.shape[int(batch_axis)]
    shape = (int(num), n, int(state_size)) if num else (n, int(state_size))
    return torch.zeros(shape, dtype=data.dtype, device=data.device)


def _run_layer(xs, mode, wx, wh, bx, bh, h0, c0=None, reverse=False):
    """One layer and direction over (T, N, C) ``xs``: ``(carry, ys)``,
    carry ``(c, h)`` for lstm, ``(h,)`` otherwise. The input product of
    every step is one matmul over T*N rows. lstm runs the route
    ``lstm_cell._l1_plan`` names: the layer function ``lstm_layer`` (the
    fused step a launch each way in bf16 on the card, the plain steps on
    the CPU) or, in fp32 on the card, a matmul a step and ``lstm_cell``
    (L1's pointwise pass). gru and the vanilla cells are plain PyTorch,
    as the reference has no kernel there."""
    from . import lstm_cell as lc
    steps = range(xs.shape[0] - 1, -1, -1) if reverse \
        else range(xs.shape[0])
    # unbind, not gx[t]: its backward stacks the steps' gradients once,
    # where indexing would add each into a zeroed (T, N, G) buffer
    gx = torch.matmul(xs, wx.t())
    ys = [None] * xs.shape[0]
    h = h0
    if mode == "lstm":
        b, c = bx + bh, c0
        plan = lc._l1_plan(xs.dtype, xs.shape[1], wh.shape[1], xs.device)
        if plan.route != "triton":
            out, h, c = lc.lstm_layer(gx, wh, b, h0, c0, reverse)
            return (c, h), out
        gxs = gx.unbind(0)
        for t in steps:
            h, c = lc.lstm_cell(gxs[t], torch.matmul(h, wh.t()), b, c)
            ys[t] = h
        return (c, h), torch.stack(ys)
    if mode == "gru":
        gxs = (gx + bx).unbind(0)
        for t in steps:
            rx, zx, nx = gxs[t].chunk(3, dim=-1)
            rh, zh, nh = (torch.matmul(h, wh.t()) + bh).chunk(3, dim=-1)
            r = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx + r * nh)
            h = (1 - z) * n + z * h
            ys[t] = h
        return (h,), torch.stack(ys)
    act = torch.tanh if mode == "rnn_tanh" else torch.relu
    b = bx + bh
    gxs = gx.unbind(0)
    for t in steps:
        h = act(gxs[t] + torch.matmul(h, wh.t()) + b)
        ys[t] = h
    return (h,), torch.stack(ys)


@register_op("RNN", num_outputs=-1)
def rnn(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False, training=None,
        generator=None, **kw):
    """Fused multi-layer RNN (reference: src/operator/rnn-inl.h): data
    (T, N, C), ``parameters`` the flat cuDNN-layout vector, ``state`` /
    ``state_cell`` (L*dirs, N, H). Layers and directions run in turn;
    ``p`` drops out between stacked layers in training (the mask from
    ``generator``). Weights and states are taken in data's dtype. Returns
    the (T, N, dirs*H) output, and with ``state_outputs`` the final
    states (h, and c for lstm). The state clips are accepted and not
    applied, as in the JAX package."""
    _, _, c_in = data.shape
    h_size = int(state_size)
    num_layers = int(num_layers)
    dirs = 2 if bidirectional else 1
    dt = data.dtype
    layers = rnn_unpack_params(parameters, mode, num_layers, c_in, h_size,
                               bidirectional)
    drop = p and p > 0.0 and (training is None or training) \
        and data.device.type != "meta"
    xs = data
    h_out, c_out = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            li = layer * dirs + d
            wx, wh, bx, bh = (w.to(dt) for w in layers[li])
            c0 = state_cell[li].to(dt) if mode == "lstm" else None
            carry, ys = _run_layer(xs, mode, wx, wh, bx, bh,
                                   state[li].to(dt), c0, reverse=d == 1)
            outs.append(ys)
            if mode == "lstm":
                c_out.append(carry[0])
                h_out.append(carry[1])
            else:
                h_out.append(carry[0])
        xs = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if drop and layer < num_layers - 1:
            xs = xs * _keep_mask(tuple(xs.shape), 1.0 - p, dt, xs.device,
                                 generator)
    if state_outputs:
        if mode == "lstm":
            return xs, torch.stack(h_out), torch.stack(c_out)
        return xs, torch.stack(h_out)
    return xs


# ---------------------------------------------------------------------------
# the legacy output and spatial ops (the JAX package's ops/nn.py:264-693)
# ---------------------------------------------------------------------------
@register_op("SoftmaxActivation")
def softmax_activation(data, mode="instance", **kw):
    """Softmax over the channel axis (``channel``) or over each
    instance's flattened values."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


@register_op("softmax_cross_entropy")
def softmax_cross_entropy(data, label, **kw):
    """The summed cross-entropy of the rows of ``data`` against the class
    ``label``s."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.sum(torch.gather(logp, -1,
                                   label.to(torch.int64)[:, None]))


@register_op("UpSampling")
def upsampling(*args, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=None, **kw):
    """``nearest``: each pixel repeated ``scale`` times along H and W
    (with several inputs and ``concat``, each upsampled and joined on
    the channels). ``bilinear``: the depthwise deconvolution of the data
    by the weight input (kernel 2s - s % 2, stride s, pad s // 2, as the
    JAX package's)."""
    scale = int(scale)
    data = args[0]

    def near(a):
        return a.repeat_interleave(scale, dim=2) \
            .repeat_interleave(scale, dim=3)

    if sample_type == "nearest":
        if int(num_args) > 1 and multi_input_mode == "concat":
            return torch.cat([near(a) for a in args], dim=1)
        return near(data)
    c = data.shape[1]
    return deconvolution(data, args[1], None, kernel=(2 * scale - scale % 2,)
                         * 2, stride=(scale,) * 2, pad=(scale // 2,) * 2,
                         num_filter=c, num_group=c, no_bias=True)


@register_op("ROIPooling")
def roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0, **kw):
    """Max over each ROI's (ph, pw) bins (reference: roi_pooling.cc).
    ROI corners scale by ``spatial_scale`` and round half to even
    (``jnp.round``, unlike the ``round`` op); an empty bin gives 0. The
    max runs over W, then H, each over masked rows (no gather out of
    range; the batch index clamps, as JAX's gather)."""
    ph, pw = _tup(pooled_size, 2)
    n, _, h, w = data.shape
    corner = torch.round(rois[:, 1:5] * spatial_scale).to(torch.int64)
    x1, y1, x2, y2 = corner.unbind(1)
    rh = torch.clamp_min(y2 - y1 + 1, 1)
    rw = torch.clamp_min(x2 - x1 + 1, 1)
    bidx = rois[:, 0].to(torch.int64).clamp(0, n - 1)
    img = torch.index_select(data, 0, bidx)                  # (R, C, H, W)

    def bins(start, size, p, extent):
        i = torch.arange(p, device=data.device)
        lo = start[:, None] + (i[None, :] * size[:, None]) // p
        hi = start[:, None] + ((i[None, :] + 1) * size[:, None] + p - 1) // p
        pos = torch.arange(extent, device=data.device)
        return (pos >= lo[..., None]) & (pos < hi[..., None])  # (R, p, E)

    neg = torch.full((), float("-inf"), dtype=data.dtype, device=data.device)
    wmask = bins(x1, rw, pw, w)[:, None, None]               # R,1,1,pw,W
    rowmax = torch.where(wmask, img[:, :, :, None, :], neg).amax(-1)
    hmask = bins(y1, rh, ph, h)[:, None, :, :, None]         # R,1,ph,H,1
    out = torch.where(hmask, rowmax[:, :, None], neg).amax(-2)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


@register_op("GridGenerator", no_grad=True)
def grid_generator(data, transform_type="affine", target_shape=(0, 0), **kw):
    """The (N, 2, H, W) sampling grid in [-1, 1]: ``affine`` maps the
    target's (x, y, 1) through each (2, 3) ``data``; ``warp`` adds the
    flow ``data`` to the identity grid."""
    from .creation import linspace
    h, w = (int(t) for t in target_shape)
    ys = linspace(start=-1.0, stop=1.0, num=h, device=data.device)
    xs = linspace(start=-1.0, stop=1.0, num=w, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    if transform_type == "affine":
        base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones_like(gx).reshape(-1)])
        out = torch.einsum("nij,jk->nik", data.reshape(-1, 2, 3),
                           base.to(data.dtype))
        return out.reshape(-1, 2, h, w)
    return data + torch.stack([gx, gy])[None].to(data.dtype)


@register_op("BilinearSampler")
def bilinear_sampler(data, grid, **kw):
    """Bilinear samples of ``data`` at ``grid`` ((N, 2, H', W') in
    [-1, 1], corners aligned), a corner outside the image counting 0
    (reference: bilinear_sampler.cc). The corners are gathered at
    clamped positions and masked, as the JAX package's."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2
    gy = (grid[:, 1] + 1) * (h - 1) / 2
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    flat = data.reshape(n, c, h * w)

    def sample(xi, yi):
        xc = xi.to(torch.int64).clamp(0, w - 1)
        yc = yi.to(torch.int64).clamp(0, h - 1)
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        lin = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
        vals = torch.gather(flat, 2, lin).reshape((n, c) + tuple(xi.shape[1:]))
        return vals * valid[:, None].to(data.dtype)

    return (sample(x0, y0) * (wy0 * wx0)[:, None]
            + sample(x0 + 1, y0) * (wy0 * wx1)[:, None]
            + sample(x0, y0 + 1) * (wy1 * wx0)[:, None]
            + sample(x0 + 1, y0 + 1) * (wy1 * wx1)[:, None])


@register_op("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False, **kw):
    """The sampler over the grid of ``loc`` (gradients reach ``loc``
    through the grid, though ``GridGenerator`` as an op records none)."""
    return bilinear_sampler(data, grid_generator(loc, transform_type,
                                                 target_shape))


# the v0.x operator names: the same ops (reference: batch_norm_v1.cc,
# convolution_v1.cc, pooling_v1.cc)
from .registry import alias as _alias  # noqa: E402
_alias("BatchNorm", "BatchNorm_v1")
_alias("Convolution", "Convolution_v1")
_alias("Pooling", "Pooling_v1")
