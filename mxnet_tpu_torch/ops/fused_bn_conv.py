"""Fused BatchNorm-apply(+ReLU) + convolution: the kernel wrappers and
the two graph ops the rewrite passes substitute (counterpart of
``mxnet_tpu/ops/pallas_fused.py``).

- ``bn_relu_conv_nchw`` — K1, the fused BN-apply+ReLU+1x1 conv. On a
  CUDA tensor it launches ``kernels/csrc/bn_relu_conv1x1.cu``; on a CPU
  tensor it runs ``bn_relu_conv_nchw_plain``.
- ``bn_act_prologue`` — K2, the BN-apply(+ReLU) prologue. On a CUDA
  tensor it launches ``kernels/bn_prologue_triton.py``; on a CPU tensor
  it runs ``bn_act_prologue_plain``.

A wrapper given a CUDA tensor launches its kernel or raises; it never
falls back to its plain version. Meta tensors (shape inference) take
the plain version, which computes nothing on them. Each wrapper counts
its launches in ``<wrapper>.launches``.

``select_conv_tiles`` / ``conv_tile_failure`` are kept as the rewrite
pass's applicability rule, so the pass rewrites the same sites as the
JAX package; the CUDA kernel has its own tiling and any shape.

Dtype flow follows the JAX ops: params arrive in the compute dtype,
``scale``/``shift`` are computed in it, the normalised activation is
rounded to ``x.dtype`` before the product, sums are fp32 and the output
is ``x.dtype``. This slice is inference only: a tensor that requires a
gradient raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import _tup
from .registry import register_op

__all__ = ["bn_relu_conv_nchw", "bn_relu_conv_nchw_plain",
           "bn_act_prologue", "bn_act_prologue_plain",
           "select_conv_tiles", "conv_tile_failure", "reset_launch_counts",
           "launch_counts"]

# output-tile candidates of the TPU kernel, largest first (the pass's
# applicability rule; see select_conv_tiles)
_BM_CANDIDATES = (1024, 512, 256, 128, 64, 32, 16, 8)
_BN_CANDIDATES = (512, 256, 128, 64, 32, 16, 8)


def select_conv_tiles(n_out, spatial):
    """(bo, bs) output tiles of the TPU kernel for a fused 1x1 conv, or
    None — the rewrite pass's bail-out rule, unchanged from the JAX
    package: output channels must divide by a multiple-of-8 candidate;
    the spatial dim may instead be taken whole when it is at most 1024."""
    bo = next((c for c in _BN_CANDIDATES if n_out % c == 0), None)
    bs = next((c for c in _BM_CANDIDATES if spatial % c == 0), None)
    if bs is None and spatial <= 1024:
        bs = int(spatial)
    if bo is None or bs is None:
        return None
    return bo, bs


def conv_tile_failure(n_out, spatial):
    """Which dimension made ``select_conv_tiles`` return None (the
    bail-out reason the fusion report records)."""
    why = []
    if next((c for c in _BN_CANDIDATES if n_out % c == 0), None) is None:
        why.append(f"num_filter={n_out} not divisible by 8")
    if next((c for c in _BM_CANDIDATES if spatial % c == 0), None) \
            is None and spatial > 1024:
        why.append(f"spatial={spatial} not divisible by 8 and too "
                   "large (> 1024) for a whole-row block")
    return "; ".join(why) or "no tile split fits"


# ---------------------------------------------------------------------------
# checks shared by the wrappers
# ---------------------------------------------------------------------------
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _no_grad(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("training comes in the next slice")


def _check_cuda(op, x, others, dtypes):
    if x.dtype not in dtypes:
        raise MXNetError(f"{op}: dtype {x.dtype} is not supported on CUDA "
                         f"(supported: {sorted(map(str, dtypes))})")
    for t in (x,) + others:
        if t.device != x.device:
            raise MXNetError(f"{op}: tensors on {t.device} and {x.device}")
        if t.dtype != x.dtype:
            raise MXNetError(f"{op}: mixed dtypes {t.dtype} and {x.dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"{op}: inputs must be contiguous")


def _on_device(device):
    """Make ``device`` the current CUDA device for a launch (a no-op in
    the usual case where it already is)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _plain_device(x):
    """True for tensors that take the plain version (CPU, meta); False
    for CUDA; raises for any other device."""
    if x.device.type in ("cpu", "meta"):
        return True
    if x.device.type != "cuda":
        raise MXNetError(f"unsupported device {x.device}")
    return False


# ---------------------------------------------------------------------------
# K1: fused BN-apply(+ReLU) + 1x1 conv
# ---------------------------------------------------------------------------
def bn_relu_conv_nchw_plain(x, w, scale, shift, relu=True):
    """Plain PyTorch version of K1 with the kernel's arithmetic:
    ``z = act(x*scale + shift)`` in fp32, rounded to ``x.dtype``, then
    ``w @ z`` over channels in fp32, rounded to ``x.dtype``."""
    b, c, h, wd = x.shape
    o = w.shape[0]
    z = bn_act_prologue_plain(x, scale, shift, relu).float()
    out = torch.matmul(w.float(), z.reshape(b, c, h * wd))
    return out.to(x.dtype).reshape(b, o, h, wd)


def _k1_entry():
    """The C entry point of K1, its library built and loaded on first
    use (``kernels/build.py`` caches the loaded library)."""
    from ..kernels import build
    fn = build.load("bn_relu_conv1x1").mxtt_bn_relu_conv1x1
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def bn_relu_conv_nchw(x, w, scale, shift, relu=True):
    """``act(x*scale + shift)`` contracted with ``w`` over channels —
    the fused BN-apply(+ReLU)+1x1-conv forward. x (B, C, H, W), w (O, C),
    scale/shift (C,) -> (B, O, H, W) in ``x.dtype``. On CUDA: the
    hand-written kernel (float32 or bfloat16, every tensor in x's dtype,
    contiguous); on CPU: the plain version."""
    _no_grad(x, w, scale, shift)
    if x.dim() != 4 or w.dim() != 2 or w.shape[1] != x.shape[1] \
            or scale.shape != (x.shape[1],) or shift.shape != scale.shape:
        raise MXNetError(
            f"bn_relu_conv_nchw: shapes x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, scale {tuple(scale.shape)}, shift "
            f"{tuple(shift.shape)} do not fit (B,C,H,W), (O,C), (C,), (C,)")
    if _plain_device(x):
        return bn_relu_conv_nchw_plain(x, w, scale, shift, relu)
    _check_cuda("bn_relu_conv_nchw", x, (w, scale, shift), _KERNEL_DTYPES)
    b, c, h, wd = x.shape
    o = w.shape[0]
    if b > 65535 or max(c, o, h * wd) >= 2 ** 31:
        raise MXNetError(f"bn_relu_conv_nchw: shape {tuple(x.shape)} -> "
                         f"{o} channels is out of the kernel's range")
    out = torch.empty((b, o, h, wd), dtype=x.dtype, device=x.device)
    with _on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _k1_entry()(_KERNEL_DTYPES[x.dtype], x.data_ptr(),
                         w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                         out.data_ptr(), b, c, o, h * wd, int(bool(relu)),
                         stream)
    if rc != 0:
        raise MXNetError(f"bn_relu_conv1x1 kernel launch failed: CUDA "
                         f"error {rc}")
    bn_relu_conv_nchw.launches += 1
    return out


bn_relu_conv_nchw.launches = 0


# ---------------------------------------------------------------------------
# K2: BN-apply(+ReLU) prologue
# ---------------------------------------------------------------------------
def bn_act_prologue_plain(x, scale, shift, relu=True):
    """Plain PyTorch version of K2: ``act(x*scale[c] + shift[c])`` in
    fp32, rounded to ``x.dtype``."""
    c = x.shape[1]
    z = x.float() * scale.float().reshape(1, c, 1, 1) \
        + shift.float().reshape(1, c, 1, 1)
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z.to(x.dtype)


def bn_act_prologue(x, scale, shift, relu=True):
    """The normalised activation ``act(x*scale[c] + shift[c])`` of an
    NCHW tensor, in ``x.dtype``. On CUDA: the Triton kernel (float32 or
    bfloat16, every tensor in x's dtype, contiguous); on CPU:
    the plain version."""
    _no_grad(x, scale, shift)
    if x.dim() != 4 or scale.shape != (x.shape[1],) \
            or shift.shape != scale.shape:
        raise MXNetError(
            f"bn_act_prologue: shapes x {tuple(x.shape)}, scale "
            f"{tuple(scale.shape)}, shift {tuple(shift.shape)} do not fit "
            "(B,C,H,W), (C,), (C,)")
    if _plain_device(x):
        return bn_act_prologue_plain(x, scale, shift, relu)
    _check_cuda("bn_act_prologue", x, (scale, shift), _KERNEL_DTYPES)
    if x.numel() >= 2 ** 31:
        raise MXNetError(f"bn_act_prologue: {x.numel()} elements exceed "
                         "the kernel's 32-bit offsets")
    from ..kernels import bn_prologue_triton
    out = torch.empty_like(x)
    if x.numel():
        with _on_device(x.device):
            bn_prologue_triton.launch(x, scale, shift, out, relu)
        bn_act_prologue.launches += 1
    return out


bn_act_prologue.launches = 0

_WRAPPERS = (bn_relu_conv_nchw, bn_act_prologue)


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for f in _WRAPPERS:
        f.launches = 0


def launch_counts():
    """{wrapper name: launches since the last reset}."""
    return {f.__name__: f.launches for f in _WRAPPERS}


# ---------------------------------------------------------------------------
# the graph ops
# ---------------------------------------------------------------------------
def _fold(gamma, beta, mean, var, eps, fix_gamma, training,
          use_global_stats):
    """(scale, shift) from the moving statistics, in the params' dtype,
    as the JAX ops' ``fold`` (batch statistics belong to the training
    slice)."""
    if training and not use_global_stats:
        raise NotImplementedError("training comes in the next slice")
    g = torch.ones_like(gamma) if fix_gamma else gamma
    scale = g * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


@register_op("_FusedBNReLUConvK", num_outputs=3)
def fused_bn_relu_conv_general(data, gamma, beta, moving_mean, moving_var,
                               weight, bias=None, eps=1e-3, momentum=0.9,
                               fix_gamma=True, use_global_stats=False,
                               act_type="relu", axis=1, kernel=None,
                               stride=None, pad=None, dilate=None,
                               num_filter=None, num_group=1, no_bias=True,
                               training=False, **kw):
    """BatchNorm -> [Activation(relu) ->] Convolution of any geometry as
    one op (substituted by the residual_fusion pass): the K2 prologue,
    then ``F.conv2d`` with the node's stride, pad, dilate and groups.
    Returns (out, mean, var) like BatchNorm."""
    scale, shift = _fold(gamma, beta, moving_mean, moving_var, float(eps),
                         fix_gamma, training, use_global_stats)
    xhat = bn_act_prologue(data, scale.to(data.dtype), shift.to(data.dtype),
                           relu=act_type == "relu")
    out = F.conv2d(xhat, weight.to(data.dtype), None,
                   stride=_tup(stride, 2) or (1, 1),
                   padding=_tup(pad, 2) or (0, 0),
                   dilation=_tup(dilate, 2) or (1, 1),
                   groups=int(num_group or 1))
    if not no_bias and bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out.to(data.dtype), moving_mean, moving_var


@register_op("_FusedBNReLUConv", num_outputs=3)
def fused_bn_relu_conv(data, gamma, beta, moving_mean, moving_var, weight,
                       bias=None, eps=1e-3, momentum=0.9, fix_gamma=True,
                       use_global_stats=False, act_type="relu", axis=1,
                       num_filter=None, no_bias=True, training=False, **kw):
    """BatchNorm -> Activation(relu) -> Convolution(1x1/s1/p0) as one op
    (substituted by the pallas_fusion pass), carried by K1. Returns
    (conv_out, mean, var) like BatchNorm."""
    o, c = weight.shape[0], data.shape[1]
    scale, shift = _fold(gamma, beta, moving_mean, moving_var, float(eps),
                         fix_gamma, training, use_global_stats)
    out = bn_relu_conv_nchw(data, weight.reshape(o, c).to(data.dtype),
                            scale.to(data.dtype), shift.to(data.dtype),
                            relu=act_type == "relu")
    if not no_bias and bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out.to(data.dtype), moving_mean, moving_var
