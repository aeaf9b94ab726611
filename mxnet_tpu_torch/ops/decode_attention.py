"""Decode / verify attention over the KV-cache: the wrapper of D1
(``kernels/decode_attention_triton.py``) and its plain version.

The JAX package computes this attention in jnp inside its decode and
verify programs (``mxnet_tpu/serving/decode/model.py`` :375-381 and
:448-455) and XLA fuses the int8 cache's convert-and-scale into the
einsum's read of the cache. Plain PyTorch cannot: the dequantization
would write an f32 copy of every layer's cache each step and read it
back, so the int8 cache would move more bytes than the f32 one. D1
reads the cache once and dequantizes on load, for either cache dtype.

``decode_attention`` launches D1 on CUDA tensors (or raises on what it
does not take) and runs ``decode_attention_plain``, the reference's
einsum math, on CPU tensors only. It counts its launches in
``decode_attention.launches`` through ``fused_bn_conv._count``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import fused_bn_conv as _fb

__all__ = ["decode_attention", "decode_attention_plain", "kv_dequant"]

_NEG = -1e30


def _check_shapes(q, k, v, positions, k_scale, v_scale):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise MXNetError(
            f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} do not fit (N, W, H, D), (N, M, H, D)")
    if positions.shape != (q.shape[0],):
        raise MXNetError(f"decode_attention: positions {tuple(positions.shape)}"
                         f" for {q.shape[0]} lanes")
    if (k_scale is None) != (v_scale is None):
        raise MXNetError("decode_attention: give both scales or neither")
    if k_scale is not None and (k_scale.shape != k.shape[:3]
                                or v_scale.shape != k.shape[:3]):
        raise MXNetError(f"decode_attention: scales {tuple(k_scale.shape)}, "
                         f"{tuple(v_scale.shape)} for cache "
                         f"{tuple(k.shape)}")


def kv_dequant(q, scale, dtype=torch.float32):
    """Values of an int8 cache buffer ``(..., H, D)`` with its per-row
    scales ``(..., H)``: ``q * scale`` in ``dtype`` (what D1 does on
    load)."""
    return q.to(dtype) * scale.to(dtype)[..., None]


def decode_attention_plain(q, k, v, positions, k_scale=None, v_scale=None):
    """The reference's math in PyTorch: ``q`` (N, W, H, D); the lanes'
    caches ``k``, ``v`` (N, M, H, D), dequantized as ``k * k_scale`` when
    int8 scales (N, M, H) are given; token ``j`` of lane ``n`` sees rows
    ``m <= positions[n] + j``. Computes in ``q``'s dtype."""
    n, w, _, d = q.shape
    m = k.shape[1]
    if k_scale is not None:
        k = kv_dequant(k, k_scale, q.dtype)
        v = kv_dequant(v, v_scale, q.dtype)
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("nkhd,nmhd->nkhm", q, k) * scale
    last = positions.long()[:, None] + torch.arange(w, device=q.device)
    visible = torch.arange(m, device=q.device) <= last[..., None]
    s = torch.where(visible[:, :, None, :], s, _NEG)
    mx = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    o = torch.einsum("nkhm,nmhd->nkhd", e, v)
    return o / torch.sum(e, dim=-1)[..., None]


def decode_attention(q, k, v, positions, k_scale=None, v_scale=None):
    """Attention of ``W`` fed tokens per lane over the lanes' cache rows
    (see ``decode_attention_plain``). On CUDA: D1, with q f32, the cache
    f32 or int8 with f32 scales, positions int32, all contiguous, lanes
    == cache slots, head_dim a power of two from 16 to 256, W <= 16; on
    CPU: the plain version."""
    _check_shapes(q, k, v, positions, k_scale, v_scale)
    if _fb._plain_device(q):
        return decode_attention_plain(q, k, v, positions, k_scale, v_scale)
    int8 = k_scale is not None
    want = torch.int8 if int8 else torch.float32
    if q.dtype != torch.float32 or k.dtype != want or v.dtype != want \
            or positions.dtype != torch.int32 or (int8 and (
                k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32)):
        raise MXNetError(
            f"decode_attention: dtypes q {q.dtype}, cache {k.dtype}/"
            f"{v.dtype}, positions {positions.dtype} are not supported on "
            "CUDA (q float32; cache float32, or int8 with float32 scales; "
            "positions int32)")
    ts = (q, k, v, positions) + ((k_scale, v_scale) if int8 else ())
    if any(t.device != q.device for t in ts):
        raise MXNetError("decode_attention: tensors on more than one device")
    if not all(t.is_contiguous() for t in ts):
        raise MXNetError("decode_attention: inputs must be contiguous")
    d = q.shape[3]
    if d & (d - 1) or not 16 <= d <= 256 or q.shape[1] > 16:
        raise MXNetError(f"decode_attention: head_dim {d} (a power of two "
                         f"from 16 to 256) or width {q.shape[1]} (<= 16) "
                         "not supported on CUDA")
    if k.numel() >= 2 ** 31:
        raise MXNetError(f"decode_attention: {k.numel()} cache elements "
                         "exceed the kernel's 32-bit offsets")
    from ..kernels import decode_attention_triton
    out = torch.empty_like(q)
    if q.numel():
        with _fb._on_device(q.device):
            decode_attention_triton.launch(q, k, v, k_scale, v_scale,
                                           positions, out)
        _fb._count("decode_attention", q.device)
    return out


_fb.register_wrapper(decode_attention)
