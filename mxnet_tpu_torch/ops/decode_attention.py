"""Decode / verify attention over the KV-cache: the wrapper of D1
(``kernels/csrc/decode_attention.cu``), its plan and its plain versions.

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

D1 splits each lane's rows into chunks of ``rows`` (R) and combines the
chunks' partial softmaxes in chunk order; ``_d1_plan`` decides R, the
grid, the workspace and the shared memory before the launch, and
``decode_attention_split_plain`` is that chunk-and-combine order in
plain PyTorch (``d1_chunk_partials``, ``d1_combine``). The first D1, a
Triton kernel with one program per (lane, head)
(``kernels/decode_attention_triton.py``), is reached by no path of the
package; ``chip_smoke.py`` times it beside D1.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import fused_bn_conv as _fb

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_split_plain", "d1_chunk_partials",
           "d1_combine", "kv_dequant", "D1Plan", "D1_ROWS"]

_NEG = -1e30
# D1's constants (kernels/csrc/decode_attention.cu): rows a chunk (the
# kernel's templates; 64 from a sweep on an H100, PERF.md), threads a
# block, the shared memory a block may take (an H100's 227 KB less 1 KB),
# the alignment slack in front of it and the most the combine's loaded
# partials may add
D1_ROWS = 64
_D1_ROWS_BUILT = (32, 64, 128)
_D1_THREADS = 128
_D1_SMEM_MAX = 231424
_D1_SLACK = 128
_D1_SLAB_MAX = 49152


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


class D1Plan(NamedTuple):
    """How a D1 call runs, from shapes alone."""
    rows: int          # R, cache rows a chunk (and a block)
    grid: tuple        # (chunks, H, N) blocks
    workspace: tuple   # (N, H, W, chunks, D + 4): each chunk's acc, m, l
    smem_bytes: int    # dynamic shared memory a block


def _up(x, a):
    return -(-x // a) * a


@functools.lru_cache(maxsize=256)
def _d1_plan(n, w, m, h, d, int8, rows=D1_ROWS):
    """D1's plan for q (n, w, h, d) over a cache (n, m, h, d), f32 or
    int8; raises on what the kernel cannot take. Shared memory (the
    kernel's ``layout``): a head of every chunk's (m, l) per token, w
    denominators, the combine's w x d running sums and two mbarriers, to
    a 128-byte boundary; then the compute region (the K and V tiles of R
    rows, 128-byte aligned, w x R scores, each of the 4 warps' R weights,
    2R scales for int8, the row groups' partials (groups x d), the w q
    rows), at least as large as the chunks' partials up to 48 KB. R is
    one of the kernel's templates (32, 64, 128)."""
    if d & (d - 1) or not 16 <= d <= 256:
        raise MXNetError(f"D1: head_dim {d} is not a power of two from 16 "
                         "to 256")
    if not 1 <= w <= 16:
        raise MXNetError(f"D1: width {w} is not from 1 to 16")
    if rows not in _D1_ROWS_BUILT:
        raise MXNetError(f"D1: {rows} rows a chunk (built: "
                         f"{_D1_ROWS_BUILT})")
    if min(n, m, h) < 1 or n > 65535 or h > 65535:
        raise MXNetError(f"D1: {n} lanes, {m} rows, {h} heads are out of "
                         "the kernel's grid")
    if n * m * h * d >= 2 ** 31:
        raise MXNetError(f"D1: {n * m * h * d} cache elements exceed the "
                         "kernel's 32-bit offsets")
    chunks = -(-m // rows)
    workspace = (n, h, w, chunks, d + 4)
    if n * h * w * chunks * (d + 4) >= 2 ** 31:
        raise MXNetError(f"D1: workspace {workspace} exceeds the kernel's "
                         "32-bit offsets")
    groups = _D1_THREADS // min(d // 4, 16)
    head = _up(_up(2 * w * chunks * 4, 16) + _up(w * 4, 16) + w * d * 4
               + 16, 128)
    compute = (2 * _up(rows * d * (1 if int8 else 4), 128)
               + _up(w * rows * 4, 16) + _D1_THREADS // 32 * rows * 4
               + (_up(2 * rows * 4, 16) if int8 else 0) + groups * d * 4
               + w * d * 4)
    slab = w * chunks * (d + 4) * 4
    smem = _D1_SLACK + head + max(compute, min(slab, _D1_SLAB_MAX))
    if smem > _D1_SMEM_MAX:
        raise MXNetError(f"D1: {smem} bytes of shared memory a block (R "
                         f"{rows}, head_dim {d}, width {w}, {chunks} "
                         f"chunks) exceed {_D1_SMEM_MAX}")
    return D1Plan(rows, (chunks, h, n), workspace, smem)


def d1_chunk_partials(q, k, v, positions, k_scale=None, v_scale=None,
                      rows=D1_ROWS):
    """Each chunk's partial softmax as D1 forms it: chunks of ``rows``
    rows ``[c*R, (c+1)*R)``; in a chunk, the scores of the rows below
    ``hi = min(positions + W, M)`` (``-1e30`` where token j does not see
    the row), their max ``m``, ``p = exp(s - m)``, ``l = sum p`` and
    ``acc = p . V``. A chunk wholly at or past ``hi`` has no rows: m =
    ``-1e30``, l = 0, acc = 0. Returns (m, l) (N, W, H, C) and acc
    (N, W, H, C, D)."""
    n, w, h, d = q.shape
    m = k.shape[1]
    if k_scale is not None:
        k = kv_dequant(k, k_scale, q.dtype)
        v = kv_dequant(v, v_scale, q.dtype)
    chunks = -(-m // rows)
    pad = chunks * rows - m
    if pad:
        z = k.new_zeros((n, pad, h, d))
        k, v = torch.cat([k, z], 1), torch.cat([v, z], 1)
    kc = k.reshape(n, chunks, rows, h, d)
    vc = v.reshape(n, chunks, rows, h, d)
    row = torch.arange(chunks * rows, device=q.device).reshape(chunks, rows)
    pos = positions.long()
    last = pos[:, None] + torch.arange(w, device=q.device)
    hi = torch.clamp(pos + w, max=m)
    inrange = (row < hi[:, None, None])[:, None, None]   # (N,1,1,C,R)
    visible = (row <= last[..., None, None])[:, :, None]  # (N,W,1,C,R)
    s = torch.einsum("nkhd,ncrhd->nkhcr", q, kc) * (1.0 / (d ** 0.5))
    s = torch.where(visible & inrange, s, _NEG)
    mx = torch.amax(s, dim=-1)
    p = torch.where(inrange, torch.exp(s - mx[..., None]), 0.0)
    return mx, p.sum(-1), torch.einsum("nkhcr,ncrhd->nkhcd", p, vc)


def d1_combine(mx, l, acc):
    """D1's combine of the chunks' partials, in chunk order: ``M = max_c
    m_c``, weights ``exp(m_c - M)`` (an exact 0.0 for a chunk at -1e30),
    ``o = sum_c w_c acc_c / sum_c w_c l_c``. Returns (o (N, W, H, D),
    the weights (N, W, H, C))."""
    wgt = torch.exp(mx - torch.amax(mx, dim=-1, keepdim=True))
    return (wgt[..., None] * acc).sum(-2) / (wgt * l).sum(-1)[..., None], \
        wgt


def decode_attention_split_plain(q, k, v, positions, k_scale=None,
                                 v_scale=None, rows=D1_ROWS):
    """``decode_attention_plain``'s function computed in D1's order:
    per-chunk partials of ``rows`` rows (``d1_chunk_partials``), combined
    in chunk order (``d1_combine``). Positions are >= 0, as the decode
    engine gives them."""
    return d1_combine(*d1_chunk_partials(q, k, v, positions, k_scale,
                                         v_scale, rows))[0]


def decode_attention(q, k, v, positions, k_scale=None, v_scale=None):
    """Attention of ``W`` fed tokens per lane over the lanes' cache rows
    (see ``decode_attention_plain``). On CUDA: D1, with q f32, the cache
    f32 or int8 with f32 scales, positions int32 and >= 0, all
    contiguous, q and the cache 16-byte aligned, lanes == cache slots,
    head_dim a power of two from 16 to 256, W <= 16, a plan
    ``_d1_plan`` takes; on CPU: the plain version."""
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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise MXNetError("decode_attention: q and the cache must be "
                         "16-byte aligned on CUDA")
    if not q.numel():
        return torch.empty_like(q)
    n, w, h, _ = q.shape
    out = _d1_run(q, k, v, positions, k_scale, v_scale,
                  _d1_plan(n, w, k.shape[1], h, d, int8))
    _fb._count("decode_attention", q.device)
    return out


def _d1_run(q, k, v, positions, k_scale, v_scale, plan, defines=()):
    """Launches D1 with ``plan`` on checked CUDA tensors and returns the
    output (counts nothing: ``decode_attention`` counts its launches);
    ``defines`` pick a build variant (``profile_decode_attention``'s
    ``D1_TRACE``). Allocates the workspace and the per-(lane, head)
    counters, which the C entry zeroes on the stream before the launch."""
    n, w, h, d = q.shape
    int8 = k_scale is not None
    out = torch.empty_like(q)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
    cnt = torch.empty(n * h, dtype=torch.int32, device=q.device)
    scales = (k_scale, v_scale) if int8 else (k, v)
    with _fb._on_device(q.device):
        fn = _fb._c_entry("decode_attention", "mxtt_decode_attention",
                          [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                          + [ctypes.c_float, ctypes.c_void_p], defines)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                scales[0].data_ptr(), scales[1].data_ptr(),
                positions.data_ptr(), out.data_ptr(), ws.data_ptr(),
                cnt.data_ptr(), n, w, k.shape[1], h, d, int(int8),
                plan.rows, plan.grid[0], plan.smem_bytes, 1.0 / (d ** 0.5),
                _fb._stream_handle(q.device))
    _fb._launch_rc("decode_attention", rc)
    return out


_fb.register_wrapper(decode_attention)
