"""The BatchNorm backward's two full-tensor passes, in Triton.

They are the kernels under the analytic fused BN backwards of
``mxnet_tpu/ops/pallas_fused.py`` (``_fused_bn_conv_vjp.f_bwd`` :498,
``_fused_bn_convk_vjp.f_bwd`` :604 and ``_fused_matmul``'s ``f_bwd``
:299), which the JAX package leaves to XLA as jnp:

- B1 ``launch_reduce``: per channel c, ``s0 = sum dz`` and
  ``s1 = sum dz*x`` in fp32, where ``dz = dxhat * [xhat > 0]`` (or
  ``dxhat`` without ReLU). It reads ``dxhat``, ``x`` and the mask source
  ``xhat`` once. Tensors are viewed as (B, C, S) with explicit strides,
  so one kernel serves NCHW (reduce over B and S) and a row-major (M, K)
  matrix (B = M, C = K, S = 1). Two stages: each program of the first
  writes the partial sums of its share of the rows, and a second kernel
  adds the partials in a fixed order. No float atomics, so a step's
  gradients are the same from run to run.
- B2 ``launch_dx``: ``dx = dz*scale[c] + x*cx[c] + c0[c]``, one pass
  that reads ``dxhat``, ``x`` (and the mask source) once and writes
  ``dx`` once in x's dtype. Without ``cx``/``c0`` (the moving-statistics
  backward, and ``bn_relu_matmul``'s ``dx = dz*scale``) x is not read.

Both are bound by their bytes on an H100: a few flops per element read.
All arithmetic is fp32.

``triton`` is imported on the first launch, never when this module is
imported, so the CPU tests can import it.
"""
from __future__ import annotations

__all__ = ["launch_reduce", "launch_dx"]

DX_BLOCK = 2048
SUM_BLOCK = 256
# programs of the first reduction stage: about four per SM of an H100
# (132 SMs), so every SM has work and the partials stay small
TARGET_PROGRAMS = 528
_KERNELS = {}


def _kernels():
    if not _KERNELS:
        import triton
        import triton.language as tl

        @triton.jit
        def _bn_bwd_reduce(dy_ptr, x_ptr, m_ptr, part_ptr, C, S, sb, sc, ss,
                    n_s_tiles, n_tiles, P, HAS_MASK: tl.constexpr,
                    BLOCK_C: tl.constexpr, BLOCK_S: tl.constexpr):
            pc = tl.program_id(0)
            pp = tl.program_id(1)
            cs = pc * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cs < C
            acc0 = tl.zeros([BLOCK_C, BLOCK_S], dtype=tl.float32)
            acc1 = tl.zeros([BLOCK_C, BLOCK_S], dtype=tl.float32)
            for t in range(pp, n_tiles, P):
                b = t // n_s_tiles
                s = (t - b * n_s_tiles) * BLOCK_S + tl.arange(0, BLOCK_S)
                offs = b * sb + cs[:, None] * sc + s[None, :] * ss
                msk = cmask[:, None] & (s < S)[None, :]
                dy = tl.load(dy_ptr + offs, mask=msk, other=0.0) \
                    .to(tl.float32)
                x = tl.load(x_ptr + offs, mask=msk, other=0.0) \
                    .to(tl.float32)
                if HAS_MASK:
                    xh = tl.load(m_ptr + offs, mask=msk, other=0.0)
                    dy = tl.where(xh > 0, dy, 0.0)
                acc0 += dy
                acc1 += dy * x
            tl.store(part_ptr + pp * 2 * C + cs, tl.sum(acc0, axis=1),
                     mask=cmask)
            tl.store(part_ptr + pp * 2 * C + C + cs, tl.sum(acc1, axis=1),
                     mask=cmask)

        @triton.jit
        def _bn_bwd_sum_parts(part_ptr, out_ptr, P, n, BLOCK: tl.constexpr):
            offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            acc = tl.zeros([BLOCK], dtype=tl.float32)
            for p in range(0, P):
                acc += tl.load(part_ptr + p * n + offs, mask=mask,
                               other=0.0)
            tl.store(out_ptr + offs, acc, mask=mask)

        @triton.jit
        def _bn_bwd_dx(dy_ptr, x_ptr, m_ptr, scale_ptr, cx_ptr, c0_ptr, out_ptr,
                n, C, S, HAS_MASK: tl.constexpr, AFFINE: tl.constexpr,
                BLOCK: tl.constexpr):
            offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            c = (offs // S) % C
            dz = tl.load(dy_ptr + offs, mask=mask, other=0.0) \
                .to(tl.float32)
            if HAS_MASK:
                xh = tl.load(m_ptr + offs, mask=mask, other=0.0)
                dz = tl.where(xh > 0, dz, 0.0)
            dx = dz * tl.load(scale_ptr + c, mask=mask, other=0.0)
            if AFFINE:
                x = tl.load(x_ptr + offs, mask=mask, other=0.0) \
                    .to(tl.float32)
                dx += x * tl.load(cx_ptr + c, mask=mask, other=0.0) \
                    + tl.load(c0_ptr + c, mask=mask, other=0.0)
            tl.store(out_ptr + offs, dx.to(out_ptr.dtype.element_ty),
                     mask=mask)

        _KERNELS.update(reduce=_bn_bwd_reduce, sum_parts=_bn_bwd_sum_parts,
                        dx=_bn_bwd_dx)
    return _KERNELS


def _pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def reduce_plan(b, c, s, strides):
    """How B1 tiles a (B, C, S) view with ``strides`` = (sb, sc, ss):
    (b, c, s, strides, BLOCK_C, BLOCK_S) of the view the kernel walks.
    A view whose channels are the contiguous axis (a row-major matrix,
    S = 1) is walked as (1, C, B) so its tiles run along the rows; an
    NCHW view keeps its contiguous S axis as the tile's fast axis."""
    sb, sc, ss = strides
    if s == 1 and sc == 1:
        b, s, sb, ss = 1, b, 0, sb
    block_s = min(256, _pow2(s)) if ss == 1 else 16
    block_c = max(1, min(_pow2(c), 2048 // block_s))
    return b, c, s, (sb, sc, ss), block_c, block_s


def launch_reduce(dy, x, xhat, b, c, s, strides, out):
    """B1 over the (B, C, S) view with ``strides`` (elements) shared by
    ``dy``, ``x`` and ``xhat`` (None: no ReLU mask). Writes (2, C) fp32
    sums into ``out``: row 0 = sum dz, row 1 = sum dz*x. Runs on x's
    device and PyTorch's current stream; the caller has checked devices,
    dtypes, shapes and sizes."""
    import torch
    k = _kernels()
    b, c, s, (sb, sc, ss), block_c, block_s = reduce_plan(b, c, s, strides)
    n_s_tiles = (s + block_s - 1) // block_s
    n_tiles = b * n_s_tiles
    c_blocks = (c + block_c - 1) // block_c
    p = max(1, min(n_tiles, -(-TARGET_PROGRAMS // c_blocks)))
    part = torch.empty((p, 2 * c), dtype=torch.float32, device=x.device)
    k["reduce"][(c_blocks, p)](
        dy, x, xhat if xhat is not None else x, part, c, s, sb, sc, ss,
        n_s_tiles, n_tiles, p, HAS_MASK=xhat is not None, BLOCK_C=block_c,
        BLOCK_S=block_s, num_warps=4)
    k["sum_parts"][((2 * c + SUM_BLOCK - 1) // SUM_BLOCK,)](
        part, out, p, 2 * c, BLOCK=SUM_BLOCK, num_warps=4)


def launch_dx(dy, x, xhat, scale, cx, c0, out, c, s):
    """B2 over contiguous tensors whose channel index is
    ``(offset // s) % c`` (NCHW with s = H*W, or (M, K) with s = 1).
    ``xhat`` None: no ReLU mask; ``cx``/``c0`` None: ``dx = dz*scale``.
    The coefficients are fp32 (C,) vectors."""
    k = _kernels()
    n = dy.numel()
    affine = cx is not None
    k["dx"][((n + DX_BLOCK - 1) // DX_BLOCK,)](
        dy, x, xhat if xhat is not None else dy, scale,
        cx if affine else scale, c0 if affine else scale, out, n, c, s,
        HAS_MASK=xhat is not None, AFFINE=affine, BLOCK=DX_BLOCK,
        num_warps=8)
