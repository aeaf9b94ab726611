"""The first form of D1, masked decode / verify attention over the
KV-cache, in Triton: one program per (lane, head). No path of the
package reaches it; D1 is the CUDA kernel of
``kernels/csrc/decode_attention.cu``, which splits each lane's rows over
the card, and ``chip_smoke.py`` times this form beside it on the same
inputs as its yardstick.

Replaces the jnp attention of ``mxnet_tpu/serving/decode/model.py``
(``decode_step`` :375-381, ``verify_step`` :448-455), which XLA fuses
with the int8 cache's convert-and-scale into one read of the cache. For
lane ``n``, head ``h`` and fed token ``j < W`` (W = 1 for decode, k+1
for verify)::

    o[n,j,h,:] = sum_m softmax_m(mask(q[n,j,h,:] . K[n,m,h,:] * scale))
                 * V[n,m,h,:]

where row ``m`` is visible when ``m <= positions[n] + j``; the others
take the reference's ``-1e30`` (not ``-inf``), whose weight underflows
to an exact 0.0.

Bound on an H100: bytes. At W <= 5 query rows a lane there is no tile a
tensor core could fill; each cache byte is used for W multiply-adds, so
the only aim is to read every cache byte once. The design:

- one program per (lane, head): a lane's rows are read by its own
  programs only and in a fixed block order over ``m``, so a lane's
  output never depends on the other lanes (continuous batching stays
  bit-identical to solo decode) and is the same from run to run;
- each program reads its lane's rows ``[0, min(positions[n] + W,
  max_seq))`` only: the masked rows beyond contribute an exact 0.0, so
  stopping there changes nothing but the summation order;
- one pass over the rows with the running max of the softmax (the
  online form of the reference's max-then-exp): each block of K and V
  rows is read once, scores are rescaled when the max grows, and the
  denominator is divided last;
- int8 rows are dequantized on load (``q * scale`` in f32), so no f32
  copy of the cache is ever written;
- two forms by width, picked from timings on an H100 (``PERF.md``):
  decode (W = 1) takes one query row as a vector, 128 rows a block,
  scores and the weighted sum as reductions; verify (W > 1) pads the
  W query rows to 16 and takes both products with ``tl.dot`` in full
  f32 (``input_precision="ieee"``), 64 rows a block. A lane's program
  is serial over its rows, so large blocks (few, long iterations) beat
  small ones: the lane with the most rows sets the launch's time.

``triton`` is imported on the first launch, never when this module is
imported, so the CPU tests can import it.
"""
from __future__ import annotations

__all__ = ["launch"]

_KERNELS = None


def _kernels():
    global _KERNELS, tl
    if _KERNELS is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _decode_attn_w1(q_ptr, k_ptr, v_ptr, ks_ptr, vs_ptr, pos_ptr,
                            o_ptr, M, H, scale, D: tl.constexpr,
                            BLOCK_M: tl.constexpr, INT8: tl.constexpr):
            n = tl.program_id(0)
            h = tl.program_id(1)
            hi = tl.minimum(tl.load(pos_ptr + n) + 1, M)
            d = tl.arange(0, D)
            q = tl.load(q_ptr + (n * H + h) * D + d)
            m_i = -1e30
            l_i = 0.0
            acc = tl.zeros([D], tl.float32)
            for start in range(0, hi, BLOCK_M):
                rows = start + tl.arange(0, BLOCK_M)
                rmask = rows < hi
                off = ((n * M + rows[:, None]) * H + h) * D + d[None, :]
                k = tl.load(k_ptr + off, mask=rmask[:, None], other=0)
                v = tl.load(v_ptr + off, mask=rmask[:, None], other=0)
                if INT8:
                    so = (n * M + rows) * H + h
                    k = k.to(tl.float32) \
                        * tl.load(ks_ptr + so, mask=rmask, other=0.0)[:, None]
                    v = v.to(tl.float32) \
                        * tl.load(vs_ptr + so, mask=rmask, other=0.0)[:, None]
                s = tl.sum(k * q[None, :], axis=1) * scale
                s = tl.where(rmask, s, -1e30)
                m_new = tl.maximum(m_i, tl.max(s, axis=0))
                alpha = tl.exp(m_i - m_new)
                p = tl.exp(s - m_new)
                l_i = l_i * alpha + tl.sum(p, axis=0)
                acc = acc * alpha + tl.sum(p[:, None] * v, axis=0)
                m_i = m_new
            tl.store(o_ptr + (n * H + h) * D + d, acc / l_i)

        @triton.jit
        def _decode_attn(q_ptr, k_ptr, v_ptr, ks_ptr, vs_ptr, pos_ptr,
                         o_ptr, M, H, scale, W: tl.constexpr,
                         WP: tl.constexpr, D: tl.constexpr,
                         BLOCK_M: tl.constexpr, INT8: tl.constexpr):
            n = tl.program_id(0)
            h = tl.program_id(1)
            pos = tl.load(pos_ptr + n)
            hi = tl.minimum(pos + W, M)
            jw = tl.arange(0, WP)
            d = tl.arange(0, D)
            jmask = jw < W
            q_off = ((n * W + jw[:, None]) * H + h) * D + d[None, :]
            q = tl.load(q_ptr + q_off, mask=jmask[:, None], other=0.0)
            last = pos + jw                       # last visible row of j
            m_i = tl.full([WP], -1e30, tl.float32)
            l_i = tl.zeros([WP], tl.float32)
            acc = tl.zeros([WP, D], tl.float32)
            for start in range(0, hi, BLOCK_M):
                rows = start + tl.arange(0, BLOCK_M)
                rmask = rows < hi
                off = ((n * M + rows[:, None]) * H + h) * D + d[None, :]
                k = tl.load(k_ptr + off, mask=rmask[:, None], other=0)
                v = tl.load(v_ptr + off, mask=rmask[:, None], other=0)
                if INT8:
                    so = (n * M + rows) * H + h
                    k = k.to(tl.float32) \
                        * tl.load(ks_ptr + so, mask=rmask, other=0.0)[:, None]
                    v = v.to(tl.float32) \
                        * tl.load(vs_ptr + so, mask=rmask, other=0.0)[:, None]
                s = tl.dot(q, tl.trans(k), input_precision="ieee") * scale
                vis = (rows[None, :] <= last[:, None]) & rmask[None, :]
                s = tl.where(vis, s, -1e30)
                m_new = tl.maximum(m_i, tl.max(s, axis=1))
                alpha = tl.exp(m_i - m_new)
                p = tl.exp(s - m_new[:, None])
                l_i = l_i * alpha + tl.sum(p, axis=1)
                acc = acc * alpha[:, None] \
                    + tl.dot(p, v, input_precision="ieee")
                m_i = m_new
            tl.store(o_ptr + q_off, acc / l_i[:, None], mask=jmask[:, None])

        _KERNELS = (_decode_attn_w1, _decode_attn)
    return _KERNELS


def launch(q, k, v, k_scale, v_scale, positions, out):
    """Launch on ``q``'s device and PyTorch's current stream. The caller
    has checked device, dtypes, shapes, contiguity and sizes: q and out
    (N, W, H, D) f32 with W <= 16; k, v (N, M, H, D) f32, or int8 with
    f32 scales (N, M, H); positions (N,) int32."""
    n, w, h, d = q.shape
    m = k.shape[1]
    int8 = k_scale is not None
    args = (q, k, v, k_scale if int8 else k, v_scale if int8 else v,
            positions, out, m, h, 1.0 / (d ** 0.5))
    one, many = _kernels()
    if w == 1:
        one[(n, h)](*args, D=d, BLOCK_M=128, INT8=int8,
                    num_warps=4 if int8 else 8, num_stages=3)
    else:
        many[(n, h)](*args, W=w, WP=16, D=d, BLOCK_M=64, INT8=int8,
                     num_warps=4, num_stages=3)
