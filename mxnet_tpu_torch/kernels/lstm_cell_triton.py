"""L1: the LSTM cell's pointwise pass, forward and backward, in Triton.

Replaces no ``pallas_call``: the JAX package computes the cell as jnp
inside ``lax.scan`` (``mxnet_tpu/ops/nn.py:486-496``,
``_lstm_cell_step``) and XLA fuses the body into one pass per step.
Eager PyTorch would launch about ten kernels for it (the three adds,
four activations, the products and the state update), each reading and
writing an (N, 4H) or (N, H) tensor; L1 is one launch each way.

Forward, for row r and column j < H of the (N, 4H) gate blocks in the
reference's order (i, f, g, o)::

    z = xg[r] + hg[r] + b          (input product, recurrent product,
                                    bx + bh)
    i, f, o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)
    c = f * c_prev + i * g;         h = o * tanh(c)

Backward recomputes the gates from the same inputs (nothing but the
forward's inputs is saved) and, from ``dh`` and ``dc``, writes

    dc_t = dc + dh * o * (1 - tanh(c)^2)
    dz = (dc_t*g*i*(1-i), dc_t*c_prev*f*(1-f), dc_t*i*(1-g^2),
          dh*tanh(c)*o*(1-o))      (N, 4H), the gradient of xg, hg and
                                    each row of b
    dc_prev = dc_t * f

Arithmetic in fp32 on fp32 or bf16 tensors, one rounding per output.

Bound on an H100: bytes. The forward reads 9 and writes 2 elements per
(r, j), the backward reads 11 and writes 5, for a few dozen flops, far
under the ridge; at the LSTM LM's (512, 650) in bf16 that is 7.3 and
10.6 MB, about 2-3 us at 3.35 TB/s, so a launch costs about as much as
the pass. The design keeps it one coalesced pass: a 1-D grid over the
N*H cells, neighbouring threads on neighbouring columns of each gate
block. The ``RNN`` op runs it for fp32 layers; bf16 layers run the cell
inside the recurrent product (``kernels/csrc/lstm_step.cu``).

``triton`` is imported on the first launch, never when this module is
imported, so the CPU tests can import it.
"""
from __future__ import annotations

__all__ = ["launch_fwd", "launch_bwd"]

BLOCK = 1024
_KERNELS = None


def _kernels():
    # the helpers and ``tl`` become module globals: a jitted function
    # resolves the names it calls in its module's globals
    global _KERNELS, tl, _sigmoid, _tanh, _gates
    if _KERNELS is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _sigmoid(x):
            return 1.0 / (1.0 + tl.exp(-x))

        @triton.jit
        def _tanh(x):
            e = tl.exp(-2.0 * tl.abs(x))
            t = (1.0 - e) / (1.0 + e)
            return tl.where(x >= 0, t, -t)

        @triton.jit
        def _gates(xg_ptr, hg_ptr, b_ptr, row, col, H, mask):
            base = row * 4 * H + col
            zi = tl.load(xg_ptr + base, mask=mask, other=0.0).to(tl.float32) \
                + tl.load(hg_ptr + base, mask=mask, other=0.0).to(tl.float32) \
                + tl.load(b_ptr + col, mask=mask, other=0.0).to(tl.float32)
            zf = tl.load(xg_ptr + base + H, mask=mask,
                         other=0.0).to(tl.float32) \
                + tl.load(hg_ptr + base + H, mask=mask,
                          other=0.0).to(tl.float32) \
                + tl.load(b_ptr + col + H, mask=mask,
                          other=0.0).to(tl.float32)
            zg = tl.load(xg_ptr + base + 2 * H, mask=mask,
                         other=0.0).to(tl.float32) \
                + tl.load(hg_ptr + base + 2 * H, mask=mask,
                          other=0.0).to(tl.float32) \
                + tl.load(b_ptr + col + 2 * H, mask=mask,
                          other=0.0).to(tl.float32)
            zo = tl.load(xg_ptr + base + 3 * H, mask=mask,
                         other=0.0).to(tl.float32) \
                + tl.load(hg_ptr + base + 3 * H, mask=mask,
                          other=0.0).to(tl.float32) \
                + tl.load(b_ptr + col + 3 * H, mask=mask,
                          other=0.0).to(tl.float32)
            return _sigmoid(zi), _sigmoid(zf), _tanh(zg), _sigmoid(zo)

        @triton.jit
        def _lstm_cell_fwd(xg_ptr, hg_ptr, b_ptr, cp_ptr, h_ptr, c_ptr, n,
                           H, BLOCK: tl.constexpr):
            offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            row = offs // H
            col = offs % H
            i, f, g, o = _gates(xg_ptr, hg_ptr, b_ptr, row, col, H, mask)
            cp = tl.load(cp_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            c = f * cp + i * g
            h = o * _tanh(c)
            tl.store(c_ptr + offs, c.to(c_ptr.dtype.element_ty), mask=mask)
            tl.store(h_ptr + offs, h.to(h_ptr.dtype.element_ty), mask=mask)

        @triton.jit
        def _lstm_cell_bwd(xg_ptr, hg_ptr, b_ptr, cp_ptr, dh_ptr, dc_ptr,
                           dz_ptr, dcp_ptr, n, H, BLOCK: tl.constexpr):
            offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            row = offs // H
            col = offs % H
            i, f, g, o = _gates(xg_ptr, hg_ptr, b_ptr, row, col, H, mask)
            cp = tl.load(cp_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            dh = tl.load(dh_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            dc = tl.load(dc_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            c = f * cp + i * g
            tc = _tanh(c)
            dct = dc + dh * o * (1.0 - tc * tc)
            base = row * 4 * H + col
            ty = dz_ptr.dtype.element_ty
            tl.store(dz_ptr + base, (dct * g * i * (1.0 - i)).to(ty),
                     mask=mask)
            tl.store(dz_ptr + base + H, (dct * cp * f * (1.0 - f)).to(ty),
                     mask=mask)
            tl.store(dz_ptr + base + 2 * H, (dct * i * (1.0 - g * g)).to(ty),
                     mask=mask)
            tl.store(dz_ptr + base + 3 * H, (dh * tc * o * (1.0 - o)).to(ty),
                     mask=mask)
            tl.store(dcp_ptr + offs, (dct * f).to(dcp_ptr.dtype.element_ty),
                     mask=mask)

        _KERNELS = (_lstm_cell_fwd, _lstm_cell_bwd)
    return _KERNELS


def launch_fwd(xg, hg, b, c_prev, h, c):
    """Launch the forward on PyTorch's current stream. The caller has
    checked device, dtype, shapes, contiguity and size."""
    n = c_prev.numel()
    grid = ((n + BLOCK - 1) // BLOCK,)
    _kernels()[0][grid](xg, hg, b, c_prev, h, c, n, c_prev.shape[1],
                        BLOCK=BLOCK, num_warps=4)


def launch_bwd(xg, hg, b, c_prev, dh, dc, dz, dc_prev):
    """Launch the backward on PyTorch's current stream (checks as for
    ``launch_fwd``)."""
    n = c_prev.numel()
    grid = ((n + BLOCK - 1) // BLOCK,)
    _kernels()[1][grid](xg, hg, b, c_prev, dh, dc, dz, dc_prev, n,
                        c_prev.shape[1], BLOCK=BLOCK, num_warps=4)
