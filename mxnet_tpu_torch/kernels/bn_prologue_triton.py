"""BN-apply (+ReLU) prologue as one Triton elementwise pass.

Replaces the TPU kernel ``mxnet_tpu/ops/pallas_fused.py::
_make_prologue_kernel`` (``pallas_call`` in ``bn_relu_conv_nchw``'s
interpret branch): ``out = round_to_T(act(x * scale[c] + shift[c]))``
for NCHW ``x``, the normalised activation that ``_FusedBNReLUConvK``'s
forward feeds to its convolution.

Bound on an H100: bytes. It reads x once and writes out once (two bytes
each in bf16) for two flops per element, far under the ridge, so the
only design aim is full-bandwidth streaming: 1-D blocks of 2048
contiguous elements, the channel index taken from the flat offset
(``(offset // (H*W)) % C``), scale/shift gathered from L1/L2, math in
fp32 and one rounding to the output type. Triton's block model already
gives the vectorised, coalesced loads such a pass needs.

``triton`` is imported on the first launch, never when this module is
imported, so the CPU tests can import it.
"""
from __future__ import annotations

__all__ = ["launch"]

BLOCK = 2048
_KERNEL = None


def _kernel():
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _bn_act(x_ptr, scale_ptr, shift_ptr, out_ptr, n, C, HW,
                    RELU: tl.constexpr, BLOCK: tl.constexpr):
            offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            c = (offs // HW) % C
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            sc = tl.load(scale_ptr + c, mask=mask, other=0.0).to(tl.float32)
            sh = tl.load(shift_ptr + c, mask=mask, other=0.0).to(tl.float32)
            z = x * sc + sh
            if RELU:
                z = tl.maximum(z, 0.0)
            tl.store(out_ptr + offs, z.to(out_ptr.dtype.element_ty),
                     mask=mask)

        _KERNEL = _bn_act
    return _KERNEL


def launch(x, scale, shift, out, relu):
    """Launch on ``x``'s device and PyTorch's current stream. The caller
    has checked device, dtype, shapes, contiguity and size."""
    n = x.numel()
    _, c, h, w = x.shape
    grid = ((n + BLOCK - 1) // BLOCK,)
    _kernel()[grid](x, scale, shift, out, n, c, h * w,
                    RELU=bool(relu), BLOCK=BLOCK, num_warps=8)
