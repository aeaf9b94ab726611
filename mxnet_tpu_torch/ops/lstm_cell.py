"""The LSTM cell's pointwise pass: the wrappers of L1
(``kernels/lstm_cell_triton.py``), their plain versions and the
autograd function the ``RNN`` op's lstm mode steps with.

``lstm_cell(xg, hg, b, c_prev)`` takes the step's two gate
pre-activations, each (N, 4H) in the reference's gate order (i, f, g,
o): the input product (a slice of the product hoisted over all steps)
and the recurrent product, the summed biases ``bx + bh`` (4H,) and the
previous cell (N, H); it returns ``(h, c)``. Its backward recomputes
the gates from the saved inputs (no activation is stored), writes the
(N, 4H) pre-activation gradient, which is the gradient of ``xg``, of
``hg`` and of each row of ``b``, and ``dc_prev``.

On CUDA tensors ``lstm_cell_fwd`` / ``lstm_cell_bwd`` launch L1
(fp32 or bf16, every tensor in one dtype, contiguous) or raise; on CPU
tensors they run the plain versions, the same fp32 arithmetic with one
rounding per output. Each counts its launches in ``.launches`` through
``fused_bn_conv._count``, so a launch inside a CUDA graph capture goes
to the capture's tally and every replay adds it.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import fused_bn_conv as _fb

__all__ = ["lstm_cell", "lstm_cell_fwd", "lstm_cell_bwd",
           "lstm_cell_fwd_plain", "lstm_cell_bwd_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _gates_plain(xg, hg, b):
    z = xg.float() + hg.float() + b.float()
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    return (torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg),
            torch.sigmoid(zo))


def lstm_cell_fwd_plain(xg, hg, b, c_prev):
    """Plain PyTorch version of L1's forward: ``(h, c)`` in
    ``c_prev.dtype``, computed in fp32."""
    with torch.no_grad():
        i, f, g, o = _gates_plain(xg, hg, b)
        c = f * c_prev.float() + i * g
        h = o * torch.tanh(c)
        return h.to(c_prev.dtype), c.to(c_prev.dtype)


def lstm_cell_bwd_plain(xg, hg, b, c_prev, dh, dc):
    """Plain PyTorch version of L1's backward: ``(dz, dc_prev)``, the
    (N, 4H) pre-activation gradient in ``xg.dtype`` and the previous
    cell's gradient in ``c_prev.dtype``, computed in fp32."""
    with torch.no_grad():
        i, f, g, o = _gates_plain(xg, hg, b)
        cp = c_prev.float()
        dh, dc = dh.float(), dc.float()
        tc = torch.tanh(f * cp + i * g)
        dct = dc + dh * o * (1.0 - tc * tc)
        dz = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                        dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)],
                       dim=-1)
        return dz.to(xg.dtype), (dct * f).to(c_prev.dtype)


def _check(op, xg, hg, b, c_prev, extra=()):
    if c_prev.dim() != 2 or xg.shape != (c_prev.shape[0],
                                         4 * c_prev.shape[1]) \
            or hg.shape != xg.shape or b.shape != (xg.shape[1],) \
            or any(t.shape != c_prev.shape for t in extra):
        raise MXNetError(
            f"{op}: shapes xg {tuple(xg.shape)}, hg {tuple(hg.shape)}, b "
            f"{tuple(b.shape)}, c_prev {tuple(c_prev.shape)}, "
            f"{[tuple(t.shape) for t in extra]} do not fit (N, 4H), "
            "(N, 4H), (4H,), (N, H)")


def lstm_cell_fwd(xg, hg, b, c_prev):
    """``(h, c)`` of one LSTM step (see the module docstring). On CUDA:
    L1's forward; on CPU: the plain version."""
    _check("lstm_cell_fwd", xg, hg, b, c_prev)
    if _fb._plain_device(c_prev):
        return lstm_cell_fwd_plain(xg, hg, b, c_prev)
    _fb._check_cuda("lstm_cell_fwd", c_prev, (xg, hg, b), _DTYPES)
    h = torch.empty_like(c_prev)
    c = torch.empty_like(c_prev)
    if c_prev.numel():
        from ..kernels import lstm_cell_triton
        with _fb._on_device(c_prev.device):
            lstm_cell_triton.launch_fwd(xg, hg, b, c_prev, h, c)
        _fb._count("lstm_cell_fwd", c_prev.device)
    return h, c


def lstm_cell_bwd(xg, hg, b, c_prev, dh, dc):
    """``(dz, dc_prev)`` of one LSTM step from the forward's inputs and
    the gradients of ``h`` and ``c`` (see the module docstring). On CUDA:
    L1's backward; on CPU: the plain version."""
    _check("lstm_cell_bwd", xg, hg, b, c_prev, (dh, dc))
    if _fb._plain_device(c_prev):
        return lstm_cell_bwd_plain(xg, hg, b, c_prev, dh, dc)
    _fb._check_cuda("lstm_cell_bwd", c_prev, (xg, hg, b, dh, dc), _DTYPES)
    dz = torch.empty_like(xg)
    dcp = torch.empty_like(c_prev)
    if c_prev.numel():
        from ..kernels import lstm_cell_triton
        with _fb._on_device(c_prev.device):
            lstm_cell_triton.launch_bwd(xg, hg, b, c_prev, dh, dc, dz, dcp)
        _fb._count("lstm_cell_bwd", c_prev.device)
    return dz, dcp


_fb.register_wrapper(lstm_cell_fwd)
_fb.register_wrapper(lstm_cell_bwd)


class _LSTMCell(torch.autograd.Function):
    """L1 forward and backward; the saved tensors are the forward's
    inputs."""

    @staticmethod
    def forward(ctx, xg, hg, b, c_prev):
        ctx.save_for_backward(xg, hg, b, c_prev)
        return lstm_cell_fwd(xg, hg, b, c_prev)

    @staticmethod
    def backward(ctx, dh, dc):
        xg, hg, b, c_prev = ctx.saved_tensors
        dz, dcp = lstm_cell_bwd(xg, hg, b, c_prev,
                                dh.to(c_prev.dtype).contiguous(),
                                dc.to(c_prev.dtype).contiguous())
        db = dz.sum(dim=0, dtype=torch.float32).to(b.dtype)
        return dz, dz, db, dcp


def lstm_cell(xg, hg, b, c_prev):
    """``(h, c)`` of one LSTM step, differentiable (``_LSTMCell``). The
    inputs are made contiguous and given one dtype, ``c_prev``'s."""
    dt = c_prev.dtype
    return _LSTMCell.apply(xg.to(dt).contiguous(), hg.to(dt).contiguous(),
                           b.to(dt).contiguous(), c_prev.contiguous())
