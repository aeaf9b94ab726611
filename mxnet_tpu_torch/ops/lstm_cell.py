"""The LSTM cell: the wrappers of L1, their plain versions, the route
plan and the autograd functions the ``RNN`` op's lstm mode runs.

L1 has two forms. In bf16 on CUDA it is the fused step
(``kernels/csrc/lstm_step.cu``): ``lstm_step_fwd`` / ``lstm_step_bwd``,
one launch a step each way with the recurrent product inside, driven
over a whole layer by ``_LSTMLayer`` (see ``lstm_layer``). In fp32 on
CUDA it is the pointwise pass (``kernels/lstm_cell_triton.py``) beside a
``torch.matmul`` a step, through ``lstm_cell``: wgmma's fp32 is TF32,
and the port keeps fp32 products in full fp32. ``_l1_plan`` picks the
route from dtype, shapes and device before anything launches.

The pointwise pass:

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

import ctypes
import functools
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import fused_bn_conv as _fb

__all__ = ["lstm_cell", "lstm_cell_fwd", "lstm_cell_bwd",
           "lstm_cell_fwd_plain", "lstm_cell_bwd_plain", "lstm_layer",
           "lstm_step_fwd", "lstm_step_bwd", "lstm_step_fwd_plain",
           "lstm_step_bwd_plain", "stage_recurrent_weight", "StagedWeight",
           "L1Plan"]

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


# ---------------------------------------------------------------------------
# the fused step: kernels/csrc/lstm_step.cu (bf16 on CUDA)
# ---------------------------------------------------------------------------
# lstm_step_fwd computes z = xg + h_prev . Wh^T + b and the cell in one
# kernel (the cell is the product's epilogue) and writes h, c and, for
# the backward, z in bf16; lstm_step_bwd computes the cell's backward as
# the A operand of dh_prev = dz . Wh and writes dz, dc_prev and dh_prev
# (fp32). Against the pointwise route, the backward reads the forward's
# z rounded to bf16 where L1's backward recomputes it in fp32 from its
# inputs: one more rounding of its inputs, and the recurrent gradients
# dh and dc are carried in fp32 where autograd carried them in bf16.

# the kernels' constants (kernels/csrc/lstm_step.cu)
_FWD_TILES = ((128, 64), (128, 128), (64, 128), (64, 256))
_BWD_SLICE_CHOICES = (4, 8, 16)
_BWD_NW = 224                  # output columns a consumer warpgroup
_BWD_COLS = 3 * _BWD_NW        # 672: the widest H the backward takes
_SLACK = 1024
_SMEM_MAX = 232448             # an H100 block's shared memory
_FWD_STAGES = 4
# the tile and the cluster the plan takes (a sweep on an H100, PERF.md)
L1_FWD_TILE = (128, 128)
L1_BWD_SLICES = 8


class StagedWeight(NamedTuple):
    """The recurrent weight ``wh`` (4H, H) and its two staged copies
    (``stage_recurrent_weight``); ``fwd`` / ``bwd`` are None on the plain
    route, which reads ``wh``."""
    wh: torch.Tensor
    fwd: torch.Tensor | None   # (4 hp, hp): gate rows interleaved
    bwd: torch.Tensor | None   # (672, 4 hp): wh^T, K in the A order


class L1Plan(NamedTuple):
    """How an LSTM layer's steps run, from dtype, shapes and device."""
    route: str        # "plain" (CPU, meta), "fused" (CUDA bf16) or
    #                   "triton" (CUDA fp32: L1's pointwise pass)
    hp: int           # units padded to 16, the staged copies' width
    fwd_tile: tuple   # (rows, staged columns) a forward block
    fwd_stages: int
    fwd_smem: int     # dynamic shared memory a forward block
    fwd_grid: tuple   # (column tiles, row tiles)
    bwd_slices: int   # K slices of the backward: a cluster's blocks
    bwd_stages: int
    bwd_smem: int
    bwd_grid: tuple   # (slices, row tiles)


def _cdiv(a, b):
    return -(-a // b)


def _fwd_smem(bm, bn, stages):
    # the ring, the epilogue tile (xg, c, h with rows of bn / 4 + 8 units,
    # b) and the mbarriers
    bu = bn // 4
    epi = _cdiv(2 * (6 * bm * (bu + 8) + 4 * bu), 16) * 16
    return _SLACK + stages * (bm + bn) * 128 + epi + 16 * stages + 16


def _bwd_smem(max_steps, stages):
    body = max(stages * _BWD_COLS * 128 + max_steps * 2048,
               64 * (_BWD_COLS + 8) * 4)
    return _SLACK + body + 16 * stages


@functools.lru_cache(maxsize=256)
def _l1_plan(dtype, n, h, device, fwd_tile=None, bwd_slices=None):
    """The route of an LSTM layer of batch ``n`` and width ``h`` in
    ``dtype`` on ``device`` (a ``torch.device`` or its name): CPU and
    meta -> "plain"; CUDA fp32 -> "triton"; CUDA bf16 with an even h
    from 2 to 672 -> "fused", with the forward's tile (``L1_FWD_TILE``, or
    ``fwd_tile``), the backward's slices (``L1_BWD_SLICES``, or
    ``bwd_slices``), stages, shared memory and grids. Anything else on
    CUDA raises: no route falls back to another."""
    dev = torch.device(device)
    hp = 16 * _cdiv(max(h, 1), 16)
    if dev.type in ("cpu", "meta"):
        return L1Plan("plain", hp, (), 0, 0, (), 0, 0, 0, ())
    if dev.type != "cuda":
        raise MXNetError(f"LSTM: unsupported device {dev}")
    if dtype == torch.float32:
        return L1Plan("triton", hp, (), 0, 0, (), 0, 0, 0, ())
    if dtype != torch.bfloat16:
        raise MXNetError(f"LSTM: dtype {dtype} is not supported on CUDA "
                         "(bfloat16: the fused step; float32: L1)")
    if not 2 <= h <= _BWD_COLS or h % 2 or n < 1:
        raise MXNetError(f"LSTM: the fused bf16 step takes an even H from "
                         f"2 to {_BWD_COLS} and N >= 1, not H {h}, N {n}")
    if n * 4 * h >= 2 ** 31:
        raise MXNetError(f"LSTM: {n} x {4 * h} gate elements exceed the "
                         "kernels' 32-bit offsets")
    bm, bn = fwd_tile or L1_FWD_TILE
    if (bm, bn) not in _FWD_TILES:
        raise MXNetError(f"LSTM: forward tile {(bm, bn)} (built: "
                         f"{_FWD_TILES})")
    slices = bwd_slices or L1_BWD_SLICES
    if slices not in _BWD_SLICE_CHOICES:
        raise MXNetError(f"LSTM: {slices} backward slices (built: "
                         f"{_BWD_SLICE_CHOICES})")
    max_steps = 4 * _cdiv(hp // 16, slices)
    stages = next((s for s in (2, 1)
                   if _bwd_smem(max_steps, s) <= _SMEM_MAX), None)
    if stages is None:
        raise MXNetError(f"LSTM: {slices} backward slices of H {h} need "
                         "more shared memory than a block has")
    return L1Plan("fused", hp, (bm, bn), _FWD_STAGES,
                  _fwd_smem(bm, bn, _FWD_STAGES),
                  (_cdiv(4 * hp, bn), _cdiv(n, bm)), slices, stages,
                  _bwd_smem(max_steps, stages), (slices, _cdiv(n, 64)))


@functools.lru_cache(maxsize=32)
def _stage_index(h, device):
    """Flat indices into ``cat(wh.reshape(-1), [0])`` of the two staged
    copies, one after the other (index ``4 h * h`` is the zero)."""
    hp = 16 * _cdiv(h, 16)
    zero = 4 * h * h
    # fwd (4 hp, hp): row 64 p + 16 q + j is gate q's row of unit 16 p + j
    r = torch.arange(4 * hp)
    unit = 16 * (r // 64) + r % 16
    gate = (r % 64) // 16
    k = torch.arange(hp)
    fwd = torch.where((unit < h)[:, None] & (k < h)[None, :],
                      (gate * h + unit)[:, None] * h + k[None, :], zero)
    # bwd (672, 4 hp): column 16 s + c (k16 step s = 4 p + k) holds unit
    # 16 p + 4 ((c % 8) // 2) + k of gate (c % 2) + 2 (c // 8); row n is
    # wh's column n
    col = torch.arange(4 * hp)
    c, step = col % 16, col // 16
    unit = 16 * (step // 4) + 4 * ((c % 8) // 2) + step % 4
    gate = c % 2 + 2 * (c // 8)
    n = torch.arange(_BWD_COLS)
    bwd = torch.where((n < h)[:, None] & (unit < h)[None, :],
                      (gate * h + unit)[None, :] * h + n[:, None], zero)
    return torch.cat([fwd.reshape(-1), bwd.reshape(-1)]).to(device), hp


def stage_recurrent_weight(wh):
    """The fused step's two copies of the recurrent weight ``wh`` (4H, H)
    in one buffer, made by a concatenation and one gather (two launches,
    capturable; once per layer call):
    ``fwd`` (4 hp, hp), the rows in the forward's gate-interleaved order,
    and ``bwd`` (672, 4 hp), wh transposed with its K (gate rows) in the
    order of the backward's A fragments; zeros past H. ``hp`` is H padded
    to 16."""
    h = wh.shape[1]
    if wh.shape != (4 * h, h):
        raise MXNetError(f"stage_recurrent_weight: wh {tuple(wh.shape)} is "
                         "not (4H, H)")
    idx, hp = _stage_index(h, wh.device)
    flat = torch.cat([wh.reshape(-1), wh.new_zeros(1)])[idx]
    n_fwd = 4 * hp * hp
    return StagedWeight(wh, flat[:n_fwd].view(4 * hp, hp),
                        flat[n_fwd:].view(_BWD_COLS, 4 * hp))


def _carry_dtype(dtype):
    """The dtype the steps compute and carry the recurrent gradients in:
    fp32, or float64 for float64 layers."""
    return torch.promote_types(dtype, torch.float32)


def lstm_step_fwd_plain(xg, h_prev, wh, b, c_prev):
    """Plain PyTorch version of ``lstm_step_fwd``: ``(h, c, z)`` in
    ``c_prev.dtype``; the product in fp32 (float64 for float64) over the
    operands' values, z and the cell likewise, each output rounded
    once."""
    ct = _carry_dtype(c_prev.dtype)
    with torch.no_grad():
        hg = torch.matmul(h_prev.to(ct), wh.to(ct).t())
        z = xg.to(ct) + hg + b.to(ct)
        zi, zf, zg, zo = z.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg),
                      torch.sigmoid(zo))
        c = f * c_prev.to(ct) + i * g
        h = o * torch.tanh(c)
        dt = c_prev.dtype
        return h.to(dt), c.to(dt), z.to(dt)


def lstm_step_bwd_plain(dy, dh_rec, dc, z, c_prev, wh):
    """Plain PyTorch version of ``lstm_step_bwd``: ``(dz, dc_prev,
    dh_prev)``: dz (N, 4H) in ``z.dtype``, the gradients of the previous
    cell and h in fp32 (float64 for float64), ``dh_prev = dz . wh`` over
    dz's rounded values."""
    ct = _carry_dtype(z.dtype)
    with torch.no_grad():
        zi, zf, zg, zo = z.to(ct).chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg),
                      torch.sigmoid(zo))
        cp = c_prev.to(ct)
        dh = dy.to(ct) + dh_rec.to(ct)
        tc = torch.tanh(f * cp + i * g)
        dct = dc.to(ct) + dh * o * (1.0 - tc * tc)
        dz = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                        dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)],
                       dim=-1).to(z.dtype)
        return dz, dct * f, torch.matmul(dz.to(ct), wh.to(ct))


def _lstm_lib():
    """The fused step's library, built and loaded on first use, its
    shared-memory limits set once (outside any capture)."""
    from ..kernels import build
    lib = build.load("lstm_step")
    if not getattr(lib, "_mxtt_ready", False):
        fn = lib.mxtt_lstm_step_init
        fn.restype = ctypes.c_int
        _fb._launch_rc("lstm_step_init", fn())
        lib.mxtt_lstm_step_fwd.restype = ctypes.c_int
        lib.mxtt_lstm_step_fwd.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
            + [ctypes.c_void_p])
        lib.mxtt_lstm_step_bwd.restype = ctypes.c_int
        lib.mxtt_lstm_step_bwd.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.mxtt_lstm_bwd_max_clusters.restype = ctypes.c_int
        lib.mxtt_lstm_bwd_max_clusters.argtypes = [ctypes.c_int] * 2
        lib._mxtt_ready = True
    return lib


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _check_step(op, n, h, pairs):
    for name, t, shape, dtype in pairs:
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise MXNetError(f"{op}: {name} {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype} (N {n}, H {h})")


def _check_step_cuda(op, device, tensors, strided=()):
    for t in tensors + strided:
        if t is not None and t.device != device:
            raise MXNetError(f"{op}: tensors on {t.device} and {device}")
    if any(t is not None and not t.is_contiguous() for t in tensors):
        raise MXNetError(f"{op}: inputs must be contiguous")
    for t in strided:
        if t is not None and (t.stride(1) != 1 or t.stride(0) % 8
                              or t.data_ptr() % 16):
            raise MXNetError(f"{op}: a recurrent h must have unit column "
                             "stride, a row stride of a multiple of 8 and "
                             "a 16-byte aligned start")


def lstm_step_fwd(xg, h_prev, w, b, c_prev, h, c, z=None, h_next=None,
                  plan=None):
    """One forward step of an LSTM layer: from the input product ``xg``
    (N, 4H), the previous ``h_prev`` and ``c_prev`` (N, H), the weight
    ``w`` (a ``StagedWeight``) and the summed biases ``b`` (4H,), write
    ``h`` and ``c`` (N, H) and, if given, ``z`` (N, 4H) and ``h_next`` (a
    copy of h). On CUDA: the fused kernel (bf16; ``h_prev`` and
    ``h_next`` may have a row stride of a multiple of 8, the rest
    contiguous) or raise; on CPU: ``lstm_step_fwd_plain``."""
    n, hh = c_prev.shape
    dt = c_prev.dtype
    _check_step("lstm_step_fwd", n, hh, (
        ("xg", xg, (n, 4 * hh), dt), ("h_prev", h_prev, (n, hh), dt),
        ("wh", w.wh, (4 * hh, hh), dt), ("b", b, (4 * hh,), dt),
        ("h", h, (n, hh), dt), ("c", c, (n, hh), dt),
        ("z", z, (n, 4 * hh), dt), ("h_next", h_next, (n, hh), dt)))
    if _fb._plain_device(c_prev):
        ho, co, zo = lstm_step_fwd_plain(xg, h_prev, w.wh, b, c_prev)
        h.copy_(ho)
        c.copy_(co)
        if z is not None:
            z.copy_(zo)
        if h_next is not None:
            h_next.copy_(ho)
        return
    plan = plan or _l1_plan(dt, n, hh, c_prev.device)
    if plan.route != "fused":
        raise MXNetError(f"lstm_step_fwd: the {plan.route} route has no "
                         "fused step")
    _check_step_cuda("lstm_step_fwd", c_prev.device,
                     (xg, w.fwd, b, c_prev, h, c, z), (h_prev, h_next))
    with _fb._on_device(c_prev.device):
        rc = _lstm_lib().mxtt_lstm_step_fwd(
            xg.data_ptr(), h_prev.data_ptr(), h_prev.stride(0),
            w.fwd.data_ptr(), b.data_ptr(), c_prev.data_ptr(), h.data_ptr(),
            _ptr(h_next), h_next.stride(0) if h_next is not None else 0,
            c.data_ptr(), _ptr(z), n, hh, plan.hp, *plan.fwd_tile,
            plan.fwd_stages, plan.fwd_smem, _fb._stream_handle(c_prev.device))
    _fb._launch_rc("lstm_step_fwd", rc)
    _fb._count("lstm_step_fwd", c_prev.device)


def lstm_step_bwd(dy, dh_rec, dc, z, c_prev, w, dz, dc_prev, dh_prev,
                  plan=None):
    """One backward step of an LSTM layer: from the gradient ``dy`` of
    this step's output h, the recurrent gradients ``dh_rec`` and ``dc``
    (fp32; float64 for float64), the forward's ``z`` and ``c_prev`` and
    the weight ``w``,
    write ``dz`` (N, 4H) in z's dtype and ``dc_prev``, ``dh_prev`` (N, H)
    in fp32 (float64 for float64). On CUDA: the fused kernel (bf16,
    contiguous) or raise; on CPU: ``lstm_step_bwd_plain``."""
    n, hh = c_prev.shape
    dt = c_prev.dtype
    ct = _carry_dtype(dt)
    _check_step("lstm_step_bwd", n, hh, (
        ("dy", dy, (n, hh), dt), ("dh_rec", dh_rec, (n, hh), ct),
        ("dc", dc, (n, hh), ct), ("z", z, (n, 4 * hh), dt),
        ("wh", w.wh, (4 * hh, hh), dt), ("dz", dz, (n, 4 * hh), dt),
        ("dc_prev", dc_prev, (n, hh), ct),
        ("dh_prev", dh_prev, (n, hh), ct)))
    if _fb._plain_device(c_prev):
        for out, v in zip((dz, dc_prev, dh_prev), lstm_step_bwd_plain(
                dy, dh_rec, dc, z, c_prev, w.wh)):
            out.copy_(v)
        return
    plan = plan or _l1_plan(dt, n, hh, c_prev.device)
    if plan.route != "fused":
        raise MXNetError(f"lstm_step_bwd: the {plan.route} route has no "
                         "fused step")
    _check_step_cuda("lstm_step_bwd", c_prev.device,
                     (dy, dh_rec, dc, z, c_prev, w.bwd, dz, dc_prev,
                      dh_prev))
    with _fb._on_device(c_prev.device):
        rc = _lstm_lib().mxtt_lstm_step_bwd(
            dy.data_ptr(), dh_rec.data_ptr(), dc.data_ptr(), z.data_ptr(),
            c_prev.data_ptr(), w.bwd.data_ptr(), dz.data_ptr(),
            dc_prev.data_ptr(), dh_prev.data_ptr(), n, hh, plan.hp,
            plan.bwd_slices, plan.bwd_stages, plan.bwd_smem,
            _fb._stream_handle(c_prev.device))
    _fb._launch_rc("lstm_step_bwd", rc)
    _fb._count("lstm_step_bwd", c_prev.device)


_fb.register_wrapper(lstm_step_fwd)
_fb.register_wrapper(lstm_step_bwd)


def _forward_order(steps, reverse):
    return range(steps - 1, -1, -1) if reverse else range(steps)


class _LSTMLayer(torch.autograd.Function):
    """One LSTM layer and direction: ``(gx, wh, b, h0, c0, reverse)`` ->
    ``(ys, h_T, c_T)``, gx (T, N, 4H) the hoisted input product. One
    ``lstm_step_fwd`` a step forward, one ``lstm_step_bwd`` a step back;
    after the backward's loop ``dgx`` is the stacked dz, ``db`` its sum
    over (T, N) in fp32 and ``dwh`` one product over all T * N rows."""

    @staticmethod
    def forward(ctx, gx, wh, b, h0, c0, reverse):
        steps, n, g4 = gx.shape
        hh = g4 // 4
        plan = _l1_plan(gx.dtype, n, hh, gx.device)
        fused = plan.route == "fused"
        w = stage_recurrent_weight(wh) if fused \
            else StagedWeight(wh, None, None)
        save = any(ctx.needs_input_grad[:5])
        ys = gx.new_empty((steps, n, hh))
        cs = gx.new_empty((steps + 1, n, hh))
        cs[0].copy_(c0)
        zs = gx.new_empty((steps, n, g4)) if save else None
        if fused:
            # the kernels' recurrent h: rows padded to hp (a 16-byte
            # multiple, as TMA needs), two buffers in turn
            hbuf = gx.new_empty((2, n, plan.hp))
            hbuf[0, :, :hh].copy_(h0)
            h_prev = hbuf[0, :, :hh]
        else:
            h_prev = h0
        order = _forward_order(steps, reverse)
        for k, t in enumerate(order):
            h_next = hbuf[(k + 1) % 2, :, :hh] if fused else None
            lstm_step_fwd(gx[t], h_prev, w, b, cs[k], ys[t], cs[k + 1],
                          zs[t] if save else None, h_next, plan)
            h_prev = h_next if fused else ys[t]
        ctx.plan, ctx.reverse = plan, reverse
        if save:
            ctx.save_for_backward(zs, cs, ys, h0, wh, w.bwd)
        return ys, ys[order[-1]].clone(), cs[steps].clone()

    @staticmethod
    def backward(ctx, dys, dh_t, dc_t):
        zs, cs, ys, h0, wh, wb = ctx.saved_tensors
        steps, n, hh = ys.shape
        dt = ys.dtype
        ct = _carry_dtype(dt)
        w = StagedWeight(wh, None, wb)
        dys = torch.zeros_like(ys) if dys is None \
            else dys.to(dt).contiguous()
        dh = torch.zeros((n, hh), dtype=ct, device=ys.device) \
            if dh_t is None else dh_t.to(ct).contiguous()
        dc = torch.zeros((n, hh), dtype=ct, device=ys.device) \
            if dc_t is None else dc_t.to(ct).contiguous()
        dz = torch.empty_like(zs)
        dhb = torch.empty((2, n, hh), dtype=ct, device=ys.device)
        dcb = torch.empty_like(dhb)
        order = list(_forward_order(steps, ctx.reverse))
        for j, k in enumerate(range(steps - 1, -1, -1)):
            t = order[k]
            lstm_step_bwd(dys[t], dh, dc, zs[t], cs[k], w, dz[t],
                          dcb[j % 2], dhb[j % 2], ctx.plan)
            dh, dc = dhb[j % 2], dcb[j % 2]
        need = ctx.needs_input_grad
        db = dz.sum(dim=(0, 1), dtype=ct).to(dt) if need[2] else None
        dwh = None
        if need[1]:
            # h before each step, in the steps' time order
            hprev = torch.cat([ys[1:], h0[None]]) if ctx.reverse \
                else torch.cat([h0[None], ys[:-1]])
            dwh = torch.matmul(dz.reshape(steps * n, 4 * hh).t(),
                               hprev.reshape(steps * n, hh))
        return (dz, dwh, db, dh.to(h0.dtype) if need[3] else None,
                dc.to(dt) if need[4] else None, None)


def lstm_layer(gx, wh, b, h0, c0, reverse=False):
    """``(ys, h_T, c_T)`` of one LSTM layer and direction over the hoisted
    input product ``gx`` (T, N, 4H), differentiable (``_LSTMLayer``): the
    plain steps on CPU, the fused kernels in bf16 on CUDA. The inputs are
    given one dtype, gx's, and made contiguous."""
    dt = gx.dtype
    return _LSTMLayer.apply(gx.contiguous(), wh.to(dt).contiguous(),
                            b.to(dt).contiguous(), h0.to(dt), c0.to(dt),
                            bool(reverse))
