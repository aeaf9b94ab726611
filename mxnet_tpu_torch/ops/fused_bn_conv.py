"""Fused BatchNorm-apply(+ReLU) + convolution / matrix product: the
kernel wrappers, the two graph ops the rewrite passes substitute, and
``bn_relu_matmul`` (counterpart of ``mxnet_tpu/ops/pallas_fused.py``).

Kernel wrappers (forward kernels; their outputs carry no gradient):

- ``bn_relu_conv_nchw`` — K1, the fused BN-apply+ReLU+1x1 conv
  (``kernels/csrc/bn_relu_conv1x1.cu``; bf16 on the wgmma core of
  ``kernels/csrc/bn_gemm_wgmma.cuh`` where ``_k1_plan`` allows).
- ``bn_act_prologue`` — K2, the BN-apply(+ReLU) prologue
  (``kernels/bn_prologue_triton.py``).
- ``bn_relu_matmul_fwd`` — K3, the fused BN-apply(+ReLU)+matrix product
  of a row-major (M, K) x (``kernels/csrc/bn_relu_matmul.cu``; bf16 on
  the same wgmma core where ``_k3_plan`` allows).
- ``bn_backward_reduce`` — B1, the BN backward's per-channel sums
  (``kernels/bn_backward_triton.py``).
- ``bn_backward_dx`` — B2, the BN backward's dx assembly (same file).

A wrapper given a CUDA tensor launches its kernel or raises; it never
falls back to its plain version (``<name>_plain``), which only CPU and
meta tensors take (meta: shape inference). Each wrapper counts its
launches in ``<wrapper>.launches``. A call onto a stream that is
capturing a CUDA graph launches nothing: it goes to that stream's
``capture_tally``, which the compile registry adds to the counts at each
replay (``add_counts``), so the counts say how many kernels ran.

K1 and K3 choose their kernel before the launch, from shapes, dtype and
pointer alignment, by a plan (``_k1_plan``, ``_k3_plan``: route, tiles,
stages, shared memory, grid) that the C entry checks and runs; never
after a failure. Routes: ``wgmma_tma`` (x by TMA tensor map),
``wgmma_bulk`` (K1 only: x by one 1-D bulk copy per sample, for spatial
sizes whose channel stride no tensor map can describe), ``wmma`` (the
first kernels, for shapes the wgmma core does not take) and ``fp32``.
``route_counts()`` counts launches per route.

Differentiable ops, each a ``torch.autograd.Function`` whose backward is
the JAX package's custom VJP:

- ``_FusedBNReLUConv`` / ``_FusedBNReLUConvK`` (graph ops): forward with
  batch statistics in training (moving statistics otherwise) through K1,
  or K2 and the convolution; they save the raw x, never the normalised
  activation, and the backward recomputes it with K2, takes the
  convolution's gradients from ``aten.convolution_backward`` (the JAX
  package leaves them to XLA's conv-grad), the per-channel sums from B1
  and dx from B2: ``dx = scale*dz + cx*x + c0``.
- ``bn_relu_matmul`` (public, as in the JAX package): forward through
  K3; backward recomputes xhat with K2, ``dxhat = g @ w.T`` and
  ``dw = xhat.T @ g`` with ``torch.matmul``, ``dscale``/``dshift`` from
  B1 and ``dx = dz*scale`` from B2.

``select_conv_tiles`` / ``conv_tile_failure`` are kept as the rewrite
pass's applicability rule, so the pass rewrites the same sites as the
JAX package; the CUDA kernels have their own tiling and take any shape.

Dtype flow follows the JAX ops: params arrive in the compute dtype, the
batch mean and (biased) variance are taken in it with fp32 sums,
``scale``/``shift`` are computed in it, the normalised activation is
rounded to ``x.dtype`` before each product, sums are fp32 and the
outputs are ``x.dtype``. The backward's per-channel sums and
coefficients are fp32.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import _tup
from .registry import register_op

__all__ = ["bn_relu_conv_nchw", "bn_relu_conv_nchw_plain",
           "bn_act_prologue", "bn_act_prologue_plain",
           "bn_relu_matmul", "bn_relu_matmul_fwd", "bn_relu_matmul_fwd_plain",
           "bn_backward_reduce", "bn_backward_reduce_plain",
           "bn_backward_dx", "bn_backward_dx_plain",
           "select_conv_tiles", "conv_tile_failure", "reset_launch_counts",
           "launch_counts", "route_counts", "counter_state", "add_counts",
           "capture_tally", "register_wrapper", "KernelPlan"]

# output-tile candidates of the TPU kernels, largest first (the pass's
# applicability rule, and bn_relu_matmul's bm/bn rule)
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
    if x.numel() >= 2 ** 31:
        raise MXNetError(f"{op}: {x.numel()} elements exceed the kernel's "
                         "32-bit offsets")


def _check_dxhat(op, dxhat, x):
    """B1/B2 take the incoming gradient in x's dtype or in float32 (the
    fp32 product of ``bn_relu_matmul``'s backward)."""
    if dxhat.device != x.device:
        raise MXNetError(f"{op}: tensors on {dxhat.device} and {x.device}")
    if dxhat.dtype not in (x.dtype, torch.float32):
        raise MXNetError(f"{op}: gradient dtype {dxhat.dtype} with input "
                         f"dtype {x.dtype}")
    if not dxhat.is_contiguous():
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


def _launch_rc(name, rc):
    if rc != 0:
        raise MXNetError(f"{name} kernel launch failed: CUDA error {rc}")


def _align(*ts):
    """The largest power of two (up to 256) that divides every tensor's
    address."""
    a = 256
    for t in ts:
        p = t.data_ptr()
        if p:
            a = min(a, p & -p)
    return a


@functools.lru_cache(maxsize=None)
def _n_sm(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _c_entry(source, symbol, argtypes, defines=()):
    """The C entry point ``symbol`` of ``csrc/<source>.cu`` (built with
    the macros ``defines``), its library built and loaded on first use
    (``kernels/build.py`` caches it)."""
    from ..kernels import build
    fn = getattr(build.load(source, defines), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


# ---------------------------------------------------------------------------
# K1 / K3 plans: which kernel a call runs, decided before the launch
# ---------------------------------------------------------------------------
class KernelPlan(NamedTuple):
    """How a K1 or K3 call runs, from shapes, dtype and alignment."""
    route: str        # "wgmma_tma", "wgmma_bulk", "wmma" or "fp32"
    bm: int           # tile rows: positions (K1) or rows of M (K3)
    bn: int           # tile columns: output channels (O or N)
    stages: int       # stages in flight (register-staged kernels: 1)
    per_tile: int     # wgmma_bulk: whole samples per row tile; else 1
    smem_bytes: int   # dynamic shared memory (0: static only)
    grid: tuple       # (x, y, z) blocks


# the wgmma core's constants (kernels/csrc/bn_gemm_wgmma.cuh): tiles of
# 256 x 128 or 128 x 256 (rows x output channels), 64 channels a stage
_WG_TILES = ((256, 128), (128, 256))
_WG_BK = 64
_WG_MAX_STAGES = 4
SMEM_PER_BLOCK = 232448                    # an H100 block's limit
_ROUTE_IDS = {"wgmma_tma": 1, "wgmma_bulk": 2}
# launches per route since the last reset_launch_counts()
_ROUTE_COUNTS = {
    "bn_relu_conv_nchw": dict.fromkeys(("wgmma_tma", "wgmma_bulk", "wmma",
                                        "fp32"), 0),
    "bn_relu_matmul_fwd": dict.fromkeys(("wgmma_tma", "wmma", "fp32"), 0)}
_count_lock = threading.Lock()
_tallies = {}      # handle of a stream being captured -> its launches


def _stream_handle(device):
    return torch.cuda.current_stream(device).cuda_stream


def _count(name, device, route=None):
    """Count one launch of the wrapper ``name`` (on ``route``, for K1 and
    K3) on ``device``'s current stream. A launch onto a stream inside
    ``capture_tally`` is only recorded there: it runs at each replay,
    which adds the tally. Stream, not thread: the autograd engine runs a
    captured backward on its own thread, on the capturing stream."""
    delta = {name: 1}
    if route is not None:
        delta[f"{name}/{route}"] = 1
    tally = _tallies.get(_stream_handle(device)) if _tallies else None
    if tally is None:
        add_counts(delta)
        return
    with _count_lock:
        for k, n in delta.items():
            tally[k] = tally.get(k, 0) + n


@contextlib.contextmanager
def capture_tally(stream):
    """Within this block, wrapper calls that launch onto ``stream`` (the
    stream a CUDA graph captures) count into the yielded dict (keys as
    ``counter_state``'s), not into the counters. Launches onto other
    streams, from any thread, count as usual."""
    handle = stream.cuda_stream
    with _count_lock:
        _tallies[handle] = tally = {}
    try:
        yield tally
    finally:
        with _count_lock:
            del _tallies[handle]


def _cdiv(a, b):
    return -(-a // b)


def _wg_plan(route, tile, x_bytes, c, per_tile, tiles, n_sm):
    """The wgmma core's plan for ``tile`` = (rows, columns), or None when
    no two stages fit. Shared memory: 1 KB to align the ring, the ring
    (x part, W part), the output staging, (scale, shift) in fp32 and two
    mbarriers a stage."""
    bm, bn = tile
    fixed = 1024 + bm * bn * 2 + 8 * c
    stage = x_bytes + bn * _WG_BK * 2 + 16
    stages = min(_WG_MAX_STAGES, (SMEM_PER_BLOCK - fixed) // stage)
    if stages < 2:
        return None
    return KernelPlan(route, bm, bn, stages, per_tile,
                      fixed + stages * stage, (min(tiles, n_sm), 1, 1))


def _wg_tile(n_out, rows=0):
    """(rows, columns) of the wgmma tile: 128 x 256 for at least 256
    output channels (x is read, and normalised, once per 256 of them,
    which measured faster at every such ResNet-50 site) when ``rows``
    whole rows fit in 128, else 256 x 128."""
    wide = n_out >= 256 and rows <= _WG_TILES[1][0]
    return _WG_TILES[1] if wide else _WG_TILES[0]


def _k1_wmma_plan(b, c, o, s):
    """The plan of K1's first (WMMA) bf16 kernel, which takes any shape
    and alignment."""
    return KernelPlan("wmma", 128, 64, 1, 1, 0,
                      (_cdiv(o, 64), _cdiv(b * s, 128), 1))


@functools.lru_cache(maxsize=1024)
def _k1_plan(b, c, o, s, dtype, align=256, n_sm=132):
    """K1's plan for x (b, c, s positions) and w (o, c) in ``dtype``,
    every pointer a multiple of ``align`` bytes. bf16 takes the wgmma
    core when c is a multiple of 64, o of 8 and the pointers of 16:
    through a 3-D tensor map over x when s % 8 == 0 (s >= 64), so its
    channel stride is a multiple of 16 bytes; else, for s <= 256, by one
    1-D bulk copy of each sample's 64-channel chunk (contiguous in NCHW),
    as many whole samples a tile as its rows hold. Other shapes take the
    WMMA kernel; fp32 its own."""
    if dtype == torch.float32:
        return KernelPlan("fp32", 64, 64, 1, 1, 0,
                          (_cdiv(s, 64), _cdiv(o, 64), b))
    plan = None
    if align % 16 == 0 and c % _WG_BK == 0 and o % 8 == 0:
        if s % 8 == 0 and s >= 64:
            bm, bn = tile = _wg_tile(o)
            plan = _wg_plan("wgmma_tma", tile, bm * _WG_BK * 2, c, 1,
                            b * _cdiv(s, bm) * _cdiv(o, bn), n_sm)
        elif s <= _WG_TILES[0][0]:
            bm, bn = tile = _wg_tile(o, s)
            per = bm // s
            plan = _wg_plan("wgmma_bulk", tile,
                            _cdiv(per * _WG_BK * s * 2, 1024) * 1024, c, per,
                            _cdiv(b, per) * _cdiv(o, bn), n_sm)
    return plan or _k1_wmma_plan(b, c, o, s)


def _k3_wmma_plan(m, k, n):
    """The plan of K3's first (WMMA) bf16 kernel, which takes any shape
    and alignment."""
    return KernelPlan("wmma", 128, 64, 1, 1, 0,
                      (_cdiv(m, 128), _cdiv(n, 64), 1))


@functools.lru_cache(maxsize=1024)
def _k3_plan(m, k, n, dtype, align=256, n_sm=132):
    """K3's plan for x (m, k) and w (k, n) in ``dtype``, every pointer a
    multiple of ``align`` bytes: bf16 takes the wgmma core (x and W by
    2-D tensor maps, out by TMA store) when k is a multiple of 64, n of 8
    and the pointers of 16; other shapes the WMMA kernel; fp32 its
    own."""
    if dtype == torch.float32:
        return KernelPlan("fp32", 64, 64, 1, 1, 0,
                          (_cdiv(m, 64), _cdiv(n, 64), 1))
    plan = None
    if align % 16 == 0 and k % _WG_BK == 0 and n % 8 == 0 and m < 2 ** 31:
        bm, bn = tile = _wg_tile(n)
        plan = _wg_plan("wgmma_tma", tile, bm * _WG_BK * 2, k, 1,
                        _cdiv(m, bm) * _cdiv(n, bn), n_sm)
    return plan or _k3_wmma_plan(m, k, n)


# ---------------------------------------------------------------------------
# K1: fused BN-apply(+ReLU) + 1x1 conv
# ---------------------------------------------------------------------------
def bn_relu_conv_nchw_plain(x, w, scale, shift, relu=True):
    """Plain PyTorch version of K1 with the kernel's arithmetic:
    ``z = act(x*scale + shift)`` in fp32, rounded to ``x.dtype``, then
    ``w @ z`` over channels in fp32, rounded to ``x.dtype``."""
    b, c, h, wd = x.shape
    o = w.shape[0]
    with torch.no_grad():
        z = bn_act_prologue_plain(x, scale, shift, relu).float()
        out = torch.matmul(w.float(), z.reshape(b, c, h * wd))
    return out.to(x.dtype).reshape(b, o, h, wd)


def bn_relu_conv_nchw(x, w, scale, shift, relu=True):
    """``act(x*scale + shift)`` contracted with ``w`` over channels —
    the fused BN-apply(+ReLU)+1x1-conv forward. x (B, C, H, W), w (O, C),
    scale/shift (C,) -> (B, O, H, W) in ``x.dtype``. On CUDA: the
    hand-written kernel (float32 or bfloat16, every tensor in x's dtype,
    contiguous); on CPU: the plain version."""
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
    if b > 65535 or b * o * h * wd >= 2 ** 31:
        raise MXNetError(f"bn_relu_conv_nchw: shape {tuple(x.shape)} -> "
                         f"{o} channels is out of the kernel's range")
    # out, a fresh allocation of PyTorch's CUDA allocator, starts on a
    # 512-byte boundary
    plan = _k1_plan(b, c, o, h * wd, x.dtype, _align(x, w),
                    _n_sm(x.device.index))
    out = _k1_run(x, w, scale, shift, relu, plan)
    _count("bn_relu_conv_nchw", x.device, plan.route)
    return out


def _k1_run(x, w, scale, shift, relu, plan):
    """Launches K1's kernel of ``plan`` on checked CUDA tensors (counts
    nothing: ``bn_relu_conv_nchw`` counts its launches)."""
    b, c, h, wd = x.shape
    o = w.shape[0]
    out = torch.empty((b, o, h, wd), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr())
    with _on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.route in _ROUTE_IDS:
            fn = _c_entry("bn_relu_conv1x1", "mxtt_bn_relu_conv1x1_wgmma",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                          + [ctypes.c_void_p])
            rc = fn(*ptrs, b, c, o, h * wd, int(bool(relu)),
                    _ROUTE_IDS[plan.route], plan.bm, plan.bn, plan.stages,
                    plan.per_tile, plan.smem_bytes, plan.grid[0], stream)
        else:
            fn = _c_entry("bn_relu_conv1x1", "mxtt_bn_relu_conv1x1",
                          [ctypes.c_int] + [ctypes.c_void_p] * 5
                          + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            rc = fn(_KERNEL_DTYPES[x.dtype], *ptrs, b, c, o, h * wd,
                    int(bool(relu)), stream)
    _launch_rc("bn_relu_conv1x1", rc)
    return out


bn_relu_conv_nchw.launches = 0


# ---------------------------------------------------------------------------
# K2: BN-apply(+ReLU) prologue
# ---------------------------------------------------------------------------
def bn_act_prologue_plain(x, scale, shift, relu=True):
    """Plain PyTorch version of K2: ``act(x*scale[c] + shift[c])`` in
    fp32, rounded to ``x.dtype``."""
    c = x.shape[1]
    with torch.no_grad():
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
    if x.dim() != 4 or scale.shape != (x.shape[1],) \
            or shift.shape != scale.shape:
        raise MXNetError(
            f"bn_act_prologue: shapes x {tuple(x.shape)}, scale "
            f"{tuple(scale.shape)}, shift {tuple(shift.shape)} do not fit "
            "(B,C,H,W), (C,), (C,)")
    if _plain_device(x):
        return bn_act_prologue_plain(x, scale, shift, relu)
    _check_cuda("bn_act_prologue", x, (scale, shift), _KERNEL_DTYPES)
    from ..kernels import bn_prologue_triton
    out = torch.empty_like(x)
    if x.numel():
        with _on_device(x.device):
            bn_prologue_triton.launch(x, scale, shift, out, relu)
        _count("bn_act_prologue", x.device)
    return out


bn_act_prologue.launches = 0


# ---------------------------------------------------------------------------
# K3: fused BN-apply(+ReLU) + (M, K) @ (K, N)
# ---------------------------------------------------------------------------
def bn_relu_matmul_fwd_plain(x, w, scale, shift, relu=True):
    """Plain PyTorch version of K3: ``z = act(x*scale + shift)`` in fp32,
    rounded to ``x.dtype``, then ``z @ w`` in fp32, rounded to
    ``x.dtype``."""
    m, k = x.shape
    with torch.no_grad():
        z = bn_act_prologue_plain(x.reshape(m, k, 1, 1), scale, shift,
                                  relu).reshape(m, k)
        return torch.matmul(z.float(), w.float()).to(x.dtype)


def bn_relu_matmul_fwd(x, w, scale, shift, relu=True):
    """``act(x*scale + shift) @ w`` for x (M, K), w (K, N), scale/shift
    (K,) -> (M, N) in ``x.dtype``, without writing the normalised x. On
    CUDA: the hand-written kernel (float32 or bfloat16, every tensor in
    x's dtype, contiguous); on CPU: the plain version."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] \
            or scale.shape != (x.shape[1],) or shift.shape != scale.shape:
        raise MXNetError(
            f"bn_relu_matmul: shapes x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, scale {tuple(scale.shape)}, shift "
            f"{tuple(shift.shape)} do not fit (M,K), (K,N), (K,), (K,)")
    if _plain_device(x):
        return bn_relu_matmul_fwd_plain(x, w, scale, shift, relu)
    _check_cuda("bn_relu_matmul", x, (w, scale, shift), _KERNEL_DTYPES)
    m, k = x.shape
    n = w.shape[1]
    if m * n >= 2 ** 31 or n > 64 * 65535:
        raise MXNetError(f"bn_relu_matmul: ({m}, {k}) @ ({k}, {n}) is out "
                         "of the kernel's range")
    if m * n == 0 or k == 0:
        return torch.zeros((m, n), dtype=x.dtype, device=x.device)
    # out, a fresh allocation, starts on a 512-byte boundary
    plan = _k3_plan(m, k, n, x.dtype, _align(x, w), _n_sm(x.device.index))
    out = _k3_run(x, w, scale, shift, relu, plan)
    _count("bn_relu_matmul_fwd", x.device, plan.route)
    return out


def _k3_run(x, w, scale, shift, relu, plan):
    """Launches K3's kernel of ``plan`` on checked CUDA tensors (counts
    nothing: ``bn_relu_matmul_fwd`` counts its launches)."""
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr())
    with _on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.route in _ROUTE_IDS:
            fn = _c_entry("bn_relu_matmul", "mxtt_bn_relu_matmul_wgmma",
                          [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                          + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            rc = fn(*ptrs, m, k, n, int(bool(relu)), plan.bm, plan.bn,
                    plan.stages, plan.smem_bytes, plan.grid[0], stream)
        else:
            fn = _c_entry("bn_relu_matmul", "mxtt_bn_relu_matmul",
                          [ctypes.c_int] + [ctypes.c_void_p] * 5
                          + [ctypes.c_longlong] + [ctypes.c_int] * 3
                          + [ctypes.c_void_p])
            rc = fn(_KERNEL_DTYPES[x.dtype], *ptrs, m, k, n,
                    int(bool(relu)), stream)
    _launch_rc("bn_relu_matmul", rc)
    return out


bn_relu_matmul_fwd.launches = 0


# ---------------------------------------------------------------------------
# B1 / B2: the BN backward's reduction and dx assembly
# ---------------------------------------------------------------------------
def _bcs(t):
    """(B, C, S) of a contiguous NCHW or row-major (M, K) tensor, and its
    strides in that view."""
    if t.dim() == 4:
        b, c, h, w = t.shape
        return (b, c, h * w), (c * h * w, h * w, 1)
    return (t.shape[0], t.shape[1], 1), (t.shape[1], 1, 1)


def _masked(dxhat, xhat):
    """``dz = dxhat * [xhat > 0]`` in fp32 (``dxhat`` when xhat is None)."""
    dz = dxhat.float()
    return dz if xhat is None else torch.where(xhat > 0, dz, 0.0)


def bn_backward_reduce_plain(dxhat, x, xhat=None):
    """Plain PyTorch version of B1: (2, C) fp32 sums over every axis but
    the channel one (axis 1): row 0 ``sum dz``, row 1 ``sum dz*x``."""
    with torch.no_grad():
        axes = tuple(i for i in range(x.dim()) if i != 1)
        dz = _masked(dxhat, xhat)
        return torch.stack([dz.sum(dim=axes),
                            (dz * x.float()).sum(dim=axes)])


def bn_backward_reduce(dxhat, x, xhat=None):
    """Per-channel ``s0 = sum dz`` and ``s1 = sum dz*x`` of the BN
    backward, ``dz = dxhat * [xhat > 0]`` (``xhat`` None: no ReLU, dz =
    dxhat), as a (2, C) fp32 tensor. The tensors share one shape: NCHW
    (sums over B, H, W) or a row-major (M, K) matrix (sums over M). On
    CUDA: the Triton kernel (contiguous tensors; x and xhat float32 or
    bfloat16 in one dtype, dxhat in that dtype or float32); on CPU: the
    plain version."""
    ts = (dxhat, x) + ((xhat,) if xhat is not None else ())
    if any(t.shape != x.shape for t in ts) or x.dim() not in (2, 4):
        raise MXNetError(f"bn_backward_reduce: shapes "
                         f"{[tuple(t.shape) for t in ts]} differ or are not "
                         "NCHW or (M, K)")
    if _plain_device(x):
        return bn_backward_reduce_plain(dxhat, x, xhat)
    _check_cuda("bn_backward_reduce", x, ts[2:], _KERNEL_DTYPES)
    _check_dxhat("bn_backward_reduce", dxhat, x)
    (b, c, s), strides = _bcs(x)
    out = torch.zeros((2, c), dtype=torch.float32, device=x.device)
    if x.numel():
        from ..kernels import bn_backward_triton
        with _on_device(x.device):
            bn_backward_triton.launch_reduce(dxhat, x, xhat, b, c, s,
                                             strides, out)
        _count("bn_backward_reduce", x.device)
    return out


bn_backward_reduce.launches = 0


def bn_backward_dx_plain(dxhat, x, xhat, scale, cx=None, c0=None):
    """Plain PyTorch version of B2: ``dx = dz*scale[c] + x*cx[c] +
    c0[c]`` in fp32 (``dz*scale`` alone without cx/c0), rounded to
    ``x.dtype``; channels on axis 1."""
    with torch.no_grad():
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dx = _masked(dxhat, xhat) * scale.float().reshape(shape)
        if cx is not None:
            dx = dx + x.float() * cx.float().reshape(shape) \
                + c0.float().reshape(shape)
        return dx.to(x.dtype)


def bn_backward_dx(dxhat, x, xhat, scale, cx=None, c0=None):
    """The BN backward's dx: ``dz*scale[c] + x*cx[c] + c0[c]`` with
    ``dz = dxhat * [xhat > 0]`` (``xhat`` None: no ReLU), in x's dtype;
    without ``cx``/``c0`` (moving statistics, or ``bn_relu_matmul``) it
    is ``dz*scale`` and x is not read. Tensors NCHW or row-major (M, K),
    channels on axis 1; ``scale``/``cx``/``c0`` fp32 (C,). On CUDA: the
    Triton kernel (contiguous tensors; x and xhat float32 or bfloat16 in
    one dtype, dxhat in that dtype or float32); on CPU: the plain
    version."""
    ts = (dxhat, x) + ((xhat,) if xhat is not None else ())
    c = x.shape[1] if x.dim() >= 2 else -1
    coefs = (scale,) + ((cx, c0) if cx is not None else ())
    if any(t.shape != x.shape for t in ts) or x.dim() not in (2, 4) \
            or any(v.shape != (c,) for v in coefs):
        raise MXNetError(f"bn_backward_dx: shapes "
                         f"{[tuple(t.shape) for t in ts + coefs]} do not "
                         "fit NCHW or (M, K) tensors and (C,) coefficients")
    if _plain_device(x):
        return bn_backward_dx_plain(dxhat, x, xhat, scale, cx, c0)
    _check_cuda("bn_backward_dx", x, ts[2:], _KERNEL_DTYPES)
    _check_dxhat("bn_backward_dx", dxhat, x)
    _check_cuda("bn_backward_dx", scale, coefs[1:], {torch.float32: 0})
    if scale.device != x.device:
        raise MXNetError(f"bn_backward_dx: tensors on {scale.device} and "
                         f"{x.device}")
    out = torch.empty_like(x)
    if x.numel():
        from ..kernels import bn_backward_triton
        s = x.shape[2] * x.shape[3] if x.dim() == 4 else 1
        with _on_device(x.device):
            bn_backward_triton.launch_dx(dxhat, x, xhat, scale, cx, c0, out,
                                         c, s)
        _count("bn_backward_dx", x.device)
    return out


bn_backward_dx.launches = 0

_WRAPPERS = (bn_relu_conv_nchw, bn_act_prologue, bn_relu_matmul_fwd,
             bn_backward_reduce, bn_backward_dx)
# kernel wrappers of other ops modules that count through ``_count``
# (``ops/decode_attention.py``); ``launch_counts`` keeps to the five above
_OTHER_WRAPPERS = {}


def register_wrapper(fn):
    """Let the kernel wrapper ``fn`` of another ops module count its
    launches through ``_count`` (and a capture's tally), in
    ``fn.launches``, zeroed by ``reset_launch_counts``."""
    fn.launches = 0
    _OTHER_WRAPPERS[fn.__name__] = fn
    return fn


def reset_launch_counts():
    """Set every kernel wrapper's launch count, and K1's and K3's counts
    per route, to 0."""
    with _count_lock:
        for f in _WRAPPERS + tuple(_OTHER_WRAPPERS.values()):
            f.launches = 0
        for counts in _ROUTE_COUNTS.values():
            for r in counts:
                counts[r] = 0


def launch_counts():
    """{wrapper name: launches since the last reset}."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def route_counts():
    """{K1 / K3 wrapper name: {route: launches since the last reset}}
    (routes as in ``KernelPlan.route``)."""
    return {k: dict(v) for k, v in _ROUTE_COUNTS.items()}


def counter_state():
    """Every launch counter as one flat dict: ``{wrapper name: n}`` and
    ``{"<wrapper name>/<route>": n}``."""
    out = launch_counts()
    for name, counts in _ROUTE_COUNTS.items():
        out.update({f"{name}/{r}": n for r, n in counts.items()})
    return out


def add_counts(delta, times=1):
    """Add ``times`` x ``delta`` (keys as ``counter_state``'s) to the
    launch counters."""
    wrappers = dict(_OTHER_WRAPPERS, **{f.__name__: f for f in _WRAPPERS})
    with _count_lock:
        for key, n in delta.items():
            name, _, route = key.partition("/")
            if route:
                _ROUTE_COUNTS[name][route] += times * n
            else:
                wrappers[name].launches += times * n


# ---------------------------------------------------------------------------
# bn_relu_matmul: K3 with the JAX package's custom VJP
# ---------------------------------------------------------------------------
class _BNReLUMatmul(torch.autograd.Function):
    """``_fused_matmul``'s custom VJP (pallas_fused.py:294-310): raw
    inputs saved, the normalised activation recomputed in backward."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, relu):
        ctx.relu = relu
        ctx.save_for_backward(x, w, scale, shift)
        return bn_relu_matmul_fwd(x, w, scale, shift, relu)

    @staticmethod
    def backward(ctx, g):
        x, w, scale, shift = ctx.saved_tensors
        relu = ctx.relu
        m, k = x.shape
        xhat = bn_act_prologue(x.reshape(m, k, 1, 1), scale, shift,
                               relu).reshape(m, k)
        # both products take x.dtype operands to fp32 results, as the
        # JAX package's preferred_element_type=float32: dxhat reaches B1
        # and B2 unrounded
        g = g.to(x.dtype).float()
        dxhat = torch.matmul(g, w.to(x.dtype).float().t())
        mask = xhat if relu else None
        s = bn_backward_reduce(dxhat, x, mask)
        dx = bn_backward_dx(dxhat, x, mask, scale.float())
        dw = torch.matmul(xhat.float().t(), g).to(w.dtype)
        return dx, dw, s[1].to(scale.dtype), s[0].to(scale.dtype), None


def bn_relu_matmul(x, w, scale, shift, bm=None, bn=None, relu=True):
    """``act(x * scale + shift) @ w`` without materialising the
    normalised activation (the fused forward is K3). x: (M, K); w:
    (K, N); scale/shift: (K,) — the folded BN parameters
    gamma/sqrt(var+eps) and beta - mu*scale.

    ``bm``/``bn`` are the TPU kernel's output tiles and keep its rule:
    by default the largest multiple-of-8 candidate that divides M / N,
    an explicit one must divide M / N, else ``ValueError``. The CUDA
    kernel has its own tiling and masks every edge, so the rule only
    keeps the API the JAX package's. Differentiable: the JAX package's
    custom VJP (normalised activation recomputed in the backward)."""
    m, k = x.shape
    n = w.shape[1]
    if bm is None:
        bm = next((c for c in _BM_CANDIDATES if m % c == 0), None)
        if bm is None:
            raise ValueError(
                f"bn_relu_matmul: no tile candidate divides M={m} "
                "(must be divisible by 8); pad the problem or pass an "
                "explicit bm")
    if bn is None:
        bn = next((c for c in _BN_CANDIDATES if n % c == 0), None)
        if bn is None:
            raise ValueError(
                f"bn_relu_matmul: no tile candidate divides N={n} "
                "(must be divisible by 8); pad the problem or pass an "
                "explicit bn")
    if m % bm or n % bn:
        raise ValueError(
            f"bn_relu_matmul needs M % bm == 0 and N % bn == 0 "
            f"(got M={m}, N={n}, bm={bm}, bn={bn}); pad the problem or "
            "pass smaller blocks — a truncated grid would leave output "
            "tiles uninitialized")
    return _BNReLUMatmul.apply(x, w, scale, shift, bool(relu))


# ---------------------------------------------------------------------------
# the graph ops: BN(+ReLU)+conv with the analytic fused BN backward
# ---------------------------------------------------------------------------
def _fold(gamma, beta, mean, var, eps, fix_gamma):
    """(scale, shift) in the params' dtype, as the JAX ops' ``fold``."""
    g = torch.ones_like(gamma) if fix_gamma else gamma
    scale = g * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def _conv_geometry(stride, pad, dilate, num_group):
    return (_tup(stride, 2) or (1, 1), _tup(pad, 2) or (0, 0),
            _tup(dilate, 2) or (1, 1), int(num_group or 1))


class _FusedBNConv(torch.autograd.Function):
    """Whole-op custom VJP of ``_FusedBNReLUConv`` (``geom`` None: the
    1x1 conv on K1) and ``_FusedBNReLUConvK`` (``geom`` = (stride, pad,
    dilate, groups): K2 then the convolution) — pallas_fused.py
    ``_fused_bn_conv_vjp`` :455 and ``_fused_bn_convk_vjp`` :552.
    Inputs (x, gamma, beta, moving_mean, moving_var, weight); outputs
    (out, mean, var) with batch statistics, else (out,) — the op returns
    the moving statistics itself. The running-statistics inputs take no
    gradient (aux states are not differentiated)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mm, mv, w, relu, batch_stats,
                fix_gamma, eps, geom):
        if batch_stats:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        else:
            mean, var = mm, mv
        scale, shift = _fold(gamma, beta, mean, var, eps, fix_gamma)
        sc, sh = scale.to(x.dtype), shift.to(x.dtype)
        if geom is None:
            out = bn_relu_conv_nchw(x, w.reshape(w.shape[0], x.shape[1]),
                                    sc, sh, relu=relu)
        else:
            stride, pad, dilate, groups = geom
            xhat = bn_act_prologue(x, sc, sh, relu=relu)
            out = F.conv2d(xhat, w, None, stride=stride, padding=pad,
                           dilation=dilate, groups=groups).to(x.dtype)
        # raw-input residuals only: xhat recomputes in backward
        ctx.save_for_backward(x, gamma, beta, mean, var, w)
        ctx.cfg = (relu, batch_stats, fix_gamma, eps, geom)
        ctx.set_materialize_grads(False)
        return (out, mean, var) if batch_stats else out

    @staticmethod
    def backward(ctx, g_out, g_mean=None, g_var=None):
        x, gamma, beta, mean, var, w = ctx.saved_tensors
        relu, batch_stats, fix_gamma, eps, geom = ctx.cfg
        if g_out is None:
            g_out = torch.zeros((), dtype=x.dtype, device=x.device)
        b, c, h, wd = x.shape
        n = b * h * wd
        scale, shift = _fold(gamma, beta, mean, var, eps, fix_gamma)
        xhat = bn_act_prologue(x, scale.to(x.dtype), shift.to(x.dtype),
                               relu=relu)
        stride, pad, dilate, groups = geom or ((1, 1), (0, 0), (1, 1), 1)
        w4 = w.reshape(w.shape[0], c, 1, 1) if geom is None else w
        out_shape = (b, w.shape[0]) + tuple(
            (hw + 2 * p - d * (k - 1) - 1) // s + 1
            for hw, p, d, k, s in zip((h, wd), pad, dilate, w4.shape[2:],
                                      stride))
        dxhat, dw4, _ = torch.ops.aten.convolution_backward(
            g_out.to(x.dtype).expand(out_shape).contiguous(), xhat,
            w4.to(x.dtype), None, list(stride), list(pad), list(dilate),
            False, [0, 0], groups, [True, True, False])
        mask = xhat if relu else None
        s0, s1 = bn_backward_reduce(dxhat, x, mask)
        meanf, varf = mean.float(), var.float()
        inv = torch.rsqrt(varf + eps)
        t = s1 - meanf * s0
        dbeta = s0.to(beta.dtype)
        dgamma = torch.zeros_like(gamma) if fix_gamma \
            else (t * inv).to(gamma.dtype)
        scf = scale.float()
        if batch_stats:
            # analytic training-mode dx in one pass, with the (usually
            # absent) cotangents of the mean/var outputs folded into the
            # same coefficients
            g_eff = 1.0 if fix_gamma else gamma.float()
            coef = g_eff * inv ** 3 * t / n
            cx = -coef
            c0 = (-scf * s0 + coef * meanf * n) / n
            if g_mean is not None:
                c0 = c0 + g_mean.float() / n
            if g_var is not None:
                cx = cx + 2.0 * g_var.float() / n
                c0 = c0 - 2.0 * meanf * g_var.float() / n
            dx = bn_backward_dx(dxhat, x, mask, scf, cx.contiguous(),
                                c0.contiguous())
        else:
            dx = bn_backward_dx(dxhat, x, mask, scf)
        return (dx, dgamma, dbeta, None, None, dw4.reshape(w.shape)
                .to(w.dtype), None, None, None, None, None)


def _fused_op(data, gamma, beta, moving_mean, moving_var, weight, bias,
              eps, fix_gamma, use_global_stats, act_type, no_bias,
              training, geom):
    batch_stats = bool(training) and not use_global_stats
    res = _FusedBNConv.apply(data, gamma, beta, moving_mean, moving_var,
                             weight.to(data.dtype), act_type == "relu",
                             batch_stats, bool(fix_gamma), float(eps), geom)
    out, mean, var = res if batch_stats else (res, moving_mean, moving_var)
    if not no_bias and bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out.to(data.dtype), mean, var


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
    then the convolution with the node's stride, pad, dilate and groups;
    the analytic fused BN backward. Returns (out, mean, var) like
    BatchNorm; ``momentum`` is consumed by the running-stat fold."""
    return _fused_op(data, gamma, beta, moving_mean, moving_var, weight,
                     bias, eps, fix_gamma, use_global_stats, act_type,
                     no_bias, training,
                     _conv_geometry(stride, pad, dilate, num_group))


@register_op("_FusedBNReLUConv", num_outputs=3)
def fused_bn_relu_conv(data, gamma, beta, moving_mean, moving_var, weight,
                       bias=None, eps=1e-3, momentum=0.9, fix_gamma=True,
                       use_global_stats=False, act_type="relu", axis=1,
                       num_filter=None, no_bias=True, training=False, **kw):
    """BatchNorm -> Activation(relu) -> Convolution(1x1/s1/p0) as one op
    (substituted by the pallas_fusion pass), carried by K1; the analytic
    fused BN backward. Returns (conv_out, mean, var) like BatchNorm."""
    return _fused_op(data, gamma, beta, moving_mean, moving_var, weight,
                     bias, eps, fix_gamma, use_global_stats, act_type,
                     no_bias, training, None)
