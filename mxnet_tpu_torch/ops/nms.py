"""Greedy NMS keep masks and greedy bipartite matching: the wrappers of N1
and M1 (``kernels/csrc/greedy_nms.cu``), their plans and plain versions.

The JAX package runs both as one on-device XLA ``while`` each:
``_greedy_nms_keep`` (``mxnet_tpu/ops/contrib.py:314-329``, under
``MultiBoxDetection``, ``box_nms`` and ``Proposal``) and the loop of
``bipartite_matching`` (``mxnet_tpu/ops/surface.py:455-468``). Plain
PyTorch runs a loop step as a launch or more, so on CUDA tensors
``greedy_nms_keep`` launches N1 and ``bipartite_match`` launches M1 (or
raise on what they do not take); CPU and meta tensors take the plain
versions. Each counts its launches through ``fused_bn_conv._count``.

``_n1_plan`` / ``_m1_plan`` decide the route, the words a mask row and
the sweep's shared memory before a launch; the C entries set their grids
from those. The plain versions compute the same bits in another
order: N1's resolves the boxes 64 at a time as the kernel does; M1's
takes min(N, M) rounds of "the first entry in order whose
row and column are free and whose score passes", which is the sequential
loop's next match (an entry that fails never passes later).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import fused_bn_conv as _fb

__all__ = ["box_iou_corner", "greedy_nms_keep", "greedy_nms_keep_plain",
           "bipartite_match", "bipartite_match_plain", "N1Plan", "M1Plan"]

_TB = 64                    # boxes a suppression word (the kernel's TB)
_SWEEP_THREADS = 512
_SMEM_MAX = 231424          # an H100 block's 227 KB less 1 KB


def box_iou_corner(a, b):
    """Pairwise IoU of corner boxes, ``(..., A, 4) x (..., B, 4) ->
    (..., A, B)``: the JAX package's ``_box_iou`` (contrib.py:128-138)
    operation for operation, 0 where the union is <= 0."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp_min(a[..., 2] - a[..., 0], 0) \
        * torch.clamp_min(a[..., 3] - a[..., 1], 0)
    area_b = torch.clamp_min(b[..., 2] - b[..., 0], 0) \
        * torch.clamp_min(b[..., 3] - b[..., 1], 0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


class N1Plan(NamedTuple):
    """How a greedy-NMS call runs, from device and shapes alone."""
    route: str          # "plain" (CPU, meta) or "cuda"
    words: int          # W = ceil(N / 64) suppression words a row
    threads: int        # nms_sweep's threads a block
    smem_bytes: int     # nms_sweep's dynamic shared memory (the bitset)


class M1Plan(NamedTuple):
    route: str          # "plain" or "cuda" (a warp a batch item)


@functools.lru_cache(maxsize=256)
def _n1_plan(device, b, n):
    """N1's plan for ``b`` images of ``n`` boxes on ``device``: CPU and
    meta -> "plain"; CUDA -> "cuda" with the bitset's shared memory; raises on what the kernel cannot take."""
    dev = torch.device(device)
    words = _fb._cdiv(max(n, 1), _TB)
    if dev.type in ("cpu", "meta"):
        return N1Plan("plain", words, 0, 0)
    if dev.type != "cuda":
        raise MXNetError(f"greedy_nms_keep: unsupported device {dev}")
    if not 1 <= b <= 65535 or not 1 <= n or words > 65535:
        raise MXNetError(f"N1: {b} images of {n} boxes are out of the "
                         "kernel's grid")
    smem = words * 8
    if smem > _SMEM_MAX:
        raise MXNetError(f"N1: {n} boxes need a {smem}-byte bitset, more "
                         f"than a block's {_SMEM_MAX} bytes")
    return N1Plan("cuda", words, _SWEEP_THREADS, smem)


@functools.lru_cache(maxsize=256)
def _m1_plan(device, b, n, m):
    """M1's plan for ``b`` score matrices of ``n x m`` on ``device``."""
    dev = torch.device(device)
    if dev.type in ("cpu", "meta"):
        return M1Plan("plain")
    if dev.type != "cuda":
        raise MXNetError(f"bipartite_match: unsupported device {dev}")
    if b < 1 or not 1 <= n < 2 ** 24 or not 1 <= m < 2 ** 24 \
            or b >= 2 ** 31:
        raise MXNetError(f"M1: {b} matrices of {n} x {m} are out of the "
                         "kernel's range (rows and columns below 2^24, "
                         "exact as float32 matches)")
    return M1Plan("cuda")


def _check_nms(boxes, ids, valid):
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or ids.shape != boxes.shape[:2] or valid.shape != boxes.shape[:2]:
        raise MXNetError(f"greedy_nms_keep: boxes {tuple(boxes.shape)}, ids "
                         f"{tuple(ids.shape)}, valid {tuple(valid.shape)} do "
                         "not fit (B, N, 4), (B, N), (B, N)")
    if valid.dtype != torch.bool:
        raise MXNetError(f"greedy_nms_keep: valid is {valid.dtype}, not bool")


def greedy_nms_keep_plain(boxes, ids, valid, thresh, force_suppress):
    """The keep mask of greedy NMS over score-sorted boxes: ``boxes`` (B,
    N, 4) corner format, class ``ids`` (B, N), ``valid`` (B, N) bool.
    Box j > i is suppressed by a kept box i when their IoU is >=
    ``thresh`` and their ids are equal (any ids under
    ``force_suppress``). The reference's loop in N1's order: chunks of 64
    boxes, each resolved box by box, then its kept boxes' suppressions
    of the later boxes applied at once (a later box decides nothing in
    the chunk, so deferring them changes no bit)."""
    _check_nms(boxes, ids, valid)
    n = boxes.shape[1]
    keep = valid.clone()
    idx = torch.arange(n, device=boxes.device)
    for r0 in range(0, n, _TB):
        r1 = min(r0 + _TB, n)
        # suppression rows r0..r1 over the columns from r0 on
        sup = (box_iou_corner(boxes[:, r0:r1], boxes[:, r0:]) >= thresh) \
            & (idx[None, r0:] > idx[r0:r1, None])
        if not force_suppress:
            sup = sup & (ids[:, r0:r1, None] == ids[:, None, r0:])
        blk = keep[:, r0:r1]
        for i in range(r1 - r0):
            blk = blk & ~(blk[:, i, None] & sup[:, i, :r1 - r0])
        keep[:, r0:r1] = blk
        if r1 < n:
            keep[:, r1:] &= ~(blk[:, :, None] & sup[:, :, r1 - r0:]).any(1)
    return keep


def greedy_nms_keep(boxes, ids, valid, thresh, force_suppress):
    """``greedy_nms_keep_plain``'s keep mask. On CUDA: N1, with boxes and
    ids float32, valid bool, all contiguous on one device; on CPU and
    meta: the plain version."""
    _check_nms(boxes, ids, valid)
    b, n = boxes.shape[0], boxes.shape[1]
    if not b * n:
        return valid.clone()
    if boxes.device.type == "meta":          # shape inference
        return torch.empty_like(valid)
    plan = _n1_plan(boxes.device, b, n)
    if plan.route == "plain":
        return greedy_nms_keep_plain(boxes, ids, valid, thresh,
                                     force_suppress)
    if boxes.dtype != torch.float32 or ids.dtype != torch.float32:
        raise MXNetError(f"greedy_nms_keep: boxes {boxes.dtype}, ids "
                         f"{ids.dtype} are not supported on CUDA (float32)")
    if any(t.device != boxes.device for t in (ids, valid)):
        raise MXNetError("greedy_nms_keep: tensors on more than one device")
    if not all(t.is_contiguous() for t in (boxes, ids, valid)):
        raise MXNetError("greedy_nms_keep: inputs must be contiguous")
    mask = torch.empty((b, n, plan.words), dtype=torch.int64,
                       device=boxes.device)
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    with _fb._on_device(boxes.device):
        fn = _fb._c_entry("greedy_nms", "mxtt_nms_keep",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                          + [ctypes.c_float] + [ctypes.c_int] * 3
                          + [ctypes.c_void_p])
        rc = fn(boxes.data_ptr(), ids.data_ptr(), valid.data_ptr(),
                mask.data_ptr(), keep.data_ptr(), b, n, plan.words,
                float(thresh), int(bool(force_suppress)), plan.threads,
                plan.smem_bytes, _fb._stream_handle(boxes.device))
    _fb._launch_rc("greedy_nms_keep", rc)
    _fb._count("greedy_nms_keep", boxes.device)
    return keep


def _check_match(scores, order, n, m, k):
    if scores.dim() != 2 or scores.shape[1] != n * m or order.dim() != 2 \
            or order.shape[0] != scores.shape[0] \
            or not 0 <= k <= order.shape[1] <= n * m:
        raise MXNetError(f"bipartite_match: scores {tuple(scores.shape)}, "
                         f"order {tuple(order.shape)}, k {k} do not fit "
                         f"(B, {n} * {m}), (B, K >= k)")


def bipartite_match_plain(scores, order, n, m, k, threshold, is_ascend):
    """Greedy matching on the flat score matrices ``scores`` (B, n * m),
    visiting the entries ``order[:, :k]`` (flat indices) in turn: an
    entry (r, c) matches when row r and column c are unmatched and its
    score is below (``is_ascend``) or above ``threshold``. Returns
    (row_match (B, n), col_match (B, m)) float32, -1 where unmatched."""
    _check_match(scores, order, n, m, k)
    b, dev = scores.shape[0], scores.device
    row = torch.full((b, n), -1.0, dtype=torch.float32, device=dev)
    col = torch.full((b, m), -1.0, dtype=torch.float32, device=dev)
    if not k:
        return row, col
    idx = order[:, :k]
    r, c = idx // m, idx % m
    s = torch.gather(scores, 1, idx)
    passes = (s < threshold) if is_ascend else (s > threshold)
    bi = torch.arange(b, device=dev)
    for _ in range(min(n, m)):
        free = passes & (torch.gather(row, 1, r) < 0) \
            & (torch.gather(col, 1, c) < 0)
        first = torch.argmax(free.to(torch.uint8), dim=1)
        ok = free[bi, first]
        fr, fc = r[bi, first], c[bi, first]
        row[bi, fr] = torch.where(ok, fc.to(torch.float32), row[bi, fr])
        col[bi, fc] = torch.where(ok, fr.to(torch.float32), col[bi, fc])
    return row, col


def bipartite_match(scores, order, n, m, k, threshold, is_ascend):
    """``bipartite_match_plain``'s matches. On CUDA: M1, with scores
    float32 and order int64, contiguous, on one device; on CPU and meta:
    the plain version."""
    _check_match(scores, order, n, m, k)
    b = scores.shape[0]
    if scores.device.type == "meta":         # shape inference
        return (torch.empty((b, n), dtype=torch.float32, device="meta"),
                torch.empty((b, m), dtype=torch.float32, device="meta"))
    plan = _m1_plan(scores.device, b, n, m) if b else M1Plan("plain")
    if plan.route == "plain":
        return bipartite_match_plain(scores, order, n, m, k, threshold,
                                     is_ascend)
    if scores.dtype != torch.float32 or order.dtype != torch.int64:
        raise MXNetError(f"bipartite_match: scores {scores.dtype}, order "
                         f"{order.dtype} are not supported on CUDA (float32,"
                         " int64)")
    if order.device != scores.device:
        raise MXNetError("bipartite_match: tensors on more than one device")
    if not (scores.is_contiguous() and order.is_contiguous()):
        raise MXNetError("bipartite_match: inputs must be contiguous")
    row = torch.empty((b, n), dtype=torch.float32, device=scores.device)
    col = torch.empty((b, m), dtype=torch.float32, device=scores.device)
    with _fb._on_device(scores.device):
        fn = _fb._c_entry("greedy_nms", "mxtt_bipartite_match",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                          + [ctypes.c_longlong] * 2
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        rc = fn(scores.data_ptr(), order.data_ptr(), row.data_ptr(),
                col.data_ptr(), b, n, m, order.shape[1], k,
                float(threshold), int(bool(is_ascend)),
                _fb._stream_handle(scores.device))
    _fb._launch_rc("bipartite_match", rc)
    _fb._count("bipartite_match", scores.device)
    return row, col


_fb.register_wrapper(greedy_nms_keep)
_fb.register_wrapper(bipartite_match)
