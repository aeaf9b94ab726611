"""Greedy NMS keep masks and greedy bipartite matching: the wrappers of N1
and M1 (``kernels/csrc/greedy_nms.cu``), their plans and plain versions.

The JAX package runs each as an on-device XLA loop:
``_greedy_nms_keep`` (``mxnet_tpu/ops/contrib.py:314-329``, under
``MultiBoxDetection``, ``box_nms`` and ``Proposal``), the loop of
``bipartite_matching`` (``mxnet_tpu/ops/surface.py:455-468``) and
MultiBoxTarget's L argmax rounds (``mxnet_tpu/ops/contrib.py:210-225``).
Plain PyTorch runs a loop step as a launch or more, so on CUDA tensors
``greedy_nms_keep`` launches N1, and ``bipartite_match`` (the walk over a
sorted order) and ``bipartite_rounds`` (the rounds, without a sort)
launch M1, or raise on what they do not take; CPU and meta tensors take
the plain versions. Each counts its launches through
``fused_bn_conv._count``.

``_n1_plan`` / ``_m1_plan`` decide the route, the group and grid and
the shared memory before a launch; the C entries check them. N1 on CUDA
first orders the valid boxes by a class key on the device (``n1_order``
or, up to 512 boxes, in its first kernel): its kernels then resolve each
(image, class) segment on its own. The plain versions the wrappers take
on the CPU compute the same bits in another order: N1's resolves the
boxes 64 at a time; M1's walk takes min(N, M)
rounds of "the first entry in order whose row and column are free and
whose score passes", which is the sequential loop's next match (an entry
that fails never passes later); its rounds are MultiBoxTarget's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import fused_bn_conv as _fb

__all__ = ["box_iou_corner", "greedy_nms_keep", "greedy_nms_keep_plain",
           "n1_order", "bipartite_match", "bipartite_match_plain",
           "bipartite_rounds", "bipartite_rounds_plain", "N1Plan", "M1Plan"]

_TB = 64                    # boxes a chunk (the kernel's TB)
_SMEM_MAX = 231424          # an H100 block's 227 KB less 1 KB
_N1_SEG_THREADS = 256       # n1_segments' block
_N1_STATIC = 16384          # the kernels' static shared memory, rounded up
_N1_RANK_MAX = 512          # boxes an image n1_prep orders itself
_N1_SWEEP_THREADS = 512     # n1_sweep's block
_N1_MASK_BUDGET = 64 << 20  # bytes of the "mask" route's IoU bits a launch
_N1_ROUTES = ("segments", "mask")
_N1_BLOCKS = 132 * 8        # blocks of 256 threads that fill an H100
_M1_WALK_THREADS = 512
_M1_ROUND_THREADS = 1024
_M1_TILE_A = 128            # anchors a column_tiles block
_M1_STATIC = 12288
# N1's sort keys: every NaN id one key, the invalid boxes last
_NAN_KEY, _INVALID_KEY = 0x7FFFFFFE, 0x7FFFFFFF


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
    route: str          # "plain" (CPU, meta), "segments" (a block a
    #                     segment) or "mask" (the IoU bits, then a
    #                     block's sweep an image)
    order: str          # "rank" (n1_prep ranks the keys) or "sort"
    group: int          # images a launch (the mask's bits up to 64 MB)
    per_image: int      # blocks an image's segments are dealt to
    threads: int        # the kernel's threads a block
    smem_bytes: int     # its dynamic shared memory: a flag a box of the
    #                     segment; the mask route's sweep two words a chunk


class M1Plan(NamedTuple):
    route: str          # "plain", "walk" (bipartite_match) or "rounds"
    #                     (bipartite_rounds), a block a matrix
    threads: int
    smem_bytes: int     # the match state: the matches, bitsets (walk);
    #                     the matches, the columns' bests, the anchors'
    #                     bits (rounds)


@functools.lru_cache(maxsize=256)
def _n1_plan(device, b, n, force_suppress=False):
    """N1's plan for ``b`` images of ``n`` boxes on ``device``: CPU and
    meta -> "plain". On CUDA, class-aware: a block a segment, the
    segments dealt to enough blocks to fill the card, all images in one
    launch. force_suppress (one segment an image): the IoU bits of the
    segment's upper triangle over the whole card, then a block's sweep,
    a launch for each group of images whose bits take up to 64 MB (an
    image whose bits alone take more, n * n / 8 bytes, a launch of its
    own). Up to 512 boxes an image, n1_prep orders them itself ("rank");
    beyond, ``n1_order``'s sort. Raises on what the kernels cannot
    take."""
    dev = torch.device(device)
    if dev.type in ("cpu", "meta"):
        return N1Plan("plain", "sort", b, 1, 0, 0)
    if dev.type != "cuda":
        raise MXNetError(f"greedy_nms_keep: unsupported device {dev}")
    if not 1 <= b <= 65535 or not 1 <= n < 2 ** 31 - 1:
        raise MXNetError(f"N1: {b} images of {n} boxes are out of the "
                         "kernels' grid")
    chunks = _fb._cdiv(n, _TB)
    order = "rank" if n <= _N1_RANK_MAX else "sort"
    if force_suppress:
        group = max(1, min(b, _N1_MASK_BUDGET // (n * chunks * 8)))
        plan = N1Plan("mask", order, group, 1, _N1_SWEEP_THREADS, 16 * chunks)
    else:
        plan = N1Plan("segments", order, b, min(_fb._cdiv(_N1_BLOCKS, b), n),
                      _N1_SEG_THREADS, chunks * _TB)
    if plan.smem_bytes + _N1_STATIC > _SMEM_MAX:
        raise MXNetError(f"N1: {n} boxes an image need {plan.smem_bytes} "
                         "bytes of shared memory a block, more than "
                         f"{_SMEM_MAX - _N1_STATIC}")
    return plan


@functools.lru_cache(maxsize=256)
def _m1_plan(device, b, n, m, mode="walk"):
    """M1's plan for ``b`` matrices of ``n x m`` on ``device``: the
    ``walk`` over a given order (``bipartite_match``) or MultiBoxTarget's
    ``rounds`` over an (anchors ``n``, ground truths ``m``) IoU matrix
    (``bipartite_rounds``)."""
    dev = torch.device(device)
    if dev.type in ("cpu", "meta"):
        return M1Plan("plain", 0, 0)
    if dev.type != "cuda":
        raise MXNetError(f"bipartite_match: unsupported device {dev}")
    if not 1 <= b < 2 ** 31 or not 1 <= n < 2 ** 24 or not 1 <= m < 2 ** 24:
        raise MXNetError(f"M1: {b} matrices of {n} x {m} are out of the "
                         "kernels' range (rows and columns below 2^24, "
                         "exact as float32 matches)")
    if mode == "walk":
        plan = M1Plan("walk", _M1_WALK_THREADS, 8 * min(n, m)
                      + 4 * (_fb._cdiv(n, 32) + _fb._cdiv(m, 32)))
    elif mode == "rounds":
        plan = M1Plan("rounds", _M1_ROUND_THREADS,
                      25 * m + 4 * _fb._cdiv(n, 32))
    else:
        raise MXNetError(f"M1: no mode {mode!r}")
    if plan.smem_bytes + _M1_STATIC > _SMEM_MAX:
        raise MXNetError(f"M1: {n} x {m} needs {plan.smem_bytes} bytes of "
                         "match state, more than a block's shared memory")
    return plan


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


def n1_order(ids, valid, force_suppress):
    """The order N1 takes each image's boxes in (B, N) int64: the valid
    boxes first, grouped by class id (one group under
    ``force_suppress``), each group in the boxes' own order. A stable
    sort of an int32 key: the id's bits with -0.0 made 0.0 (the two are
    one class) and every NaN one key (each NaN box is then a segment of
    its own: NaN equals no id), the invalid boxes a key above all. Runs
    on the device with no host sync, so a capture takes it."""
    if force_suppress:
        key = (~valid).to(torch.uint8)
    else:
        bits = (ids + 0.0).view(torch.int32)
        key = torch.where(valid, torch.where(torch.isnan(ids), _NAN_KEY,
                                             bits), _INVALID_KEY)
    return torch.sort(key, dim=1, stable=True).indices


def greedy_nms_keep(boxes, ids, valid, thresh, force_suppress):
    """``greedy_nms_keep_plain``'s keep mask. On CUDA: N1 (the class
    ordering, then n1_prep and n1_segments, or n1_mask + n1_sweep a group
    of images at a time), with boxes and ids float32, valid bool, all
    contiguous on one device, boxes 16-byte aligned; on CPU and meta: the
    plain version."""
    _check_nms(boxes, ids, valid)
    b, n = boxes.shape[0], boxes.shape[1]
    if not b * n:
        return valid.clone()
    if boxes.device.type == "meta":          # shape inference
        return torch.empty_like(valid)
    plan = _n1_plan(boxes.device, b, n, bool(force_suppress))
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
    if _fb._align(boxes) < 16:
        raise MXNetError("greedy_nms_keep: boxes must be 16-byte aligned")
    dev, g = boxes.device, plan.group
    if plan.order == "rank":
        order = torch.empty((b, n), dtype=torch.int64, device=dev)
    else:
        order = n1_order(ids, valid, force_suppress)
    # a group's gathered boxes; its segment table, segment counts, flags
    sbox = torch.empty((g, n, 4), dtype=torch.float32, device=dev)
    table = torch.empty(g * (n + 3), dtype=torch.int32, device=dev)
    mask = torch.empty((g, n, _fb._cdiv(n, _TB)) if plan.route == "mask"
                       else 0, dtype=torch.int64, device=dev)
    keep = torch.empty((b, n), dtype=torch.bool, device=dev)
    with _fb._on_device(dev):
        fn = _fb._c_entry("greedy_nms", "mxtt_nms_segments",
                          [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                          + [ctypes.c_float] + [ctypes.c_int] * 6
                          + [ctypes.c_void_p])
        for i0 in range(0, b, g):
            gi = min(g, b - i0)
            rc = fn(boxes.data_ptr() + 16 * i0 * n,
                    ids.data_ptr() + 4 * i0 * n, valid.data_ptr() + i0 * n,
                    order.data_ptr() + 8 * i0 * n, sbox.data_ptr(),
                    table.data_ptr(), table.data_ptr() + 4 * gi * (n + 1),
                    keep.data_ptr() + i0 * n, mask.data_ptr(), gi, n,
                    float(thresh), int(bool(force_suppress)),
                    int(plan.order == "rank"), _N1_ROUTES.index(plan.route),
                    plan.per_image, plan.threads, plan.smem_bytes,
                    _fb._stream_handle(dev))
            _fb._launch_rc("greedy_nms_keep", rc)
            _fb._count("greedy_nms_keep", dev)
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
    plan = _m1_plan(scores.device, b, n, m) if b else M1Plan("plain", 0, 0)
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
        fn = _fb._c_entry("greedy_nms", "mxtt_bipartite_walk",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                          + [ctypes.c_longlong] * 2
                          + [ctypes.c_float] + [ctypes.c_int] * 3
                          + [ctypes.c_void_p])
        rc = fn(scores.data_ptr(), order.data_ptr(), row.data_ptr(),
                col.data_ptr(), b, n, m, order.shape[1], k,
                float(threshold), int(bool(is_ascend)), plan.threads,
                plan.smem_bytes, _fb._stream_handle(scores.device))
    _fb._launch_rc("bipartite_match", rc)
    _fb._count("bipartite_match", scores.device)
    return row, col


def bipartite_rounds_plain(iou):
    """MultiBoxTarget's greedy global matching, L rounds over ``iou`` (B,
    A, L): each round takes the first largest entry of the free anchors
    and ground truths and matches it when above 1e-6. Returns (matched
    (B, A), match_gt (B, A) int64, -1 where not, match_iou (B, A))."""
    b, a, l = iou.shape
    dev = iou.device
    bi = torch.arange(b, device=dev)
    a_used = torch.zeros((b, a), dtype=torch.bool, device=dev)
    g_used = torch.zeros((b, l), dtype=torch.bool, device=dev)
    m_gt = torch.full((b, a), -1, dtype=torch.int64, device=dev)
    m_iou = torch.full((b, a), -1.0, dtype=iou.dtype, device=dev)
    for _ in range(l):
        masked = torch.where(a_used[:, :, None] | g_used[:, None, :],
                             -1.0, iou).reshape(b, a * l)
        flat = torch.argmax(masked, dim=1)
        ai, gi = flat // l, flat % l
        val = masked[bi, flat]
        ok = val > 1e-6
        a_used[bi, ai] = a_used[bi, ai] | ok
        g_used[bi, gi] = g_used[bi, gi] | ok
        m_gt[bi, ai] = torch.where(ok, gi, m_gt[bi, ai])
        m_iou[bi, ai] = torch.where(ok, val, m_iou[bi, ai])
    return a_used, m_gt, m_iou


def bipartite_rounds(iou):
    """``bipartite_rounds_plain``'s matches. On CUDA: M1's rounds mode,
    with ``iou`` float32 (B, A, L) contiguous; on CPU and meta: the plain
    version."""
    if iou.dim() != 3:
        raise MXNetError(f"bipartite_rounds: iou {tuple(iou.shape)} is not "
                         "(B, A, L)")
    b, a, l = iou.shape
    dev = iou.device
    if dev.type == "meta":                   # shape inference
        return (torch.empty((b, a), dtype=torch.bool, device=dev),
                torch.empty((b, a), dtype=torch.int64, device=dev),
                torch.empty((b, a), dtype=iou.dtype, device=dev))
    plan = _m1_plan(dev, b, a, l, "rounds") if b * a * l \
        else M1Plan("plain", 0, 0)
    if plan.route == "rounds" and b > 65535:
        raise MXNetError(f"bipartite_rounds: {b} matrices are more than "
                         "the kernels' grid takes")
    if plan.route == "plain":
        return bipartite_rounds_plain(iou)
    if iou.dtype != torch.float32 or not iou.is_contiguous():
        raise MXNetError(f"bipartite_rounds: iou {iou.dtype} is not "
                         "supported on CUDA (float32, contiguous)")
    # each tile's best anchor of each column (value, anchor)
    part = torch.empty(2 * b * _fb._cdiv(a, _M1_TILE_A) * l,
                       dtype=torch.int32, device=dev)
    matched = torch.empty((b, a), dtype=torch.bool, device=dev)
    m_gt = torch.empty((b, a), dtype=torch.int64, device=dev)
    m_iou = torch.empty((b, a), dtype=torch.float32, device=dev)
    with _fb._on_device(dev):
        fn = _fb._c_entry("greedy_nms", "mxtt_bipartite_rounds",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p])
        rc = fn(iou.data_ptr(), part.data_ptr(), matched.data_ptr(),
                m_gt.data_ptr(), m_iou.data_ptr(), b, a, l, plan.threads,
                plan.smem_bytes, _fb._stream_handle(dev))
    _fb._launch_rc("bipartite_rounds", rc)
    _fb._count("bipartite_rounds", dev)
    return matched, m_gt, m_iou


_fb.register_wrapper(greedy_nms_keep)
_fb.register_wrapper(bipartite_match)
_fb.register_wrapper(bipartite_rounds)
