"""Contrib detection and vision operators (counterpart of
``mxnet_tpu/ops/contrib.py``, all of it but ``CTCLoss``, which
``ops/nn.py`` carries): the SSD MultiBox family, ``box_nms``, FFT,
``Correlation``, ``Crop``, the RPN ``Proposal`` / ``MultiProposal``,
``count_sketch``, ``DeformableConvolution`` and the PSROI pooling family.

Each op takes the JAX package's name, aliases, attributes and layouts
and computes its function in the same order of operations, batched over
the JAX package's ``vmap`` axes. The greedy NMS of ``MultiBoxDetection``,
``box_nms`` and ``Proposal`` is N1 on CUDA, and ``MultiBoxTarget``'s
L-round bipartite matching M1's rounds mode (``ops/nms.py``); the rest is
plain PyTorch, ``MultiBoxTarget``'s hard-negative mining (a double sort)
among it. Every sort reproduces ``jnp.argsort``'s stable order, and nothing
reads a value on the host or copies one to the device, so each op runs
inside a captured program. Constants made from attributes (anchor sizes,
variances, base anchors) are built on the device from Python scalars.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register_op
from .nms import bipartite_rounds, box_iou_corner, greedy_nms_keep

_f32 = torch.float32


def _tuplef(v, default):
    """Attr coercion: tuples arrive as python sequences or MXNet-style
    '(a,b)' strings (symbol JSON)."""
    if v is None:
        return tuple(default)
    if isinstance(v, str):
        v = v.strip("()[] ")
        return tuple(float(x) for x in v.split(",") if x.strip())
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def _consts(values, device):
    """A float32 tensor of the Python scalars ``values`` on ``device``,
    made by fills on CUDA (a capture refuses a host-to-device copy)."""
    values = [float(v) for v in values]
    if torch.device(device).type != "cuda":
        return torch.tensor(values, dtype=_f32, device=device)
    return torch.stack([torch.full((), v, dtype=_f32, device=device)
                        for v in values])


def _rows(x, idx):
    """``x[b, idx[b, i]]`` over the trailing axes of ``x`` (B, N, ...)."""
    shape = idx.shape + x.shape[2:]
    full = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, full)


def _stable_order(key):
    """``jnp.argsort(key, axis=-1)``: ascending, ties in index order."""
    return torch.sort(key, dim=-1, stable=True).indices


# ---------------------------------------------------------------------------
# SSD MultiBox family + box_nms
# ---------------------------------------------------------------------------
@register_op("MultiBoxPrior", aliases=["_contrib_MultiBoxPrior"], no_grad=True)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5), **kw):
    """SSD anchors of a feature map: data (N, C, H, W) -> (1, H*W*K, 4)
    corner boxes, K = num_sizes - 1 + num_ratios, ordered [all sizes at
    ratio 1, then ratios[1:] at sizes[0]] per location."""
    sizes = _tuplef(sizes, (1.0,))
    ratios = _tuplef(ratios, (1.0,))
    steps = _tuplef(steps, (-1.0, -1.0))
    offsets = _tuplef(offsets, (0.5, 0.5))
    H, W = int(data.shape[2]), int(data.shape[3])
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, dtype=_f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(W, dtype=_f32, device=dev) + offsets[1]) * step_x
    ws = [s * H / W / 2 for s in sizes] + \
         [sizes[0] * H / W * (r ** 0.5) / 2 for r in ratios[1:]]
    hs = [s / 2 for s in sizes] + \
         [sizes[0] / (r ** 0.5) / 2 for r in ratios[1:]]
    wh = _consts(ws + hs, dev)
    k = len(ws)
    w, h = wh[:k], wh[k:]
    cxg = cx[None, :, None].expand(H, W, k)
    cyg = cy[:, None, None].expand(H, W, k)
    boxes = torch.stack([cxg - w, cyg - h, cxg + w, cyg + h], dim=-1)
    boxes = boxes.reshape(1, H * W * k, 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes.to(data.dtype)


def _encode_loc(anchors, gt):
    """Box regression targets of ``gt`` against ``anchors`` (..., 4);
    the variances are divided out by the caller."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    eps = 1e-12
    return torch.stack([
        (gx - ax) / torch.clamp_min(aw, eps),
        (gy - ay) / torch.clamp_min(ah, eps),
        torch.log(torch.clamp_min(gw, eps) / torch.clamp_min(aw, eps)),
        torch.log(torch.clamp_min(gh, eps) / torch.clamp_min(ah, eps)),
    ], dim=-1)


@register_op("MultiBoxTarget", aliases=["_contrib_MultiBoxTarget"],
             no_grad=True, num_outputs=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2), **kw):
    """SSD training targets. anchor (1, A, 4); label (B, L, 5+) rows
    [cls, xmin, ymin, xmax, ymax], -1-padded; cls_pred (B, C, A).
    Returns (loc_target (B, A*4), loc_mask (B, A*4), cls_target (B, A))."""
    variances = _tuplef(variances, (0.1, 0.1, 0.2, 0.2))
    overlap_threshold = float(overlap_threshold)
    negative_mining_ratio = float(negative_mining_ratio)
    anchors = anchor.reshape(-1, 4)
    b, l = label.shape[0], label.shape[1]
    a = anchors.shape[0]
    dev = anchors.device
    valid = label[:, :, 0] > -0.5
    iou = box_iou_corner(anchors[None], label[:, :, 1:5])      # (B, A, L)
    iou = torch.where(valid[:, None, :], iou, -1.0)

    # stage 1: greedy global bipartite matching, at most L rounds
    matched, match_gt, match_iou = bipartite_rounds(iou)

    # stage 2: per-anchor threshold matching for still-unmatched anchors
    best_gt = torch.argmax(iou, dim=2)
    best_iou = torch.amax(iou, dim=2)
    match_gt = torch.where(matched, match_gt, best_gt)
    match_iou = torch.where(matched, match_iou, best_iou)
    if overlap_threshold > 0:
        thr_pos = ~matched & (best_iou > overlap_threshold)
    else:
        thr_pos = torch.zeros_like(matched)
    positive = matched | thr_pos
    num_pos = positive.sum(dim=1)

    # negatives: hard-negative mining by background prob, or everything
    if negative_mining_ratio > 0:
        x = cls_pred - torch.amax(cls_pred, dim=1, keepdim=True)
        e = torch.exp(x)
        prob = (e / torch.sum(e, dim=1, keepdim=True))[:, 0]  # bg prob (B, A)
        cand = ~positive & (match_iou < negative_mining_thresh)
        num_neg = torch.minimum(
            torch.clamp_min((num_pos * negative_mining_ratio)
                            .to(torch.int32),
                            int(minimum_negative_samples)), a - num_pos)
        score = torch.where(cand, -prob, float("-inf"))
        order = _stable_order(-score)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(a, device=dev).expand(b, a))
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive

    gt_idx = torch.clamp(match_gt, 0, max(l - 1, 0))
    picked = _rows(label, gt_idx)                                # (B, A, 5+)
    cls_target = torch.where(
        positive, picked[..., 0] + 1.0,
        torch.where(negative, 0.0, float(ignore_label)))
    enc = _encode_loc(anchors[None], picked[..., 1:5]) \
        / _consts(variances, dev)
    loc_target = torch.where(positive[..., None], enc, 0.0).reshape(b, a * 4)
    loc_mask = positive[..., None].expand(b, a, 4).to(enc.dtype) \
        .reshape(b, a * 4)
    return loc_target, loc_mask, cls_target


def _decode_boxes(anchors, loc_pred, variances, clip):
    """Corner boxes from the regression output ``loc_pred`` (..., A, 4)
    and ``anchors`` (A, 4)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    p = loc_pred
    ox = p[..., 0] * variances[0] * aw + ax
    oy = p[..., 1] * variances[1] * ah + ay
    ow = torch.exp(p[..., 2] * variances[2]) * aw * 0.5
    oh = torch.exp(p[..., 3] * variances[3]) * ah * 0.5
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


def _nms_first(boxes, ids, valid, thresh, force_suppress, topk):
    """``greedy_nms_keep`` where every row from ``topk`` on (when 0 <
    topk < N) is invalid: such a row is never kept and so suppresses
    nothing, and a row is suppressed only by earlier rows, so NMS over
    the first ``topk`` rows with the rest padded False gives the same
    bits, and a (topk x topk) suppression mask in place of (N x N)."""
    n = boxes.shape[1]
    if not 0 < topk < n:
        return greedy_nms_keep(boxes.contiguous(), ids.contiguous(), valid,
                               thresh, force_suppress)
    keep = greedy_nms_keep(boxes[:, :topk].contiguous(),
                           ids[:, :topk].contiguous(),
                           valid[:, :topk].contiguous(), thresh,
                           force_suppress)
    return torch.cat([keep, keep.new_zeros(keep.shape[0], n - topk)], 1)


@register_op("MultiBoxDetection", aliases=["_contrib_MultiBoxDetection"],
             no_grad=True)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1, **kw):
    """Detections with per-class NMS. cls_prob (B, C, A) softmax class
    probabilities (class 0 = background); loc_pred (B, A*4); anchor (1,
    A, 4). Output (B, A, 6) rows [class_id, score, xmin, ymin, xmax,
    ymax] by descending score, suppressed and invalid rows -1."""
    variances = _tuplef(variances, (0.1, 0.1, 0.2, 0.2))
    if int(background_id) != 0:
        raise NotImplementedError("MultiBoxDetection: background_id must "
                                  "be 0 (class 0 is background)")
    nms_threshold, nms_topk = float(nms_threshold), int(nms_topk)
    anchors = anchor.reshape(-1, 4)
    b, _, a = cls_prob.shape
    fg = cls_prob[:, 1:, :]
    cid = torch.argmax(fg, dim=1).to(_f32)
    score = torch.amax(fg, dim=1)
    valid = score >= float(threshold)
    boxes = _decode_boxes(anchors, loc_pred.reshape(b, a, 4), variances,
                          bool(clip))
    order = _stable_order(-torch.where(valid, score, float("-inf")))
    cid, score, valid = (torch.gather(t, 1, order)
                         for t in (cid, score, valid))
    boxes = _rows(boxes, order)
    if nms_topk > 0:
        valid = valid & (torch.arange(a, device=valid.device) < nms_topk)
    if 0 < nms_threshold <= 1:
        keep = _nms_first(boxes, cid, valid, nms_threshold,
                          bool(force_suppress), nms_topk)
    else:
        keep = valid
    row = torch.cat([cid[..., None], score[..., None], boxes], dim=-1)
    return torch.where(keep[..., None], row, -1.0)


@register_op("box_nms", aliases=["_contrib_box_nms", "box_non_maximum_suppression",
                                 "_contrib_box_non_maximum_suppression"],
             no_grad=True)
def box_nms(data, overlap_thresh=0.5, topk=-1, coord_start=2, score_index=1,
            id_index=-1, force_suppress=False, in_format="corner",
            out_format="corner", valid_thresh=0.0, **kw):
    """Non-maximum suppression over (..., N, K) box records: sorted by
    descending score, suppressed and invalid records -1; a record with
    score <= valid_thresh is invalid."""
    shape = data.shape
    n, k = shape[-2], shape[-1]
    flat = data.reshape(-1, n, k)
    cs, si, ii = int(coord_start), int(score_index), int(id_index)
    score = flat[..., si]
    valid = score > valid_thresh
    boxes = flat[..., cs:cs + 4]
    if in_format == "center":
        cxy, wh = boxes[..., :2], boxes[..., 2:]
        boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)
    ids = flat[..., ii] if ii >= 0 else torch.zeros_like(score)
    order = _stable_order(-torch.where(valid, score, float("-inf")))
    d_s, boxes_s = _rows(flat, order), _rows(boxes, order)
    ids_s, valid_s = torch.gather(ids, 1, order), torch.gather(valid, 1, order)
    if int(topk) > 0:
        valid_s = valid_s & (torch.arange(n, device=data.device) < int(topk))
    keep = _nms_first(boxes_s, ids_s, valid_s, float(overlap_thresh),
                      bool(force_suppress) or ii < 0, int(topk))
    out = d_s
    if out_format == "center" and in_format == "corner":
        bx = d_s[..., cs:cs + 4]
        out = torch.cat([d_s[..., :cs], (bx[..., :2] + bx[..., 2:]) / 2,
                         bx[..., 2:] - bx[..., :2], d_s[..., cs + 4:]],
                        dim=-1)
    elif out_format == "corner" and in_format == "center":
        out = torch.cat([d_s[..., :cs], boxes_s, d_s[..., cs + 4:]], dim=-1)
    return torch.where(keep[..., None], out, -1.0).reshape(shape)


# ---------------------------------------------------------------------------
# FFT / IFFT: output layout interleaved [re, im] per element
# ---------------------------------------------------------------------------
@register_op("fft", aliases=["_contrib_fft"])
def fft(data, compute_size=128, **kw):
    """Real (..., d) -> (..., 2d): the unnormalized FFT along the last
    axis, real and imaginary parts interleaved."""
    spec = torch.fft.fft(data.to(_f32), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)) \
        .to(data.dtype)


@register_op("ifft", aliases=["_contrib_ifft"])
def ifft(data, compute_size=128, **kw):
    """Interleaved (..., 2d) -> real (..., d), unnormalized (x d)."""
    d = data.shape[-1] // 2
    pairs = data.reshape(data.shape[:-1] + (d, 2)).to(_f32)
    spec = torch.complex(pairs[..., 0], pairs[..., 1])
    return (torch.fft.ifft(spec, dim=-1).real * d).to(data.dtype)


# ---------------------------------------------------------------------------
# Correlation (the FlowNet cost volume) and Crop
# ---------------------------------------------------------------------------
@register_op("Correlation")
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True, **kw):
    """Patch correlation of two NCHW maps: (n, G*G, top_h, top_w), G =
    2 * (max_displacement // stride2) + 1, each displacement's window
    products (or absolute differences) summed over channels and the
    window and divided by their count."""
    kernel_size = int(kernel_size)
    max_displacement = int(max_displacement)
    stride1, stride2, pad_size = int(stride1), int(stride2), int(pad_size)
    n, c, h, w = data1.shape
    kernel_radius = (kernel_size - 1) // 2
    border = max_displacement + kernel_radius
    padded_h, padded_w = h + 2 * pad_size, w + 2 * pad_size
    top_h = int(np.ceil((padded_h - border * 2) / float(stride1)))
    top_w = int(np.ceil((padded_w - border * 2) / float(stride1)))
    grid_radius = max_displacement // stride2
    grid_width = 2 * grid_radius + 1
    sumelems = kernel_size * kernel_size * c
    pads = (pad_size,) * 4
    p1, p2 = F.pad(data1, pads), F.pad(data2, pads)

    def window(p, y0, x0):
        return p[:, :, y0:y0 + (top_h - 1) * stride1 + 1:stride1,
                 x0:x0 + (top_w - 1) * stride1 + 1:stride1]

    outs = []
    for tc in range(grid_width * grid_width):
        s2o = (tc % grid_width - grid_radius) * stride2
        s2p = (tc // grid_width - grid_radius) * stride2
        acc = 0.0
        for kh in range(kernel_size):
            for kw_ in range(kernel_size):
                a = window(p1, max_displacement + kh, max_displacement + kw_)
                b = window(p2, max_displacement + s2p + kh,
                           max_displacement + s2o + kw_)
                acc = acc + (a * b if is_multiply else torch.abs(a - b))
        outs.append(acc.sum(dim=1) / sumelems)
    return torch.stack(outs, dim=1)


@register_op("Crop", num_outputs=1)
def crop_op(*inputs, offset=(0, 0), h_w=(0, 0), center_crop=False,
            num_args=None, **kw):
    """Crop an NCHW tensor to h_w or to the size of a second input."""
    data = inputs[0]
    if len(inputs) > 1:
        out_h, out_w = inputs[1].shape[2], inputs[1].shape[3]
    else:
        out_h, out_w = (int(x) for x in _tuplef(h_w, (0, 0)))
    if center_crop:
        o_h = (data.shape[2] - out_h) // 2
        o_w = (data.shape[3] - out_w) // 2
    else:
        o_h, o_w = (int(x) for x in _tuplef(offset, (0, 0)))
    return data[:, :, o_h:o_h + out_h, o_w:o_w + out_w]


# ---------------------------------------------------------------------------
# RPN Proposal / MultiProposal
# ---------------------------------------------------------------------------
def _generate_base_anchors(feature_stride, scales, ratios):
    """The reference's GenerateAnchors (proposal-inl.h:184-223), with its
    floor and round quirks, as the JAX package computes it: float32
    (len(ratios) * len(scales), 4)."""
    base = [0.0, 0.0, feature_stride - 1.0, feature_stride - 1.0]
    w = base[2] - base[0] + 1.0
    h = base[3] - base[1] + 1.0
    x_ctr = base[0] + 0.5 * (w - 1.0)
    y_ctr = base[1] + 0.5 * (h - 1.0)
    size = w * h
    anchors = []
    for ratio in ratios:
        size_ratio = np.floor(size / ratio)
        new_w = np.floor(np.sqrt(size_ratio) + 0.5)
        new_h = np.floor(new_w * ratio + 0.5)
        for scale in scales:
            sw, sh = new_w * scale, new_h * scale
            anchors.append([x_ctr - 0.5 * (sw - 1), y_ctr - 0.5 * (sh - 1),
                            x_ctr + 0.5 * (sw - 1), y_ctr + 0.5 * (sh - 1)])
    return np.asarray(anchors, np.float32)


def _clip_to(x, hi):
    """``jnp.clip(x, 0, hi)`` with a tensor bound."""
    return torch.minimum(torch.clamp_min(x, 0), hi)


@register_op("Proposal", aliases=["_contrib_Proposal"], no_grad=True,
             num_outputs=1)
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False, **kw):
    """RPN region proposals. cls_prob (B, 2A, H, W) softmax bg/fg;
    bbox_pred (B, 4A, H, W); im_info (B, 3) [height, width, scale].
    Each image: shifted anchors, decoded and clipped deltas, small boxes
    scored -1, the pre-NMS top boxes by score, greedy NMS (N1), the kept
    boxes first (the first kept one repeated to fill). Output rois
    (B * rpn_post_nms_top_n, 5) rows [batch_idx, x1, y1, x2, y2] (and
    their scores (B * post, 1) with output_score)."""
    if iou_loss:
        raise NotImplementedError("Proposal: iou_loss=True")
    scales = _tuplef(scales, (4, 8, 16, 32))
    ratios = _tuplef(ratios, (0.5, 1, 2))
    fs = float(feature_stride)
    pre, post = int(rpn_pre_nms_top_n), int(rpn_post_nms_top_n)
    base_np = _generate_base_anchors(fs, scales, ratios)
    bsz, _, H, W = cls_prob.shape
    A = base_np.shape[0]
    dev = cls_prob.device
    base = _consts(base_np.reshape(-1).tolist(), dev).reshape(A, 4)
    shift_x = torch.arange(W, dtype=_f32, device=dev) * fs
    shift_y = torch.arange(H, dtype=_f32, device=dev) * fs
    # anchor layout index = h*(W*A) + w*A + a
    sx = shift_x[None, :, None].expand(H, W, A)
    sy = shift_y[:, None, None].expand(H, W, A)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)
    anchors = (base[None, None] + shifts).reshape(-1, 4)
    d = bbox_pred.reshape(bsz, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(bsz, -1, 4)
    s = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(bsz, -1)

    widths = anchors[:, 2] - anchors[:, 0] + 1.0
    heights = anchors[:, 3] - anchors[:, 1] + 1.0
    ctr_x = anchors[:, 0] + 0.5 * (widths - 1.0)
    ctr_y = anchors[:, 1] + 0.5 * (heights - 1.0)
    pred_ctr_x = d[..., 0] * widths + ctr_x
    pred_ctr_y = d[..., 1] * heights + ctr_y
    pred_w = torch.exp(d[..., 2]) * widths
    pred_h = torch.exp(d[..., 3]) * heights
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    x1 = _clip_to(pred_ctr_x - 0.5 * (pred_w - 1), im_w - 1)
    y1 = _clip_to(pred_ctr_y - 0.5 * (pred_h - 1), im_h - 1)
    x2 = _clip_to(pred_ctr_x + 0.5 * (pred_w - 1), im_w - 1)
    y2 = _clip_to(pred_ctr_y + 0.5 * (pred_h - 1), im_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    # filter too-small boxes (the reference's FilterBox: score -> -1)
    iw = x2 - x1 + 1.0
    ih = y2 - y1 + 1.0
    min_size = float(rpn_min_size) * im_info[:, 2:3]
    s = torch.where((iw < min_size) | (ih < min_size), -1.0, s)

    order = _stable_order(-s)
    if pre > 0:
        order = order[:, :pre]
    boxes_s, s_s = _rows(boxes, order), torch.gather(s, 1, order)
    valid = s_s > -1.0
    keep = greedy_nms_keep(boxes_s, torch.zeros_like(s_s), valid,
                           float(threshold), True)
    # kept boxes to the front in their order, padded with the first kept
    # one; with none kept, index -1 wraps to the last box, as in jnp
    rank = _stable_order((~keep).to(torch.uint8))
    boxes_k, score_k = _rows(boxes_s, rank), torch.gather(s_s, 1, rank)
    n_keep = keep.sum(dim=1)
    idx = torch.minimum(torch.arange(post, device=dev)[None],
                        n_keep[:, None] - 1)
    idx = torch.where(idx < 0, idx + boxes_s.shape[1], idx)
    rois = _rows(boxes_k, idx)
    roi_scores = torch.gather(score_k, 1, idx)
    batch_col = torch.arange(bsz, dtype=_f32, device=dev)[:, None, None] \
        .expand(bsz, post, 1).to(rois.dtype)
    out = torch.cat([batch_col, rois], dim=-1).reshape(bsz * post, 5)
    if output_score:
        return out, roi_scores.reshape(bsz * post, 1)
    return out


@register_op("MultiProposal", aliases=["_contrib_MultiProposal"],
             no_grad=True)
def multi_proposal(cls_prob, bbox_pred, im_info, **kw):
    """Proposal over every image of the batch (rois only)."""
    kw.pop("output_score", None)
    return proposal(cls_prob, bbox_pred, im_info, output_score=False, **kw)


# ---------------------------------------------------------------------------
# count_sketch
# ---------------------------------------------------------------------------
@register_op("count_sketch", aliases=["_contrib_count_sketch"])
def count_sketch(data, h, s, out_dim=None, processing_batch_size=32, **kw):
    """Count sketch projection: out[n, h[i]] += s[i] * data[n, i]. data
    (n, in_dim); h (1, in_dim) bucket ids (truncated to integers; ids
    out of [0, out_dim) drop their terms); s (1, in_dim) signs. On CUDA
    the sums are atomic, in no fixed order."""
    if out_dim is None:
        raise ValueError("count_sketch requires out_dim")
    out_dim = int(out_dim)
    n = data.shape[0]
    hh = h.reshape(-1).to(torch.int64)
    ss = s.reshape(-1).to(data.dtype)
    signed = data * ss[None, :]
    inside = (hh >= 0) & (hh < out_dim)
    out = torch.zeros((n, out_dim), dtype=data.dtype, device=data.device)
    return out.index_add(1, torch.clamp(hh, 0, max(out_dim - 1, 0)),
                         torch.where(inside[None, :], signed, 0.0))


# ---------------------------------------------------------------------------
# Deformable convolution (DCN v1): offset layout [dg][2*(i*Kw+j)] with the
# h-offset first, sample = (h_in + i*dil + off_h, w_in + j*dil + off_w),
# zero outside the image; gradients through autograd
# ---------------------------------------------------------------------------
def _bilinear_sample(img, ys, xs):
    """Bilinear samples of ``img`` (N, C, H, W) at float positions ``ys``,
    ``xs`` (N, oh, ow) -> (N, C, oh, ow). Each of the four corners
    outside the image contributes zero."""
    n, c, h, w = img.shape
    oh, ow = ys.shape[1:]
    flat = img.reshape(n, c, h * w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    dy = ys - y0
    dx = xs - x0
    out = 0.0
    for cy, wy in ((y0, 1 - dy), (y0 + 1, dy)):
        for cx, wx in ((x0, 1 - dx), (x0 + 1, dx)):
            valid = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            yi = torch.clamp(cy, 0, h - 1).to(torch.int64)
            xi = torch.clamp(cx, 0, w - 1).to(torch.int64)
            idx = (yi * w + xi).reshape(n, 1, oh * ow).expand(n, c, oh * ow)
            v = torch.gather(flat, 2, idx).reshape(n, c, oh, ow)
            out = out + torch.where(valid, wy * wx, 0.0)[:, None] * v
    return out


@register_op("DeformableConvolution",
             aliases=["_contrib_DeformableConvolution"])
def deformable_convolution(data, offset, weight, bias=None, kernel=None,
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=0, num_group=1,
                           num_deformable_group=1, no_bias=False, **kw):
    """Deformable convolution: data (N, C, H, W), offset (N, 2*dg*kh*kw,
    oh, ow), weight (F, C/groups, kh, kw). The sampled columns (N, C,
    kh*kw, oh, ow) are gathered in full, then one grouped product."""
    kh, kw = (int(k) for k in _tuplef(kernel, (3, 3)))
    sh, sw = (int(v) for v in _tuplef(stride, (1, 1)))
    dh, dw = (int(v) for v in _tuplef(dilate, (1, 1)))
    ph, pw = (int(v) for v in _tuplef(pad, (0, 0)))
    groups, dg = int(num_group), int(num_deformable_group)
    n, c, h, w = data.shape
    oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    off = offset.reshape(n, dg, kh * kw, 2, oh, ow)
    h_in = torch.arange(oh, device=data.device) * sh - ph
    w_in = torch.arange(ow, device=data.device) * sw - pw
    cpg = c // dg
    cols = []
    for tap in range(kh * kw):
        i, j = tap // kw, tap % kw
        cols.append(torch.cat([_bilinear_sample(
            data[:, g * cpg:(g + 1) * cpg],
            h_in[:, None] + i * dh + off[:, g, tap, 0],
            w_in[None, :] + j * dw + off[:, g, tap, 1])
            for g in range(dg)], dim=1))                # (N, C, oh, ow)
    col = torch.stack(cols, dim=2)                      # (N, C, kh*kw, oh, ow)
    f = weight.shape[0]
    cg, fg = c // groups, f // groups
    out = torch.cat([
        torch.matmul(weight[g * fg:(g + 1) * fg].reshape(fg, cg * kh * kw),
                     col[:, g * cg:(g + 1) * cg].reshape(
                         n, cg * kh * kw, oh * ow))
        for g in range(groups)], dim=1).reshape(n, f, oh, ow)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# ---------------------------------------------------------------------------
# Position-sensitive ROI pooling (R-FCN family)
# ---------------------------------------------------------------------------
def _roi_batch(rois, b):
    """Each roi's image: its first column as an integer, wrapped once when
    negative and clamped (jnp's gather)."""
    idx = rois[:, 0].to(torch.int64)
    return torch.clamp(torch.where(idx < 0, idx + b, idx), 0, b - 1)


@register_op("PSROIPooling", aliases=["_contrib_PSROIPooling"])
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=None,
                  pooled_size=None, group_size=0, **kw):
    """Position-sensitive ROI pooling: data (B, output_dim*G*G, H, W),
    rois (R, 5) -> (R, output_dim, pooled, pooled), each bin the mean of
    its position-sensitive channel over the bin's integer grid cells (0
    for an empty bin)."""
    G = int(group_size) or int(pooled_size)
    P, D = int(pooled_size), int(output_dim)
    ss = float(spatial_scale)
    b, _, H, W = data.shape
    dev = data.device
    ps = data.reshape(b, D, G, G, H, W)
    bidx = _roi_batch(rois, b)
    r = torch.arange(rois.shape[0], device=dev)
    start_w = torch.floor(rois[:, 1] + 0.5) * ss
    start_h = torch.floor(rois[:, 2] + 0.5) * ss
    end_w = (torch.floor(rois[:, 3] + 0.5) + 1.0) * ss
    end_h = (torch.floor(rois[:, 4] + 0.5) + 1.0) * ss
    bin_h = torch.clamp_min(end_h - start_h, 0.1) / P
    bin_w = torch.clamp_min(end_w - start_w, 0.1) / P
    hs = torch.arange(H, dtype=data.dtype, device=dev)
    ws = torch.arange(W, dtype=data.dtype, device=dev)
    rows = []
    for ph in range(P):
        hstart = torch.clamp(torch.floor(ph * bin_h + start_h), 0, H)
        hend = torch.clamp(torch.ceil((ph + 1) * bin_h + start_h), 0, H)
        mh = ((hs >= hstart[:, None]) & (hs < hend[:, None])).to(data.dtype)
        row = []
        for pw in range(P):
            wstart = torch.clamp(torch.floor(pw * bin_w + start_w), 0, W)
            wend = torch.clamp(torch.ceil((pw + 1) * bin_w + start_w), 0, W)
            mw = ((ws >= wstart[:, None]) & (ws < wend[:, None])) \
                .to(data.dtype)
            gh = min(max(ph * G // P, 0), G - 1)
            gw = min(max(pw * G // P, 0), G - 1)
            sel = ps[:, :, gh, gw]                      # (B, D, H, W)
            total = torch.einsum("bdhw,rh,rw->rbd", sel, mh, mw)[r, bidx]
            area = torch.clamp_min(mh.sum(1) * mw.sum(1), 1)
            empty = (hend <= hstart) | (wend <= wstart)
            row.append(torch.where(empty[:, None], 0.0,
                                   total / area[:, None]))
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)                    # (R, D, P, P)


@register_op("DeformablePSROIPooling",
             aliases=["_contrib_DeformablePSROIPooling"])
def deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                             output_dim=None, group_size=None,
                             pooled_size=None, part_size=0,
                             sample_per_part=4, trans_std=0.0,
                             no_trans=False, **kw):
    """Deformable position-sensitive ROI pooling: each bin the mean of
    its S x S bilinear samples that fall inside the map, shifted by the
    bin's normalized offsets ``trans`` (R, num_classes*2, part, part) x
    trans_std x the roi's size."""
    P, D, G = int(pooled_size), int(output_dim), int(group_size)
    part = int(part_size) or P
    S = int(sample_per_part)
    ss, tstd = float(spatial_scale), float(trans_std)
    if no_trans:
        trans = None
    num_classes = trans.shape[1] // 2 if trans is not None else 1
    b, C, H, W = data.shape
    dev = data.device
    R = rois.shape[0]
    bidx = _roi_batch(rois, b)
    start_w = torch.floor(rois[:, 1] + 0.5) * ss - 0.5
    start_h = torch.floor(rois[:, 2] + 0.5) * ss - 0.5
    end_w = (torch.floor(rois[:, 3] + 0.5) + 1.0) * ss - 0.5
    end_h = (torch.floor(rois[:, 4] + 0.5) + 1.0) * ss - 0.5
    roi_w = torch.clamp_min(end_w - start_w, 0.1)
    roi_h = torch.clamp_min(end_h - start_h, 0.1)
    bin_h = roi_h / P
    bin_w = roi_w / P
    sub_h = bin_h / S
    sub_w = bin_w / S

    pidx = torch.arange(P, device=dev)
    if trans is None:
        tx = torch.zeros((R, D, P, P), dtype=data.dtype, device=dev)
        ty = tx
    else:
        cls_per = D // num_classes
        part_i = pidx * part // P
        cls = torch.arange(D, device=dev) // cls_per
        tsel = trans[:, :, part_i][:, :, :, part_i]     # (R, 2nc, P, P)
        tx = tsel[:, cls * 2] * tstd                    # (R, D, P, P)
        ty = tsel[:, cls * 2 + 1] * tstd
    si = torch.arange(S, device=dev)
    r6 = lambda t: t.reshape(R, 1, 1, 1, 1, 1)          # noqa: E731
    # sample positions (R, D, P, P, S, S)
    hpos = (pidx.reshape(1, 1, P, 1, 1, 1) * r6(bin_h) + r6(start_h)
            + ty[..., None, None] * r6(roi_h)
            + si.reshape(1, 1, 1, 1, S, 1) * r6(sub_h))
    wpos = (pidx.reshape(1, 1, 1, P, 1, 1) * r6(bin_w) + r6(start_w)
            + tx[..., None, None] * r6(roi_w)
            + si.reshape(1, 1, 1, 1, 1, S) * r6(sub_w))
    shape = (R, D, P, P, S, S)
    hpos, wpos = hpos.expand(shape), wpos.expand(shape)
    ok = (wpos >= -0.5) & (wpos <= W - 0.5) & (hpos >= -0.5) \
        & (hpos <= H - 0.5)
    hc = torch.clamp(hpos, 0.0, H - 1.0)
    wc = torch.clamp(wpos, 0.0, W - 1.0)
    h0 = torch.floor(hc)
    w0 = torch.floor(wc)
    dh = hc - h0
    dw = wc - w0
    h0i, w0i = h0.to(torch.int64), w0.to(torch.int64)
    h1i = torch.clamp_max(h0i + 1, H - 1)
    w1i = torch.clamp_max(w0i + 1, W - 1)
    gh = torch.clamp(pidx * G // P, 0, G - 1)
    chan = (torch.arange(D, device=dev).reshape(D, 1, 1) * G
            + gh.reshape(1, P, 1)) * G + gh.reshape(1, 1, P)  # (D, P, P)
    base = ((bidx.reshape(R, 1, 1, 1) * C + chan) * H)[..., None, None]

    def at(hi, wi):
        return torch.take(data, (base + hi) * W + wi)

    v = (at(h0i, w0i) * (1 - dh) * (1 - dw)
         + at(h0i, w1i) * (1 - dh) * dw
         + at(h1i, w0i) * dh * (1 - dw)
         + at(h1i, w1i) * dh * dw)
    acc = torch.sum(torch.where(ok, v, 0.0), dim=(4, 5))
    cnt = torch.sum(ok, dim=(4, 5))
    return torch.where(cnt > 0, acc / torch.clamp_min(cnt, 1), 0.0)

