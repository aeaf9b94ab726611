"""The SSD box ops (MultiBoxPrior with clip, steps and offsets;
MultiBoxTarget with mining on and off, ignore_label and an item without
ground truth; MultiBoxDetection with threshold, nms_topk and
force_suppress; box_nms with id_index, topk, center in and out formats
and batched leading axes; box_iou in both formats; bipartite_matching
ascending and descending, with threshold and topk) against the JAX
package's, on the CPU, from the seeded inputs of ``ops/sweep.py``:
boxes, targets and IoUs at rtol 1e-5 / atol 1e-6 (box_iou's gradient at
1e-4), class ids, keep masks and matches exactly. Every case meets ties
(duplicate boxes, equal scores), and a few pinned ones check the tie
order itself. N1's and M1's plain versions (``ops/nms.py``), and the
kernels' decompositions written here in plain PyTorch (the class
segments, the chunks' rounds, M1's rounds by columns), equal a direct
numpy transcription of the reference loops (contrib.py:326-329,
surface.py:456-468, contrib.py:210-225), and ``_n1_plan`` / ``_m1_plan``
route a CUDA device to each kernel form and the CPU and meta devices to
the plain versions."""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nms, sweep
from mxnet_tpu_torch.ops.registry import get_op

from torch_ops_parity import assert_close, run_jax

BOX_TOL = dict(rtol=1e-5, atol=1e-6)


def _cases(backward):
    cases = [c for c in sweep.CASES if c.family == "contrib"
             and get_op(c.op).name in sweep.BOX_OPS]
    return [c for c in cases if c.grad_positions(c.inputs())] \
        if backward else cases


def _integral(outs):
    """Which outputs hold only integers (class ids, masks, matches:
    compared exactly)."""
    return [np.all(np.asarray(o) == np.round(np.asarray(o))) for o in outs]


@pytest.mark.parametrize("case", _cases(False), ids=lambda c: c.id)
def test_forward(case):
    ins = case.inputs()
    got, _ = sweep.run_port(case, ins, "cpu")
    want, _ = run_jax(case, ins)
    assert len(got) == len(want)
    for k, (g, w, exact) in enumerate(zip(got, want, _integral(want))):
        assert g.shape == w.shape and g.dtype == w.dtype, (case.id, k)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{case.id} {k}")
        else:
            np.testing.assert_allclose(g, w, err_msg=f"{case.id} {k}",
                                       **BOX_TOL)
    if get_op(case.op).name in ("MultiBoxDetection", "box_nms"):
        rows = got[0].reshape(-1, got[0].shape[-1])
        # the cases' duplicates are suppressed: some rows are -1
        assert (rows == -1).all(axis=1).any(), case.id


@pytest.mark.parametrize("case", _cases(True), ids=lambda c: c.id)
def test_backward(case):
    ins = case.inputs()
    _, got = sweep.run_port(case, ins, "cpu", cot_seed=1234)
    _, want = run_jax(case, ins, 1234)
    for pos, g, w in zip(case.grad_positions(ins), got, want):
        assert_close(g, w, 1e-4, f"{case.id} grad of input {pos}")


def _both(name, *arrays, **attrs):
    import jax.numpy as jnp
    import mxnet_tpu.ops  # noqa: F401
    from mxnet_tpu.ops.registry import get_op as jget
    p = get_op(name).fn(*[torch.from_numpy(a) for a in arrays], **attrs)
    j = jget(name).fn(*[jnp.asarray(a) for a in arrays], **attrs)
    p = p if isinstance(p, tuple) else (p,)
    j = j if isinstance(j, tuple) else (j,)
    return [t.numpy() for t in p], [np.asarray(t) for t in j]


def test_box_nms_tie_keeps_the_lower_index():
    """Two equal records of one class, equal scores: the first in index
    order is kept, the other suppressed; a third class-1 copy survives
    (class-aware), and a lower score sorts after them."""
    rec = np.array([[0, 0.5, 0.1, 0.1, 0.4, 0.4],
                    [0, 0.9, 0.2, 0.2, 0.6, 0.6],
                    [0, 0.9, 0.2, 0.2, 0.6, 0.6],
                    [1, 0.9, 0.2, 0.2, 0.6, 0.6]], np.float32)
    rec[0, 0] = 5.0     # a distinct class: not suppressed by the others
    got, want = _both("box_nms", rec, overlap_thresh=0.5, id_index=0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0][0], rec[1])
    np.testing.assert_array_equal(got[0][1], -np.ones(6, np.float32))
    np.testing.assert_array_equal(got[0][2], rec[3])
    np.testing.assert_array_equal(got[0][3], rec[0])


def test_detection_duplicate_anchors_keep_one():
    """Duplicate anchors with equal probabilities and offsets decode to
    one box: the first is kept, the copy is suppressed."""
    anchor = np.array([[[0.1, 0.1, 0.5, 0.5], [0.1, 0.1, 0.5, 0.5],
                        [0.6, 0.6, 0.9, 0.9]]], np.float32)
    prob = np.array([[[0.2, 0.2, 0.5], [0.7, 0.7, 0.1], [0.1, 0.1, 0.4]]],
                    np.float32)
    loc = np.zeros((1, 12), np.float32)
    got, want = _both("MultiBoxDetection", prob, loc, anchor,
                      nms_threshold=0.5, threshold=0.05)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][0, 0, 0] == 0 and (got[0][0, 1] == -1).all()
    assert got[0][0, 2, 0] == 1


def test_bipartite_descending_ties_take_the_higher_index():
    """All-equal scores: the reversed stable order visits the highest
    flat index first, so (1, 1) matches before (0, 0)."""
    data = np.full((2, 2), 0.9, np.float32)
    got, want = _both("bipartite_matching", data, threshold=0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], [0.0, 1.0])
    got, want = _both("bipartite_matching", data, threshold=0.95,
                      is_ascend=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], [0.0, 1.0])


def test_target_argmax_ties_take_the_first_anchor():
    """Two identical anchors on one ground truth: the bipartite round
    matches the first (the first flat argmax), the copy only by the
    threshold stage."""
    anchor = np.array([[[0.1, 0.1, 0.5, 0.5], [0.1, 0.1, 0.5, 0.5],
                        [0.6, 0.6, 0.9, 0.9]]], np.float32)
    label = np.array([[[1, 0.1, 0.1, 0.45, 0.45]]], np.float32)
    cls = np.zeros((1, 3, 3), np.float32)
    got, want = _both("MultiBoxTarget", anchor, label, cls,
                      overlap_threshold=0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **BOX_TOL)
    np.testing.assert_array_equal(got[2][0], [2.0, 0.0, 0.0])


# --- N1 / M1 plain versions against the reference loops, in numpy --------
def _np_iou(a, b):
    """contrib.py:128-138 in numpy float32."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(br - tl, np.float32(0))
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.maximum(a[:, 2] - a[:, 0], np.float32(0)) \
        * np.maximum(a[:, 3] - a[:, 1], np.float32(0))
    area_b = np.maximum(b[:, 2] - b[:, 0], np.float32(0)) \
        * np.maximum(b[:, 3] - b[:, 1], np.float32(0))
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(union > 0, inter / union, np.float32(0))


def _np_nms(boxes, ids, valid, thresh, force):
    """contrib.py:319-329: the fori_loop as a Python loop."""
    n = boxes.shape[0]
    iou = _np_iou(boxes, boxes)
    same = np.ones((n, n), bool) if force else ids[:, None] == ids[None, :]
    later = np.arange(n)[None, :] > np.arange(n)[:, None]
    sup = (iou >= np.float32(thresh)) & same & later
    keep = valid.copy()
    for i in range(n):
        keep = keep & ~(keep[i] & sup[i])
    return keep


def _np_match(score, order, n, m, k, thresh, ascend):
    """surface.py:455-468: the fori_loop as a Python loop."""
    row, col = -np.ones(n, np.float32), -np.ones(m, np.float32)
    for i in range(k):
        idx = order[i]
        r, c = idx // m, idx % m
        s = score[idx]
        ok = row[r] < 0 and col[c] < 0 and \
            (s < np.float32(thresh) if ascend else s > np.float32(thresh))
        if ok:
            row[r], col[c] = c, r
    return row, col


@pytest.mark.parametrize("seed", range(8))
def test_n1_plain_equals_reference_loop(seed):
    rs = np.random.RandomState(seed)
    b, n = 3, int(rs.randint(1, 150))
    xy = rs.uniform(0, 0.8, (b, n, 2)).astype(np.float32)
    wh = rs.uniform(0.0, 0.4, (b, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    dup = rs.rand(b, n) < 0.2
    boxes[dup] = boxes[:, :1].repeat(n, 1)[dup]
    ids = rs.randint(0, 3, (b, n)).astype(np.float32)
    valid = rs.rand(b, n) < 0.8
    thresh = float(rs.choice([0.3, 0.45, 0.5, 0.7]))
    for force in (False, True):
        got = nms.greedy_nms_keep_plain(torch.from_numpy(boxes),
                                        torch.from_numpy(ids),
                                        torch.from_numpy(valid), thresh,
                                        force).numpy()
        want = np.stack([_np_nms(boxes[i], ids[i], valid[i], thresh, force)
                         for i in range(b)])
        np.testing.assert_array_equal(got, want)
        wrapped = nms.greedy_nms_keep(torch.from_numpy(boxes),
                                      torch.from_numpy(ids),
                                      torch.from_numpy(valid), thresh, force)
        np.testing.assert_array_equal(wrapped.numpy(), want)


@pytest.mark.parametrize("topk", [1, 7, 64, 65, 149, 150, 400])
def test_nms_over_the_first_topk_rows_equals_the_full_loop(topk):
    """MultiBoxDetection and box_nms run N1 over the first ``topk`` rows
    only: the same bits as the reference loop over all rows with the
    rows from ``topk`` on invalid."""
    from mxnet_tpu_torch.ops.contrib import _nms_first
    rs = np.random.RandomState(topk)
    b, n = 2, 150
    xy = rs.uniform(0, 0.8, (b, n, 2)).astype(np.float32)
    wh = rs.uniform(0.0, 0.4, (b, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    ids = rs.randint(0, 3, (b, n)).astype(np.float32)
    valid = (rs.rand(b, n) < 0.8) & (np.arange(n) < topk)
    for force in (False, True):
        got = _nms_first(torch.from_numpy(boxes), torch.from_numpy(ids),
                         torch.from_numpy(valid), 0.45, force, topk)
        want = np.stack([_np_nms(boxes[i], ids[i], valid[i], 0.45, force)
                         for i in range(b)])
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(8))
def test_m1_plain_equals_reference_loop(seed):
    rs = np.random.RandomState(seed)
    b, n, m = 2, int(rs.randint(1, 12)), int(rs.randint(1, 12))
    score = np.round(rs.uniform(0, 1, (b, n * m)), 1).astype(np.float32)
    ascend = bool(seed % 2)
    order = np.argsort(score, axis=1, kind="stable")
    if not ascend:
        order = order[:, ::-1].copy()
    k = n * m if seed % 3 == 0 else min(2 * max(n, m), n * m)
    thresh = float(rs.choice([0.2, 0.5, 0.8]))
    got = nms.bipartite_match_plain(torch.from_numpy(score),
                                    torch.from_numpy(order), n, m, k,
                                    thresh, ascend)
    wrapped = nms.bipartite_match(torch.from_numpy(score),
                                  torch.from_numpy(order), n, m, k, thresh,
                                  ascend)
    for i in range(b):
        row, col = _np_match(score[i], order[i], n, m, k, thresh, ascend)
        for g in (got, wrapped):
            np.testing.assert_array_equal(g[0][i].numpy(), row)
            np.testing.assert_array_equal(g[1][i].numpy(), col)


def test_plans_route_by_device():
    """CPU and meta take the plain versions; CUDA each kernel form: N1
    class-aware a block a segment, dealt to ~1,056 blocks, all images in
    one launch; forced the mask and a sweep, a launch a group of images
    whose bits take up to 64 MB, or a launch an image where one image's
    bits take more; up to 512 boxes ordered in the kernel, beyond by the
    sort; M1's walk and rounds with their shared memory. What no kernel
    takes raises."""
    p = nms._n1_plan("cuda:0", 32, 8732)
    assert p == nms.N1Plan("segments", "sort", 32, 33, 256, 137 * 64)
    assert nms._n1_plan("cuda:0", 32, 320) == nms.N1Plan(
        "segments", "rank", 32, 33, 256, 5 * 64)
    assert nms._n1_plan("cuda:0", 1, 3) == nms.N1Plan(
        "segments", "rank", 1, 3, 256, 64)
    assert nms._n1_plan("cuda:0", 1, 6000, True) == nms.N1Plan(
        "mask", "sort", 1, 1, 512, 16 * 94)
    assert nms._n1_plan("cuda:0", 32, 320, True) == nms.N1Plan(
        "mask", "rank", 32, 1, 512, 16 * 5)
    # 8,732 boxes: 9.57 MB of bits an image, 7 images a launch
    assert nms._n1_plan("cuda:0", 32, 8732, True) == nms.N1Plan(
        "mask", "sort", 7, 1, 512, 16 * 137)
    # 30,000 boxes: 112.6 MB of bits for one image, a launch an image
    assert nms._n1_plan("cuda:0", 2, 30000, True) == nms.N1Plan(
        "mask", "sort", 1, 1, 512, 16 * 469)
    assert nms._n1_plan("cuda:0", 2, 512).order == "rank"
    assert nms._n1_plan("cuda:0", 2, 513).order == "sort"
    for dev in ("cpu", "meta", torch.device("cpu")):
        assert nms._n1_plan(dev, 32, 8732).route == "plain"
        assert nms._m1_plan(dev, 4, 8732, 50).route == "plain"
        assert nms._m1_plan(dev, 32, 8732, 50, "rounds").route == "plain"
    assert nms._m1_plan("cuda", 4, 8732, 50) == nms.M1Plan(
        "walk", 512, 8 * 50 + 4 * (273 + 2))
    assert nms._m1_plan("cuda", 32, 8732, 50, "rounds") == nms.M1Plan(
        "rounds", 1024, 25 * 50 + 4 * 273)
    assert nms._m1_plan("cuda", 16, 320, 1, "rounds").route == "rounds"
    with pytest.raises(MXNetError):
        nms._n1_plan("cuda:0", 1, 64 * (nms._SMEM_MAX - nms._N1_STATIC + 1))
    with pytest.raises(MXNetError):
        nms._n1_plan("cuda:0", 1, 64 * 13441, True)
    with pytest.raises(MXNetError):
        nms._n1_plan("cuda:0", 1, 2 ** 31)
    with pytest.raises(MXNetError):
        nms._n1_plan("cuda:0", 70000, 10)
    with pytest.raises(MXNetError):
        nms._m1_plan("cuda:0", 1, 2 ** 24, 3)
    with pytest.raises(MXNetError):
        nms._m1_plan("cuda:0", 1, 2 ** 23, 2 ** 23)
    with pytest.raises(MXNetError):
        nms._m1_plan("cuda:0", 1, 10, 10, "sorted")
    with pytest.raises(MXNetError):
        nms._n1_plan("mps", 1, 10)


@pytest.mark.parametrize("b, n", [(1, 6000), (32, 8732), (640, 1280),
                                  (3, 23168), (1, 23169), (65535, 7)])
def test_n1_mask_groups_fit_the_budget(b, n):
    """Forced suppression on CUDA takes the mask route a group of images
    at a time: the group's bits fit 64 MB and one image more would not
    (unless the group is every image); an image whose bits alone pass
    64 MB goes a launch of its own."""
    chunks = -(-n // 64)
    per = n * chunks * 8
    p = nms._n1_plan("cuda:0", b, n, True)
    assert p.route == "mask" and 1 <= p.group <= b
    if per > nms._N1_MASK_BUDGET:
        assert p.group == 1
        return
    assert p.group * per <= nms._N1_MASK_BUDGET
    assert p.group == b or (p.group + 1) * per > nms._N1_MASK_BUDGET
    assert nms._n1_plan("cuda:0", b, n, False).group == b


def test_meta_tensors_give_shapes():
    """Shape inference runs the ops on meta tensors: N1's and M1's
    wrappers give meta outputs of the right shapes and compute nothing."""
    keep = nms.greedy_nms_keep(torch.empty(2, 70, 4, device="meta"),
                               torch.empty(2, 70, device="meta"),
                               torch.empty(2, 70, dtype=torch.bool,
                                           device="meta"), 0.5, False)
    assert keep.shape == (2, 70) and keep.device.type == "meta"
    row, col = nms.bipartite_match(
        torch.empty(3, 20, device="meta"),
        torch.empty(3, 20, dtype=torch.int64, device="meta"), 4, 5, 20,
        0.5, False)
    assert row.shape == (3, 4) and col.shape == (3, 5)
    matched, gt, miou = nms.bipartite_rounds(
        torch.empty(3, 20, 4, device="meta"))
    assert matched.shape == gt.shape == miou.shape == (3, 20)
    assert matched.dtype == torch.bool and gt.dtype == torch.int64


# --- the decompositions of the redesigned kernels, in plain PyTorch -------
# N1's and M1's kernels take these steps on the card; each is written
# here in plain PyTorch and held against the numpy loops of the reference
TB = 64                     # boxes a chunk (the kernels' TB)


def _n1_segments_plain(ids, valid, order, force_suppress):
    """n1_prep's segment table, image by image: the (start, end) sorted
    positions of each run of valid boxes whose ids are equal (any ids
    under ``force_suppress``), a NaN id a run of its own."""
    out = []
    for i in range(ids.shape[0]):
        o = order[i].tolist()
        v = valid[i, order[i]].tolist()
        d = ids[i, order[i]].tolist()
        starts = [p for p in range(len(o)) if v[p] and (
            p == 0 or not v[p - 1]
            or (not force_suppress and not d[p] == d[p - 1]))]
        out.append(list(zip(starts, starts[1:] + [sum(v)])))
    return out


def _resolve_rounds(sup, cand):
    """N1's resolve of one chunk: ``sup`` (n, n) bool, the IoU
    bits of its rows (symmetric, the diagonal False), ``cand`` (n,) its
    boxes not yet removed. A round keeps every undecided box that no
    undecided earlier box suppresses and drops the later boxes the kept
    ones suppress."""
    n = cand.shape[0]
    idx = torch.arange(n)
    pred = sup & (idx[None, :] < idx[:, None])
    succ = sup & (idx[None, :] > idx[:, None])
    undec, kept = cand.clone(), torch.zeros_like(cand)
    while bool(undec.any()):
        new = undec & ~(pred & undec[None, :]).any(1)
        kept |= new
        undec &= ~new & ~(succ & new[:, None]).any(0)
    return kept


def _greedy_nms_segments_plain(boxes, ids, valid, thresh, force_suppress):
    """The keep mask as N1 computes it, in plain PyTorch: ``n1_order``,
    the segment table, each segment resolved 64 boxes at a time (the
    chunk's bits, the rounds, then the kept boxes against the later boxes
    not yet removed), the keep bits scattered back to the boxes' own
    positions."""
    keep = torch.zeros_like(valid)
    order = nms.n1_order(ids, valid, force_suppress)
    segs = _n1_segments_plain(ids, valid, order, force_suppress)
    for i, image in enumerate(segs):
        for s0, s1 in image:
            pos = order[i, s0:s1]
            sb = boxes[i, pos]
            removed = torch.zeros(s1 - s0, dtype=torch.bool)
            for c0 in range(0, s1 - s0, TB):
                c1 = min(c0 + TB, s1 - s0)
                cb = sb[c0:c1]
                sup = nms.box_iou_corner(cb, cb) >= thresh
                sup.fill_diagonal_(False)
                kept = _resolve_rounds(sup, ~removed[c0:c1])
                keep[i, pos[c0:c1][kept]] = True
                if c1 < s1 - s0:
                    hit = nms.box_iou_corner(cb[kept], sb[c1:]) >= thresh
                    removed[c1:] |= hit.any(0)
    return keep


def _first_max(v, idx):
    """The entry of ``v`` that ``torch.argmax`` takes (NaN first), and
    its index in ``idx``."""
    nan = torch.isnan(v)
    j = int(torch.nonzero(nan)[0]) if bool(nan.any()) \
        else int(torch.argmax(v))
    return v[j], int(idx[j])


def _bipartite_rounds_columns_plain(iou):
    """``bipartite_rounds_plain``'s result as M1's rounds mode finds it,
    in plain PyTorch: each ground truth keeps its best free anchor; the
    free columns sorted by (the value, the lower anchor, the lower
    column) are taken in turn as successive rounds until one whose anchor
    was taken in this batch, or a pick not above 1e-6, or min(A, L)
    matches; then the free columns whose anchor was taken are rescanned,
    but for those at or below 1e-6, which cannot match again (the
    kernel's batches up to 64 columns; beyond, it takes one column a
    batch, which picks the same)."""
    b, a, l = iou.shape
    matched = torch.zeros((b, a), dtype=torch.bool)
    m_gt = torch.full((b, a), -1, dtype=torch.int64)
    m_iou = torch.full((b, a), -1.0, dtype=iou.dtype)
    anchors = torch.arange(a)
    for i in range(b):
        free_a = torch.ones(a, dtype=torch.bool)
        free_l = [True] * l
        best = [_first_max(iou[i, :, j], anchors) for j in range(l)]
        matches, done = 0, False
        while not done:
            # NaN first, then the larger value, the lower anchor, column
            cols = sorted((j for j in range(l) if free_l[j]), key=lambda j: (
                not bool(torch.isnan(best[j][0])),
                -float(best[j][0]) if not torch.isnan(best[j][0]) else 0.0,
                best[j][1], j))
            done = not cols
            for j in cols:
                v, ai = best[j]
                if not bool(v > 1e-6):
                    done = True
                    break
                if not bool(free_a[ai]):
                    break
                matched[i, ai], m_gt[i, ai], m_iou[i, ai] = True, j, v
                free_a[ai], free_l[j] = False, False
                matches += 1
                if matches == min(a, l):
                    done = True
                    break
            for c in range(l):
                # a column at or below 1e-6 cannot match again: no rescan
                if not done and free_l[c] and not bool(free_a[best[c][1]]) \
                        and not bool(best[c][0] <= 1e-6):
                    best[c] = _first_max(iou[i, free_a, c], anchors[free_a])
    return matched, m_gt, m_iou


def _nms_inputs(rs, b, n, classes, dup=0.2, valid_p=0.8):
    xy = rs.uniform(0, 0.8, (b, n, 2)).astype(np.float32)
    wh = rs.uniform(0.0, 0.4, (b, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    src = (rs.rand(b, n) * np.arange(n)).astype(int)
    d = rs.rand(b, n) < dup
    boxes[d] = np.take_along_axis(boxes, src[..., None].repeat(4, -1), 1)[d]
    ids = rs.randint(0, classes, (b, n)).astype(np.float32)
    ids[d] = np.take_along_axis(ids, src, 1)[d]
    valid = rs.rand(b, n) < valid_p
    return boxes, ids, valid


def _segments_against_loop(boxes, ids, valid, thresh):
    for force in (False, True):
        got = _greedy_nms_segments_plain(
            torch.from_numpy(boxes), torch.from_numpy(ids),
            torch.from_numpy(valid), thresh, force).numpy()
        want = np.stack([_np_nms(boxes[i], ids[i], valid[i], thresh, force)
                         for i in range(boxes.shape[0])])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("classes", [1, 3, 21])
def test_n1_segments_equal_reference_loop(seed, classes):
    """N1's decomposition (the class ordering, the segments, 64-box chunks
    resolved in rounds, kept boxes against the later boxes not yet
    removed, the bits scattered back) equals the reference's loop: one
    class, a few, many; duplicates (box and class) and ties; some
    segments longer than a chunk."""
    rs = np.random.RandomState(100 + seed)
    n = int(rs.randint(1, 200))
    boxes, ids, valid = _nms_inputs(rs, 2, n, classes)
    thresh = float(rs.choice([0.3, 0.45, 0.5, 0.7]))
    _segments_against_loop(boxes, ids, valid, thresh)


@pytest.mark.parametrize("case", ["nan_ids", "signed_zero", "all_invalid",
                                  "one_box", "one_valid", "ragged_chunks",
                                  "at_threshold", "threshold_le_0"])
def test_n1_segments_edge_cases(case):
    """A NaN id is a segment of its own (it equals no id: it suppresses
    nothing and nothing suppresses it); -0.0 and 0.0 are one class; no
    valid box; N = 1; N not a multiple of 64; IoUs exactly at the
    threshold; a threshold <= 0, where pairs that do not overlap
    suppress too."""
    rs = np.random.RandomState(7)
    thresh = 0.45
    if case == "nan_ids":
        boxes, ids, valid = _nms_inputs(rs, 2, 90, 3, dup=0.5)
        ids[rs.rand(2, 90) < 0.3] = np.nan
    elif case == "signed_zero":
        boxes, ids, valid = _nms_inputs(rs, 2, 90, 2, dup=0.5)
        ids[(ids == 0) & (rs.rand(2, 90) < 0.5)] = -0.0
    elif case == "all_invalid":
        boxes, ids, valid = _nms_inputs(rs, 2, 70, 3)
        valid[:] = False
    elif case == "one_box":
        boxes, ids, valid = _nms_inputs(rs, 3, 1, 3, valid_p=0.6)
    elif case == "one_valid":
        boxes, ids, valid = _nms_inputs(rs, 2, 130, 3)
        valid[:] = False
        valid[:, 77] = True
    elif case == "ragged_chunks":
        boxes, ids, valid = _nms_inputs(rs, 2, 193, 1, dup=0.3,
                                        valid_p=1.0)
    elif case == "at_threshold":
        # unit squares sliding by 1/4: IoU 3/5 and 1/3, both exact in
        # float32 arithmetic here and on the card, at thresholds equal
        # to them
        x = np.arange(130, dtype=np.float32) * 0.25
        boxes = np.stack([x, np.zeros_like(x), x + 1, np.ones_like(x)],
                         -1)[None].astype(np.float32)
        ids = np.zeros((1, 130), np.float32)
        valid = np.ones((1, 130), bool)
        for t in (np.float32(0.6), np.float32(1) / np.float32(3)):
            _segments_against_loop(boxes, ids, valid, float(t))
        return
    else:
        boxes, ids, valid = _nms_inputs(rs, 2, 80, 3, dup=0.0)
        boxes[:, :, 2:] = boxes[:, :, :2] + 0.01
        thresh = 0.0
    _segments_against_loop(boxes, ids, valid, thresh)


def test_n1_order_groups_classes_in_score_order():
    """``n1_order``: the valid boxes first, each class together in its
    boxes' order, -0.0 with 0.0, NaN ids kept apart by the segment table;
    under force_suppress the valid boxes in order."""
    ids = torch.tensor([[2.0, -0.0, float("nan"), 0.0, 2.0, float("nan"),
                         1.0, 0.0]])
    valid = torch.tensor([[True, True, True, True, False, True, True,
                           True]])
    order = nms.n1_order(ids, valid, False)
    segs = _n1_segments_plain(ids, valid, order, False)[0]
    groups = [sorted(order[0, a:b].tolist()) for a, b in segs]
    assert sorted(groups) == [[0], [1, 3, 7], [2], [5], [6]]
    assert order[0, -1].item() == 4
    for a, b in segs:
        assert order[0, a:b].tolist() == sorted(order[0, a:b].tolist())
    order = nms.n1_order(ids, valid, True)
    assert order[0].tolist() == [0, 1, 2, 3, 5, 6, 7, 4]
    assert _n1_segments_plain(ids, valid, order, True) == [[(0, 7)]]


def _np_rounds(iou):
    """contrib.py:210-225: the L rounds as a Python loop, one item."""
    a, l = iou.shape
    a_used, g_used = np.zeros(a, bool), np.zeros(l, bool)
    m_gt, m_iou = -np.ones(a, np.int64), -np.ones(a, np.float32)
    for _ in range(l):
        masked = np.where(a_used[:, None] | g_used[None, :],
                          np.float32(-1), iou)
        flat = int(np.argmax(masked))
        ai, gi = flat // l, flat % l
        if masked[ai, gi] > np.float32(1e-6):
            a_used[ai], g_used[gi] = True, True
            m_gt[ai], m_iou[ai] = gi, masked[ai, gi]
    return a_used, m_gt, m_iou


@pytest.mark.parametrize("seed", range(8))
def test_m1_rounds_equal_reference_rounds(seed):
    """M1's rounds mode (each ground truth's best free anchor, the best
    column a round, rescans of the columns whose anchor it took) and the
    plain rounds equal the reference's rounds in numpy: IoUs rounded to
    one decimal (ties across anchors and columns), invalid slots (-1),
    more slots than anchors, one slot, duplicates of a column."""
    rs = np.random.RandomState(seed)
    b = 3
    a, l = [(12, 5), (4, 9), (30, 1), (7, 7), (25, 12), (3, 3), (40, 6),
            (1, 4)][seed]
    iou = np.round(rs.uniform(-0.2, 1.0, (b, a, l)), 1).astype(np.float32)
    iou = np.maximum(iou, 0).astype(np.float32)
    iou[:, :, rs.rand(l) < 0.25] = -1.0
    if l > 2:
        iou[:, :, 1] = iou[:, :, 0]
    got_c = _bipartite_rounds_columns_plain(torch.from_numpy(iou))
    got_p = nms.bipartite_rounds_plain(torch.from_numpy(iou))
    got_w = nms.bipartite_rounds(torch.from_numpy(iou))
    for i in range(b):
        want = _np_rounds(iou[i])
        for got in (got_c, got_p, got_w):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[i].numpy(), w)


def test_target_many_slots_tied_ious_against_jax():
    """MultiBoxTarget with 12 label slots, duplicated ground truths and
    anchors (tied IoUs across anchors and across slots) and padded slots:
    the matches (loc_mask, cls_target) equal the JAX package's exactly,
    the regression targets at the box tolerance (their arithmetic rounds
    an ulp apart)."""
    rs = np.random.RandomState(21)
    xy = rs.uniform(0, 0.6, (40, 2))
    anchor = np.concatenate([xy, xy + rs.uniform(0.1, 0.4, (40, 2))], 1)
    anchor[20:26] = anchor[:6]
    anchor = anchor[None].astype(np.float32)
    label = -np.ones((2, 12, 5), np.float32)
    for i, k in enumerate((10, 7)):
        label[i, :k, 0] = rs.randint(0, 4, k)
        label[i, :k, 1:] = anchor[0, rs.randint(0, 40, k)]
        label[i, 1] = label[i, 0]
    cls = rs.standard_normal((2, 5, 40)).astype(np.float32)
    for ratio in (-1.0, 3.0):
        got, want = _both("MultiBoxTarget", anchor, label, cls,
                          overlap_threshold=0.5,
                          negative_mining_ratio=ratio)
        np.testing.assert_allclose(got[0], want[0], **BOX_TOL)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert (got[1] > 0).sum() >= 4
