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
order itself. N1's and M1's plain versions (``ops/nms.py``) equal a
direct numpy transcription of the reference loops (contrib.py:326-329,
surface.py:456-468), and ``_n1_plan`` / ``_m1_plan`` route a CUDA device
to the kernel and the CPU and meta devices to the plain versions."""
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
    p = nms._n1_plan("cuda:0", 32, 8732)
    assert p.route == "cuda" and p.words == 137
    assert p.threads == nms._SWEEP_THREADS and p.smem_bytes == 137 * 8
    for dev in ("cpu", "meta", torch.device("cpu")):
        assert nms._n1_plan(dev, 32, 8732).route == "plain"
        assert nms._m1_plan(dev, 4, 8732, 50).route == "plain"
    assert nms._m1_plan("cuda", 4, 8732, 50) == nms.M1Plan("cuda")
    with pytest.raises(MXNetError):
        nms._n1_plan("cuda:0", 1, 64 * (nms._SMEM_MAX // 8 + 1))
    with pytest.raises(MXNetError):
        nms._n1_plan("cuda:0", 70000, 10)
    with pytest.raises(MXNetError):
        nms._m1_plan("cuda:0", 1, 2 ** 24, 3)
    with pytest.raises(MXNetError):
        nms._n1_plan("mps", 1, 10)


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
