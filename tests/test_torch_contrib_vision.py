"""The contrib detection and vision ops (Proposal / MultiProposal with
output_score over a batch of 2, PSROIPooling, DeformablePSROIPooling
with and without trans, DeformableConvolution with groups, deformable
groups and bias, Correlation multiplying and subtracting, Crop by h_w,
by a second input and centred, count_sketch, fft and ifft) against the
JAX package's, on the CPU, from the seeded inputs of ``ops/sweep.py``:
forward at rtol 1e-5 (atol 1e-5: sums of tens of terms of unit size in
another order), gradients under one integer cotangent at rtol 1e-4
where the op has them."""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import sweep
from mxnet_tpu_torch.ops.registry import get_op

from torch_ops_parity import assert_close, check_case, run_jax


def _cases(backward):
    cases = [c for c in sweep.CASES if c.family == "contrib"
             and get_op(c.op).name not in sweep.BOX_OPS]
    return [c for c in cases if c.grad_positions(c.inputs())] \
        if backward else cases


@pytest.mark.parametrize("case", _cases(False), ids=lambda c: c.id)
def test_forward(case):
    check_case(case, backward=False)


@pytest.mark.parametrize("case", _cases(True), ids=lambda c: c.id)
def test_backward(case):
    ins = case.inputs()
    _, got = sweep.run_port(case, ins, "cpu", cot_seed=1234)
    _, want = run_jax(case, ins, 1234)
    for pos, g, w in zip(case.grad_positions(ins), got, want):
        assert np.all(np.isfinite(g)), (case.id, pos)
        assert_close(g, w, 1e-4, f"{case.id} grad of input {pos}")


def test_proposal_keeps_the_kept_boxes_first():
    """Proposal's rois: each image's block of rpn_post_nms_top_n rows
    starts with its batch index, the kept boxes come in descending score
    and the rest repeat the first kept one, as in the JAX package."""
    case = next(c for c in sweep.CASES if c.id == "Proposal")
    ins = case.inputs()
    (rois, scores), _ = sweep.run_port(case, ins, "cpu")
    post = case.attrs["rpn_post_nms_top_n"]
    for b in range(2):
        blk = rois[b * post:(b + 1) * post]
        assert (blk[:, 0] == b).all()
        s = scores[b * post:(b + 1) * post, 0]
        n = len(np.unique(blk[:, 1:], axis=0))
        assert (np.diff(s[:n]) <= 0).all()
        assert (blk[n:] == blk[0]).all() or n == post


def test_fft_round_trip():
    """ifft(fft(x)) is x times d (the unnormalized inverse)."""
    x = np.random.RandomState(3).standard_normal((2, 3, 16)) \
        .astype(np.float32)
    t = torch.from_numpy(x)
    back = get_op("ifft").fn(get_op("fft").fn(t))
    np.testing.assert_allclose(back.numpy(), 16 * x, rtol=1e-5, atol=1e-4)


def test_count_sketch_drops_out_of_range_ids():
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    h = np.array([[0, 5, 1]], np.float32)
    s = np.array([[1, 1, -1]], np.float32)
    out = get_op("count_sketch").fn(*map(torch.from_numpy, (data, h, s)),
                                    out_dim=3).numpy()
    np.testing.assert_array_equal(out, [[0, -2, 0], [3, -5, 0]])
    want, _ = run_jax(sweep.Case("count_sketch", "contrib",
                                 lambda rs: [data, h, s], {"out_dim": 3}),
                      [data, h, s])
    np.testing.assert_array_equal(out, want[0])
