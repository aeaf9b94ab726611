"""The op set's indexing and shape ops (slice and its negative steps,
take in its three modes, batch_take, gather_nd / scatter_nd and
_scatter_set_nd with negative and out-of-range indices, tile, repeat,
reverse, the broadcasts, diag, the depth-space ops, batch_dot,
L2Normalization, the Sequence ops, the slice assignments) against the
JAX package's, on the CPU: exact forward for the shape and index ops
(rtol 1e-5 for batch_dot and L2Normalization), gradients under one
integer cotangent at ten times it. scatter_nd's cases use distinct
indices: duplicates are undefined in MXNet and in the JAX package."""
import pytest

from torch_ops_parity import backward_cases, check_case, forward_cases

FAMILY = "index"


@pytest.mark.parametrize("case", forward_cases(FAMILY),
                         ids=lambda c: c.id)
def test_forward(case):
    check_case(case, backward=False)


@pytest.mark.parametrize("case", backward_cases(FAMILY),
                         ids=lambda c: c.id)
def test_backward(case):
    check_case(case, backward=True)
