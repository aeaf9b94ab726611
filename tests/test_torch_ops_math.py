"""The op set's math and logic ops (unary math, rounding, the logical
and scalar forms, the legacy arithmetic names, add_n, smooth_l1, the
products and nan-reductions, the mixed-precision SGD updates) against
the JAX package's, on the CPU: forward at each case's tolerance (exact
for rounding and logic, rtol 1e-5 for arithmetic, 1e-4 for the special
functions), gradients under one integer cotangent at ten times it."""
import pytest

from torch_ops_parity import backward_cases, check_case, forward_cases

FAMILY = "math"


@pytest.mark.parametrize("case", forward_cases(FAMILY),
                         ids=lambda c: c.id)
def test_forward(case):
    check_case(case, backward=False)


@pytest.mark.parametrize("case", backward_cases(FAMILY),
                         ids=lambda c: c.id)
def test_backward(case):
    check_case(case, backward=True)
