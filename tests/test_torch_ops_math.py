"""The op set's math and logic ops (unary math, rounding, the logical
and scalar forms, the legacy arithmetic names, add_n, smooth_l1, the
products and nan-reductions, the mixed-precision SGD updates) against
the JAX package's, on the CPU: forward at each case's tolerance (exact
for rounding and logic, rtol 1e-5 for arithmetic, 1e-4 for the special
functions), gradients under one integer cotangent at ten times it."""
import numpy as np
import pytest

from mxnet_tpu_torch.ops import sweep
from mxnet_tpu_torch.ops.sweep import SPECIAL
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


def _at_points(*arrays):
    return lambda rs: [np.asarray(a, np.float32) for a in arrays]


# C-13: the points where the gradient rule decides (a value at a clip
# bound, |x| at 0 and -0, hypot at (0, 0), a zero base to a zero
# exponent), each beside ordinary points; the seeded cases of
# ``ops/sweep.py`` meet none of them
KINK_CASES = [
    sweep.Case("clip", "math", _at_points(
        [[-1.0, 0.0, 0.25, 1.0, 2.0], [0.0, 1.0, 1.0, -0.0, 0.5]]),
        {"a_min": 0.0, "a_max": 1.0}, tag="kinks"),
    sweep.Case("clip", "math", _at_points([[0.5, 0.25, 0.75, 0.5]]),
               {"a_min": 0.5, "a_max": 0.5}, tag="kinks-equal-bounds"),
    sweep.Case("clip", "math", _at_points([[0.0, 1.0, -2.0, 3.0]]),
               {"a_max": 1.0}, tag="kinks-max-only"),
    sweep.Case("abs", "math", _at_points([[0.0, -0.0, 1.5, -2.0]]),
               tag="kinks"),
    sweep.Case("_hypot", "math", _at_points(
        [[0.0, 0.0, 3.0, -0.0, 2.0]], [[0.0, 2.0, -4.0, 0.0, 0.0]]),
        tag="kinks"),
    sweep.Case("broadcast_hypot", "math", _at_points(
        [[0.0, 1.0], [-0.0, 0.0]], [[0.0, 0.0]]), tag="kinks"),
    sweep.Case("_hypot_scalar", "math", _at_points([[0.0, -0.0, 1.0]]),
               {"scalar": 0.0}, tag="kinks"),
    sweep.Case("broadcast_power", "math", _at_points(
        [[0.0, 0.0, 0.0, 2.0, 1.5], [0.0, 3.0, 0.0, 0.5, 0.0]],
        [[0.0, 1.0, 2.0, 0.0, 0.5]]), tol=SPECIAL, tag="kinks"),
]


@pytest.mark.parametrize("case", KINK_CASES, ids=lambda c: c.id)
@pytest.mark.parametrize("backward", [False, True])
def test_gradient_kinks_against_jax(case, backward):
    """C-13: forward and gradient at each kink equal the JAX package's
    (``jnp.clip``'s split tie, JAX's ``abs`` rule at 0 and -0,
    ``jnp.hypot``'s finite gradient at (0, 0), ``lax.pow``'s NaN base
    gradient at 0 ** 0)."""
    check_case(case, backward=backward)
