"""The op set's sorting and creation ops (sort, argsort and topk on
tie-heavy inputs in every ret_typ, the zeros / ones / full / arange /
eye / linspace creators) against the JAX package's, on the CPU: exact,
ties included (linspace to 1e-6: XLA fuses its float32 arithmetic), and
sort's gradient exact under an integer cotangent."""
import pytest

from torch_ops_parity import backward_cases, check_case, forward_cases

FAMILY = "sort"


@pytest.mark.parametrize("case", forward_cases(FAMILY),
                         ids=lambda c: c.id)
def test_forward(case):
    check_case(case, backward=False)


@pytest.mark.parametrize("case", backward_cases(FAMILY),
                         ids=lambda c: c.id)
def test_backward(case):
    check_case(case, backward=True)


@pytest.mark.parametrize("seed", range(6))
def test_topk_tie_order_against_jax(seed):
    """Random tie-heavy rows and k: the port's topk indices and values
    equal the JAX package's (``lax.top_k``: the lower index first among
    ties), ascending and descending."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from mxnet_tpu.ops.registry import get_op as jget
    from mxnet_tpu_torch.ops.registry import get_op
    rs = np.random.RandomState(seed)
    n = rs.randint(2, 60)
    k = rs.randint(1, n + 1)
    x = rs.randint(0, 5, (4, n)).astype(np.float32)
    for asc in (False, True):
        got = get_op("topk").fn(torch.from_numpy(x), k=k, ret_typ="both",
                                is_ascend=asc)
        want = jget("topk").fn(jnp.asarray(x), k=k, ret_typ="both",
                               is_ascend=asc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ret_typ", ["value", "indices", "mask", "both"])
@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("axis", [-1, 0])
def test_topk_k0_against_jax(ret_typ, is_ascend, axis):
    """``k=0`` (C-12): empty values and indices of length 0 along
    ``axis`` and an all-zero mask, as the JAX package gives them."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from mxnet_tpu.ops.registry import get_op as jget
    from mxnet_tpu_torch.ops.registry import get_op
    x = np.random.RandomState(3).randint(0, 4, (2, 5)).astype(np.float32)
    got = get_op("topk").fn(torch.from_numpy(x), axis=axis, k=0,
                            ret_typ=ret_typ, is_ascend=is_ascend)
    want = jget("topk").fn(jnp.asarray(x), axis=axis, k=0, ret_typ=ret_typ,
                           is_ascend=is_ascend)
    if ret_typ != "both":
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
