"""Shared parity checks of the op-set tests (``test_torch_ops_*.py``):
each case of ``mxnet_tpu_torch.ops.sweep`` through the JAX package's op
(its registry function, the gradient under ``jax.vjp``) and through the
port's, on the CPU, from the same seeded numpy inputs and integer
cotangents."""
from __future__ import annotations

import numpy as np

from mxnet_tpu_torch.ops import sweep

COT_SEED = 1234


def run_jax(case, inputs, cot_seed=None):
    """(outputs, grads) of the JAX package's op, as numpy (bfloat16 as
    float32)."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu.ops  # noqa: F401  (registers the ops)
    from mxnet_tpu.ops.registry import get_op
    fn = get_op(case.op).fn
    xs = [jnp.asarray(a) for a in inputs]
    if case.check and case.check.startswith("mp:"):
        xs[0] = xs[0].astype(jnp.dtype(case.check[3:]))
    pos = case.grad_positions(inputs) if cot_seed is not None else []

    def f(*diff):
        args = list(xs)
        for p, d in zip(pos, diff):
            args[p] = d
        res = fn(*args, **case.attrs)
        return res if isinstance(res, tuple) else (res,)

    def to_np(a):
        return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                          else a)

    if not pos:
        return [to_np(o) for o in f()], None
    outs, vjp = jax.vjp(f, *[xs[p] for p in pos])
    cts = tuple(
        jnp.zeros(o.shape, o.dtype)
        if (k in case.no_cot() or not jnp.issubdtype(o.dtype, jnp.floating))
        else jnp.asarray(sweep.cotangent(tuple(o.shape), cot_seed + k),
                         o.dtype)
        for k, o in enumerate(outs))
    grads = vjp(cts)
    return [to_np(o) for o in outs], [to_np(g) for g in grads]


def _sign_rows(v):
    """Each row of the eigenvector matrices scaled to a positive largest
    entry (eigenvectors are defined up to sign)."""
    idx = np.argmax(np.abs(v), axis=-1)[..., None]
    return v * np.sign(np.take_along_axis(v, idx, -1))


def assert_close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != " \
                                    f"{want.shape}"
    if tol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=what)


def compare_forward(case, port_outs, jax_outs):
    assert len(port_outs) == len(jax_outs), case.id
    for k, (p, j) in enumerate(zip(port_outs, jax_outs)):
        what = f"{case.id} output {k}"
        if case.check == "syevd" and k == 0:
            p, j = _sign_rows(p), _sign_rows(j)
        if case.check and case.check.startswith("mp:") and k == 0:
            # the weight is the fp32 master cast to its dtype: equal
            # masters (to ARITH) round to within one ulp of that dtype
            ulp = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}[
                case.check[3:]]
            np.testing.assert_allclose(p, j, rtol=ulp, atol=0, err_msg=what)
            continue
        assert np.asarray(p).dtype == np.asarray(j).dtype, \
            f"{what}: dtype {np.asarray(p).dtype} != {np.asarray(j).dtype}"
        assert_close(p, j, case.tol, what)


def check_case(case, backward):
    """Forward (``backward`` False) or gradient parity of one case."""
    inputs = case.inputs()
    seed = COT_SEED if backward else None
    p_out, p_grad = sweep.run_port(case, inputs, "cpu", cot_seed=seed)
    j_out, j_grad = run_jax(case, inputs, seed)
    if not backward:
        compare_forward(case, p_out, j_out)
        return
    assert p_grad is not None and j_grad is not None, case.id
    for pos, p, j in zip(case.grad_positions(inputs), p_grad, j_grad):
        assert np.all(np.isfinite(p)) == np.all(np.isfinite(j)), case.id
        assert_close(p, j, 10 * case.tol, f"{case.id} grad of input {pos}")


def forward_cases(family):
    return [c for c in sweep.CASES if c.family == family]


def backward_cases(family):
    return [c for c in forward_cases(family)
            if c.grad_positions(c.inputs())]
