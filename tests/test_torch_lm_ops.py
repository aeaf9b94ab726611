"""The LM's three ops in the port (``Embedding``, ``LayerNorm``,
``CausalSelfAttention``) against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX package's registry
functions (``mxnet_tpu/ops/shape_ops.py``, ``mxnet_tpu/ops/nn.py``) and
the port's, and the gradients through ``jax.vjp`` and torch's autograd
with the same cotangents. Tolerances (fp32): forwards within 1e-5
relative + 1e-6 absolute (the products and sums run in another order:
about 1e-7 here); gradients within 1e-5 relative + 1e-5 absolute.

- ``Embedding``: ids in range, wrapped (``[-n, -1]``), out of range
  (NaN rows, as ``jnp.take``'s fill mode gives) and fractional
  (truncated toward zero); the weight gradient with repeated ids (a
  40-row table at 16x32 positions) and with invalid ids (their rows get
  no gradient); two backward runs bit for bit.
- ``LayerNorm``: forward and the data / gamma / beta gradients on axes
  -1 and 1, with and without ``output_mean_var`` (the population
  variance).
- ``CausalSelfAttention``: forward and the gradient against ``jax.vjp``
  of the JAX op, at S = 1, an odd S and with an explicit ``scale``;
  the mask is causal (a later position's value never reaches an
  earlier output).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import shape_ops as jshape

from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import shape_ops as tshape

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------
_EMB_IDS = {
    "in_range": [[0, 3, 9], [4, 4, 1]],
    "wrapped": [[-1, -10, -3], [2, -5, 0]],
    "out_of_range": [[10, 11, -11], [3, 1000, -1000]],
    "fractional": [[2.7, -0.5, 0.99], [-1.2, 9.9, 3.0]],
}


@pytest.mark.parametrize("case", sorted(_EMB_IDS))
def test_embedding_forward(case):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((10, 6)).astype(np.float32)
    ids = np.asarray(_EMB_IDS[case], np.float32)
    want = jshape.embedding(jnp.asarray(ids), jnp.asarray(w),
                            input_dim=10, output_dim=6)
    got = tshape.embedding(_t(ids), _t(w), input_dim=10, output_dim=6)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(np.isnan(got.numpy()),
                                  np.isnan(np.asarray(want)))
    _close(got, want, FWD)


@pytest.mark.parametrize("vocab,shape,with_invalid", [
    (40, (16, 32), False), (40, (16, 32), True), (7, (3, 5), True)])
def test_embedding_weight_gradient_repeated_ids(vocab, shape, with_invalid):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((vocab, 8)).astype(np.float32)
    ids = rng.integers(0, vocab, shape).astype(np.float32)
    if with_invalid:
        ids.flat[::7] = vocab + 3
        ids.flat[3::11] = -vocab - 1
    ct = rng.standard_normal(shape + (8,)).astype(np.float32)
    _, vjp = jax.vjp(lambda ww: jshape.embedding(jnp.asarray(ids), ww),
                     jnp.asarray(w))
    want = vjp(jnp.asarray(ct))[0]

    def port_grad():
        wt = _t(w, grad=True)
        tshape.embedding(_t(ids), wt).backward(_t(ct))
        return wt.grad

    g1, g2 = port_grad(), port_grad()
    _close(g1, want, GRAD)
    assert torch.equal(g1, g2)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("output_mean_var", [False, True])
def test_layer_norm_forward_and_gradients(axis, output_mean_var):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 7)) * 2 + 0.5).astype(np.float32)
    c = x.shape[axis]
    g = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    kw = dict(axis=axis, eps=1e-5, output_mean_var=output_mean_var)
    want, vjp = jax.vjp(lambda *a: jnn.layer_norm(*a, **kw),
                        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = want if output_mean_var else (want,)
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32)
           for o in want]
    jgrads = vjp(tuple(jnp.asarray(c_) for c_ in cts) if output_mean_var
                 else jnp.asarray(cts[0]))
    ins = [_t(a, grad=True) for a in (x, g, b)]
    got = tnn.layer_norm(*ins, **kw)
    got = got if output_mean_var else (got,)
    assert len(got) == len(want)
    for o, w_ in zip(got, want):
        assert tuple(o.shape) == tuple(np.shape(w_))
        _close(o, w_, FWD)
    torch.autograd.backward(got, [_t(c_) for c_ in cts])
    for t_, j_ in zip(ins, jgrads):
        _close(t_.grad, j_, GRAD)


def test_layer_norm_uses_the_population_variance():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    _, _, var = tnn.layer_norm(x, torch.ones(4), torch.zeros(4),
                               output_mean_var=True)
    assert var.item() == pytest.approx(1.25)


# ---------------------------------------------------------------------------
# CausalSelfAttention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,heads,scale", [
    (1, 2, None), (7, 2, None), (7, 3, 0.3), (16, 4, None)])
def test_causal_self_attention_forward_and_gradient(s, heads, scale):
    rng = np.random.default_rng(4)
    d = 8
    x = rng.standard_normal((2, s, 3 * heads * d)).astype(np.float32)
    ct = rng.standard_normal((2, s, heads * d)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda a: jnn.causal_self_attention(a, num_heads=heads,
                                            scale=scale), jnp.asarray(x))
    jgrad = vjp(jnp.asarray(ct))[0]
    xt = _t(x, grad=True)
    got = tnn.causal_self_attention(xt, num_heads=heads, scale=scale)
    assert tuple(got.shape) == (2, s, heads * d)
    _close(got, want, FWD)
    got.backward(_t(ct))
    _close(xt.grad, jgrad, GRAD)


def test_causal_self_attention_is_causal():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 9, 3 * 2 * 4)).astype(np.float32)
    base = tnn.causal_self_attention(_t(x), num_heads=2)
    x2 = x.copy()
    x2[:, 6:] += 5.0
    moved = tnn.causal_self_attention(_t(x2), num_heads=2)
    assert torch.equal(base[:, :6], moved[:, :6])
    assert not torch.equal(base[:, 6:], moved[:, 6:])
