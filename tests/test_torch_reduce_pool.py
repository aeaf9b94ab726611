"""Integer reductions and the ``full`` pooling convention of the port
against the JAX package's, on the CPU.

- ``sum`` / ``sum_axis`` / ``mean`` of int32 and uint8 arrays, over all
  axes, one axis and with keepdims: the result dtype is the JAX
  package's (``jnp.sum`` without x64: int32 stays int32, uint8 widens to
  uint32; ``jnp.mean`` of an integer array is float32) and the values
  are equal exactly (the mean as XLA computes it, the float32 sum times
  the float32 reciprocal of the count).
- ``Pooling(pooling_convention="full")``, the ceil-mode output size, for
  max, avg (with and without ``count_include_pad``) and sum, on 9x9
  with pool 2 / stride 2 and 7x7 with pool 3 / stride 2, through
  ``nd.Pooling`` and through ``gluon.nn.MaxPool2D`` /
  ``AvgPool2D(ceil_mode=True)``: the same shape, values within 1e-6.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

INT_CASES = [
    ("int32", np.array([[7, -7, 5], [1, 2, 3]])),
    ("uint8", np.array([[7, 250, 5], [1, 2, 3]])),
]
AXES = [{}, {"axis": 1}, {"axis": 0, "keepdims": True},
        {"axis": (0, 1), "keepdims": True}]


@pytest.fixture(autouse=True)
def _cpu_scope():
    with tmx.cpu():
        yield


@pytest.mark.parametrize("op", ["sum", "sum_axis", "mean"])
@pytest.mark.parametrize("kw", AXES, ids=["all", "axis1", "axis0_keep",
                                          "both_keep"])
@pytest.mark.parametrize("dtype,values", INT_CASES, ids=["int32", "uint8"])
def test_integer_reduction_matches_jax(op, kw, dtype, values):
    if op == "sum_axis" and "axis" not in kw:
        kw = {"axis": 0}
    a = values.astype(dtype)
    want = getattr(jmx.nd, op)(jmx.nd.array(a, dtype=dtype), **kw)
    got = getattr(tmx.nd, op)(tmx.nd.array(a, dtype=dtype), **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_int32_sum_keeps_int32_and_mean_is_float32():
    a = np.array([7, -7, 5], np.int32)
    s = tmx.nd.sum(tmx.nd.array(a, dtype="int32"))
    m = tmx.nd.mean(tmx.nd.array(a, dtype="int32"))
    assert s.dtype == np.int32 and s.asscalar() == 5
    assert m.dtype == np.float32
    assert m.asscalar() == jmx.nd.mean(jmx.nd.array(a, dtype="int32")) \
        .asscalar()


POOL_SIZES = [(9, 2, 2), (7, 3, 2)]


@pytest.mark.parametrize("pool_type,count_include_pad",
                         [("max", True), ("avg", True), ("avg", False),
                          ("sum", True)])
@pytest.mark.parametrize("size,kernel,stride,pad",
                         [(9, 2, 2, 0), (7, 3, 2, 0), (7, 3, 2, 1)],
                         ids=["9x9_k2s2", "7x7_k3s2", "7x7_k3s2_pad1"])
def test_pooling_full_convention_matches_jax(size, kernel, stride, pad,
                                             pool_type, count_include_pad):
    x = np.random.default_rng(size).standard_normal(
        (2, 3, size, size)).astype(np.float32)
    kw = dict(kernel=(kernel, kernel), stride=(stride, stride),
              pad=(pad, pad), pool_type=pool_type,
              pooling_convention="full",
              count_include_pad=count_include_pad)
    want = jmx.nd.Pooling(jmx.nd.array(x), **kw).asnumpy()
    got = tmx.nd.Pooling(tmx.nd.array(x), **kw).asnumpy()
    out = -(-(size + 2 * pad - kernel) // stride) + 1
    assert got.shape == want.shape == (2, 3, out, out)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("layer", ["MaxPool2D", "AvgPool2D"])
@pytest.mark.parametrize("size,kernel,stride", POOL_SIZES,
                         ids=["9x9_k2s2", "7x7_k3s2"])
def test_gluon_ceil_mode_pooling_matches_jax(layer, size, kernel, stride):
    x = np.random.default_rng(size + 1).standard_normal(
        (2, 3, size, size)).astype(np.float32)
    jl = getattr(jmx.gluon.nn, layer)(kernel, stride, ceil_mode=True)
    tl = getattr(tmx.gluon.nn, layer)(kernel, stride, ceil_mode=True)
    want = jl(jmx.nd.array(x)).asnumpy()
    got = tl(tmx.nd.array(x)).asnumpy()
    assert got.shape == want.shape
    assert got.shape[-1] == -(-(size - kernel) // stride) + 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
