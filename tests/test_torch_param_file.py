"""The port's ``.params`` format (``mxnet_tpu_torch.ndarray.param_file``,
``nd.save`` / ``nd.load``, ``model.save_checkpoint``) against the JAX
package's, on the CPU.

The same numpy arrays go through both packages' writers; the bytes must
be equal (exact: the format is a byte layout), for every type flag, for
dense, row-sparse and CSR arrays, with and without names. Each package
then loads the other's file and gets the same arrays back, bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import param_file as jpf
from mxnet_tpu.ndarray import sparse as jsparse

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray import param_file as tpf

# the seven type flags of the format, in flag order
DTYPES = ["float32", "float64", "float16", "uint8", "int32", "int8",
          "int64"]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -100), min(info.max, 100), shape,
                        endpoint=True).astype(dtype)


def _dense_set():
    arrs = [_array(dt, (3, 2 + i), seed=i) for i, dt in enumerate(DTYPES)]
    names = [f"arg:w_{dt}" for dt in DTYPES]
    return arrs, names


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_bytes_equal_per_type_flag(dtype):
    a = _array(dtype, (4, 5, 2))
    want = jpf.dumps_params([a], ["arg:x"])
    assert tpf.dumps_params([a], ["arg:x"]) == want
    # the same array as a torch tensor and as a port NDArray
    assert tpf.dumps_params([torch.from_numpy(a.copy())], ["arg:x"]) == want
    assert tpf.dumps_params([tmx.nd.NDArray(torch.from_numpy(a.copy()))],
                            ["arg:x"]) == want


def test_dense_list_bytes_equal_named_and_unnamed():
    arrs, names = _dense_set()
    assert tpf.dumps_params(arrs, names) == jpf.dumps_params(arrs, names)
    assert tpf.dumps_params(arrs, []) == jpf.dumps_params(arrs, [])
    # a 0-d array is written with shape (1,) by both
    s = np.float32(3.5).reshape(())
    assert tpf.dumps_params([s], ["s"]) == jpf.dumps_params([s], ["s"])


def _row_sparse(seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((3, 4)).astype(np.float32)
    idx = np.array([0, 2, 5], np.int64)
    return vals, idx, (6, 4)


def _csr(seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(5).astype(np.float32)
    indices = np.array([0, 3, 1, 2, 3], np.int64)
    indptr = np.array([0, 2, 2, 5], np.int64)
    return vals, indices, indptr, (3, 4)


def test_sparse_bytes_equal():
    vals, idx, shape = _row_sparse()
    j_rs = jsparse.RowSparseNDArray(vals, idx, shape)
    t_rs = tpf.RowSparseStorage(vals, idx, shape)
    cv, ci, cp, cshape = _csr()
    j_csr = jsparse.CSRNDArray(cv, ci, cp, cshape)
    t_csr = tpf.CSRStorage(cv, ci, cp, cshape)
    dense = _array("float32", (2, 2))
    want = jpf.dumps_params([j_rs, dense, j_csr], ["rs", "d", "csr"])
    assert tpf.dumps_params([t_rs, dense, t_csr],
                            ["rs", "d", "csr"]) == want
    # the port writes the JAX package's sparse arrays the same way
    assert tpf.dumps_params([j_rs, dense, j_csr],
                            ["rs", "d", "csr"]) == want


def test_each_package_loads_the_others_file(tmp_path):
    arrs, names = _dense_set()
    vals, idx, shape = _row_sparse()
    cv, ci, cp, cshape = _csr()
    jfile, tfile = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(jfile, dict(zip(
        names + ["rs", "csr"],
        # numpy arrays: a JAX NDArray holds no float64 / int64 here
        list(arrs) +
        [jsparse.RowSparseNDArray(vals, idx, shape),
         jsparse.CSRNDArray(cv, ci, cp, cshape)])))
    tmx.nd.save(tfile, dict(zip(
        names + ["rs", "csr"],
        [torch.from_numpy(a.copy()) for a in arrs] +
        [tpf.RowSparseStorage(vals, idx, shape),
         tpf.CSRStorage(cv, ci, cp, cshape)])))
    assert open(jfile, "rb").read() == open(tfile, "rb").read()
    got_t = tmx.nd.load(jfile)          # the port reads the JAX file
    got_j = jmx.nd.load(tfile)          # the JAX package reads the port's
    for n, a in zip(names, arrs):
        assert got_t[n].context.device_type == "cpu"
        np.testing.assert_array_equal(got_t[n].asnumpy(), a)
        assert got_t[n].asnumpy().dtype == a.dtype
        # the JAX package holds what jnp makes of it (no 64-bit types)
        np.testing.assert_array_equal(got_j[n].asnumpy(),
                                      np.asarray(jnp.asarray(a)))
    np.testing.assert_array_equal(got_t["rs"].asnumpy(),
                                  got_j["rs"].asnumpy())
    np.testing.assert_array_equal(got_t["rs"]._indices, idx)
    np.testing.assert_array_equal(got_t["csr"].asnumpy(),
                                  got_j["csr"].asnumpy())
    np.testing.assert_array_equal(got_t["csr"]._indptr, cp)


def test_nd_save_load_round_trips(tmp_path):
    arrs, names = _dense_set()
    p = str(tmp_path / "x.params")
    tmx.nd.save(p, [torch.from_numpy(a.copy()) for a in arrs])
    back = tmx.nd.load(p)
    assert isinstance(back, list) and len(back) == len(arrs)
    for a, b in zip(arrs, back):
        np.testing.assert_array_equal(b.asnumpy(), a)
    # the npz container (any other extension), in both packages
    z = str(tmp_path / "x.nd")
    tmx.nd.save(z, dict(zip(names, arrs)))
    back = tmx.nd.load(z)
    jback = jmx.nd.load(z)
    for n, a in zip(names, arrs):
        np.testing.assert_array_equal(back[n].asnumpy(), a)
        np.testing.assert_array_equal(jback[n].asnumpy(),
                                      np.asarray(jnp.asarray(a)))
    one = str(tmp_path / "one.params")
    tmx.nd.save(one, tmx.nd.NDArray(torch.arange(6.0).reshape(2, 3)))
    (b,) = tmx.nd.load(one)
    np.testing.assert_array_equal(b.asnumpy(),
                                  np.arange(6.0, dtype=np.float32)
                                  .reshape(2, 3))


def test_bfloat16_has_no_type_flag():
    with pytest.raises(KeyError):
        tpf.dumps_params([torch.zeros(2, dtype=torch.bfloat16)], ["b"])


def test_save_checkpoint_files_load_across_packages(tmp_path):
    """``model.save_checkpoint``'s two files: the symbol JSON and the
    ``arg:`` / ``aux:`` map, written by each package and read by the
    other."""
    def net(pkg):
        d = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(d, num_hidden=3, name="fc")
        h = pkg.sym.BatchNorm(h, name="bn")
        return pkg.sym.SoftmaxOutput(h, name="softmax")

    rng = np.random.default_rng(0)
    args = {"fc_weight": rng.standard_normal((3, 4)).astype(np.float32),
            "fc_bias": np.zeros(3, np.float32),
            "bn_gamma": np.ones(3, np.float32),
            "bn_beta": np.zeros(3, np.float32)}
    aux = {"bn_moving_mean": rng.standard_normal(3).astype(np.float32),
           "bn_moving_var": np.ones(3, np.float32)}
    tp, jp = str(tmp_path / "t"), str(tmp_path / "j")
    tmx.model.save_checkpoint(tp, 3, net(tmx), args, aux)
    jmx.model.save_checkpoint(jp, 3, net(jmx),
                              {k: jmx.nd.array(v) for k, v in args.items()},
                              {k: jmx.nd.array(v) for k, v in aux.items()})
    assert open(f"{tp}-0003.params", "rb").read() == \
        open(f"{jp}-0003.params", "rb").read()
    for load, prefix in ((tmx.model.load_checkpoint, jp),
                         (jmx.model.load_checkpoint, tp)):
        sym, a, x = load(prefix, 3)
        assert sym.list_arguments() == net(jmx).list_arguments()
        assert sym.list_auxiliary_states() == ["bn_moving_mean",
                                               "bn_moving_var"]
        for k, v in args.items():
            np.testing.assert_array_equal(a[k].asnumpy(), v)
        for k, v in aux.items():
            np.testing.assert_array_equal(x[k].asnumpy(), v)
    assert os.path.exists(f"{tp}-symbol.json")
