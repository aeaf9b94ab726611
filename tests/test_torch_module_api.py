"""The Module API faults the port had against the JAX package, on the
CPU, each with a case that failed before its repair:

- a single-output ``split`` / ``SliceChannel`` is the NDArray itself;
- batches, ``get_outputs`` and ``get_input_grads`` are NDArrays (a view
  of the tensor, no copy), and an initializer fills an NDArray;
- ``predict`` (padding trimmed, batches merged), ``iter_predict``,
  ``as_predictor`` and ``Predictor.from_module``, also on a
  ``BucketingModule``.

The same numpy inputs and parameters go into both packages; outputs of
the same float32 forward agree within 1e-5 (summation order).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _nd(pkg, a):
    return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx else pkg.nd.array(a)


def _mlp(pkg, hidden=6, classes=3):
    x = pkg.sym.Variable("data")
    x = pkg.sym.FullyConnected(x, num_hidden=hidden, name="fc1")
    x = pkg.sym.Activation(x, act_type="tanh", name="act1")
    x = pkg.sym.FullyConnected(x, num_hidden=classes, name="fc2")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _params(seed=0, n_in=5, hidden=6, classes=3):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(hidden, n_in).astype(np.float32),
            "fc1_bias": rng.randn(hidden).astype(np.float32),
            "fc2_weight": rng.randn(classes, hidden).astype(np.float32),
            "fc2_bias": rng.randn(classes).astype(np.float32)}


def _module(pkg, batch, params, for_training=False, inputs_need_grad=False):
    kw = {"context": tmx.cpu()} if pkg is tmx else {}
    m = pkg.mod.Module(_mlp(pkg), **kw)
    m.bind([("data", (batch, 5))], [("softmax_label", (batch,))],
           for_training=for_training, inputs_need_grad=inputs_need_grad)
    m.set_params({k: _nd(pkg, v) for k, v in params.items()}, {})
    return m


# -- C-8 ---------------------------------------------------------------------
@pytest.mark.parametrize("op", ["split", "SliceChannel"])
def test_single_output_split_is_the_ndarray(op):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = getattr(tmx.nd, op)(_nd(tmx, a), num_outputs=1, axis=1)
    j = getattr(jmx.nd, op)(_nd(jmx, a), num_outputs=1, axis=1)
    assert isinstance(j, jmx.nd.NDArray)
    assert isinstance(t, tmx.nd.NDArray)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    two = tmx.nd.split(_nd(tmx, a), num_outputs=2, axis=1)
    assert isinstance(two, tuple) and len(two) == 2
    assert isinstance(_nd(tmx, a).split(1, axis=0), tmx.nd.NDArray)
    # the symbol keeps one output either way
    for pkg in (jmx, tmx):
        s = pkg.sym.split(pkg.sym.Variable("x"), num_outputs=1, axis=1,
                          name="sp")
        assert s.list_outputs() == ["sp_output"]


# -- C-6 ---------------------------------------------------------------------
def test_iterator_batches_are_ndarrays():
    rng = np.random.RandomState(1)
    data = rng.randn(7, 5).astype(np.float32)
    lab = np.arange(7, dtype=np.float32)
    for pkg in (jmx, tmx):
        b = next(iter(pkg.io.NDArrayIter(data, lab, batch_size=4)))
        assert isinstance(b.data[0], pkg.nd.NDArray)
        assert isinstance(b.label[0], pkg.nd.NDArray)
        np.testing.assert_array_equal(b.data[0].asnumpy(), data[:4])
        np.testing.assert_array_equal(b.label[0].asnumpy(), lab[:4])


def test_outputs_and_input_grads_are_ndarrays():
    p = _params()
    rng = np.random.RandomState(2)
    x = rng.randn(4, 5).astype(np.float32)
    y = np.array([0, 2, 1, 0], np.float32)
    got = {}
    for pkg in (jmx, tmx):
        kw = {"fused": False} if pkg is tmx else {}
        m = pkg.mod.Module(_mlp(pkg), context=tmx.cpu(), **kw) \
            if pkg is tmx else pkg.mod.Module(_mlp(pkg))
        m.bind([("data", (4, 5))], [("softmax_label", (4,))],
               inputs_need_grad=True)
        m.set_params({k: _nd(pkg, v) for k, v in p.items()}, {})
        m.forward(pkg.io.DataBatch([_nd(pkg, x)], [_nd(pkg, y)]),
                  is_train=True)
        m.backward()
        outs, grads = m.get_outputs(), m.get_input_grads()
        assert all(isinstance(o, pkg.nd.NDArray) for o in outs + grads)
        got[pkg] = (outs[0].asnumpy(), grads[0].asnumpy())
    for a, b in zip(got[tmx], got[jmx]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    # no copy: the NDArray is a view of the step's tensor
    tm = _module(tmx, 4, p)
    tm.forward(tmx.io.DataBatch([_nd(tmx, x)], []), is_train=False)
    assert tm.get_outputs()[0]._data is tm._outputs[0]


def test_initializer_fills_an_ndarray():
    for init in ("xavier", "one", "zero"):
        arrs = {}
        for pkg in (jmx, tmx):
            arr = _nd(pkg, np.full((4, 6), 7.0, np.float32))
            pkg.init.create(init)(pkg.init.InitDesc("fc_weight"), arr)
            arrs[pkg] = arr.asnumpy()
        if init == "xavier":
            # random draws differ between packages; the scale is Xavier's
            bound = np.sqrt(3.0 / 5.0)
            assert np.abs(arrs[tmx]).max() <= bound
            assert not np.any(arrs[tmx] == 7.0)
        else:
            np.testing.assert_array_equal(arrs[tmx], arrs[jmx])
    arr = _nd(tmx, np.zeros(3, np.float32))
    tmx.init.Xavier()(tmx.init.InitDesc("fc_bias"), arr)
    np.testing.assert_array_equal(arr.asnumpy(), np.zeros(3))


# -- C-7 ---------------------------------------------------------------------
def test_predict_trims_padding_like_jax():
    p = _params(3)
    rng = np.random.RandomState(4)
    data = rng.randn(10, 5).astype(np.float32)
    got = {}
    for pkg in (jmx, tmx):
        m = _module(pkg, 4, p)
        it = pkg.io.NDArrayIter(data, np.zeros(10, np.float32),
                                batch_size=4)          # last batch pads 2
        merged = m.predict(it)
        listed = m.predict(it, merge_batches=False)
        always = m.predict(it, always_output_list=True, num_batch=2)
        rows = [(nb, [o.shape for o in outs], b.pad)
                for outs, nb, b in m.iter_predict(it)]
        got[pkg] = (merged.asnumpy(), [[o.asnumpy() for o in outs]
                                       for outs in listed],
                    [o.asnumpy() for o in always], rows)
        assert isinstance(merged, pkg.nd.NDArray)
    t, j = got[tmx], got[jmx]
    assert t[0].shape == (10, 3)
    np.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL)
    assert [len(x) for x in t[1]] == [len(x) for x in j[1]] == [1, 1, 1]
    for a, b in zip(t[1], j[1]):
        np.testing.assert_allclose(a[0], b[0], rtol=TOL, atol=TOL)
    assert t[1][-1][0].shape == (2, 3)
    assert len(t[2]) == 1 and t[2][0].shape == (8, 3)
    np.testing.assert_allclose(t[2][0], j[2][0], rtol=TOL, atol=TOL)
    assert t[3] == [(nb, [tuple(s) for s in shapes], pad)
                    for nb, shapes, pad in j[3]]
    # an array is wrapped in an NDArrayIter of batch 1, as in the JAX package
    m1 = _module(tmx, 1, p)
    np.testing.assert_allclose(m1.predict(data[:3]).asnumpy(), t[0][:3],
                               rtol=TOL, atol=TOL)


def test_as_predictor_and_from_module_own_copies():
    p = _params(5)
    rng = np.random.RandomState(6)
    x = rng.randn(3, 5).astype(np.float32)
    m = _module(tmx, 3, p)
    want = m.predict(tmx.io.NDArrayIter(x, batch_size=3)).asnumpy()
    pred = m.as_predictor(buckets=(4,))
    assert pred.device == torch.device("cpu")
    assert pred.data_shapes == {"data": (5,)}
    np.testing.assert_allclose(pred.predict(x), want, rtol=TOL, atol=TOL)
    from_mod = tmx.serving.Predictor.from_module(m, buckets=(2, 4))
    # the module goes on changing; the predictors keep their copies
    m.get_params()[0]["fc2_bias"].add_(10.0)
    np.testing.assert_allclose(pred.predict(x), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(from_mod.predict(x), want, rtol=TOL,
                               atol=TOL)
    # the JAX package's Predictor of the same params agrees
    jm = _module(jmx, 3, p)
    jpred = jm.as_predictor(buckets=(4,))
    np.testing.assert_allclose(pred.predict(x), jpred.predict(x),
                               rtol=TOL, atol=TOL)


def test_bucketing_module_predicts_and_hands_out_ndarrays():
    p = _params(7)

    def sym_gen_of(pkg):
        def sym_gen(key):
            return _mlp(pkg), ("data",), ("softmax_label",)
        return sym_gen

    rng = np.random.RandomState(8)
    data = rng.randn(6, 5).astype(np.float32)
    got = {}
    for pkg in (jmx, tmx):
        kw = {"context": tmx.cpu()} if pkg is tmx else {}
        m = pkg.mod.BucketingModule(sym_gen_of(pkg), default_bucket_key=5,
                                    **kw)
        m.bind([("data", (4, 5))], [("softmax_label", (4,))],
               for_training=False)
        m.set_params({k: _nd(pkg, v) for k, v in p.items()}, {})
        out = m.predict(pkg.io.NDArrayIter(data, batch_size=4))
        m.forward(pkg.io.DataBatch([_nd(pkg, data[:4])], []),
                  is_train=False)
        assert isinstance(m.get_outputs()[0], pkg.nd.NDArray)
        got[pkg] = out.asnumpy()
    assert got[tmx].shape == (6, 3)
    np.testing.assert_allclose(got[tmx], got[jmx], rtol=TOL, atol=TOL)


def test_bf16_fused_step_keeps_float_labels():
    """A bf16 fused step casts data, not labels: class 999 as a float32
    label stays 999 (bf16 would round it to 1000, out of range)."""
    x = tmx.sym.Variable("data")
    x = tmx.sym.FullyConnected(x, num_hidden=1000, name="fc")
    net = tmx.sym.SoftmaxOutput(x, name="softmax")
    m = tmx.mod.Module(net, context=tmx.cpu(), fused=True,
                       compute_dtype="bfloat16")
    m.bind([("data", (2, 4))], [("softmax_label", (2,))])
    m.init_params(tmx.init.Xavier())
    m.init_optimizer(optimizer="sgd",
                     optimizer_params={"learning_rate": 0.0})
    lab = np.array([999, 3], np.float32)
    x = np.random.RandomState(9).randn(2, 4).astype(np.float32)
    m.forward(tmx.io.DataBatch([_nd(tmx, x)], [_nd(tmx, lab)]),
              is_train=True)
    m.update()
    p = m.get_outputs()[0].asnumpy()
    want = -np.log(p[[0, 1], [999, 3]]).sum()
    np.testing.assert_allclose(float(m._fused.last_loss), want, rtol=2e-2)
