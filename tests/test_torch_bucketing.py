"""The port's ``BucketingModule``, ``rnn.FusedRNNCell`` and
``rnn.BucketSentenceIter`` against the JAX package's, on the CPU
(mirrors ``tests/test_bucketing_lm.py`` and
``tests/test_fused_rnn_cell.py``).

- ``BucketingModule`` over the lstm_bucketing example's ``sym_gen``: a
  bucket first seen after ``init_optimizer`` trains; every bucket's
  parameter arrays are the default bucket's and one optimizer drives
  them; the default bucket keeps its own data and label arrays; four
  steps over two buckets from the JAX package's initial parameters
  match the JAX package's outputs (1e-5) and gradients and parameters
  (1e-4 relative + 1e-5 absolute) step by step.
- Equal buckets share their programs by key: identical symbols and
  shapes under two bucket keys give one program key and one
  ``_Programs`` object (``compile.shared_programs``).
- ``FusedRNNCell`` (lstm, gru, rnn_tanh; 2 layers; one and two
  directions) unrolled through ``sym.RNN`` and bound: outputs equal the
  JAX symbol's on the same weights (1e-5), and the bound training
  gradients of the flat vector (1e-4); ``get_next_state``;
  ``unpack_weights`` / ``pack_weights`` round trip bit for bit and give
  the JAX package's per-gate arrays; ``unfuse()`` gives the JAX
  package's stack of cells, and its output equals the fused cell's
  (1e-5 here; the JAX test allows 2e-2 for its reduced-precision CPU
  matmuls); the ``FusedRNN`` initializer's forget-gate biases.
- ``BucketSentenceIter`` gives the JAX package's batches (data, label,
  bucket key, in order) for the same seeds, across a reset.
"""
import os
import random
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples.rnn import lstm_bucketing as tlb
from torch_threads import one_torch_thread  # noqa: F401

EXAMPLE_DIR = os.path.join(os.path.dirname(__file__), "..", "examples",
                           "rnn")
sys.path.insert(0, os.path.abspath(EXAMPLE_DIR))
import lstm_bucketing as jlb  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _np(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else v.detach().cpu().numpy()


def _modules(batch=8, vocab=50, hidden=32, embed=32, default=20):
    mods = []
    for pkg, lb in ((jmx, jlb), (mt, tlb)):
        sg = lb.sym_gen_factory(vocab, embed, hidden, 2, batch)
        mods.append(pkg.mod.BucketingModule(sg, default_bucket_key=default,
                                            context=pkg.cpu()))
    return mods


def _batch(pkg, d, key):
    ctx = {"ctx": pkg.cpu()} if pkg is mt else {}
    return pkg.io.DataBatch(
        [pkg.nd.array(d, **ctx)], [pkg.nd.array(np.roll(d, -1, 1), **ctx)],
        bucket_key=key, provide_data=[("data", d.shape)],
        provide_label=[("softmax_label", d.shape)])


def test_buckets_share_params_and_one_optimizer_and_match_jax():
    batch = 8
    jmod, tmod = _modules(batch)
    for m in (jmod, tmod):
        m.bind([("data", (batch, 20))], [("softmax_label", (batch, 20))])
    jmx.random.seed(0)
    jmod.init_params(jmx.init.Xavier())
    jarg, _ = jmod.get_params()
    # the flat lstm_parameters vector carries over by name
    targ, _ = mt.interop.params_from_jax(jarg, {}, "cpu")
    tmod.init_params(mt.init.Xavier(), arg_params=targ, force_init=True)
    for m in (jmod, tmod):
        m.init_optimizer(optimizer="adam",
                         optimizer_params={"learning_rate": 0.01})
    rng = np.random.RandomState(0)
    for key in (20, 10, 20, 10):          # bucket 10 is new after init
        d = rng.randint(1, 50, (batch, key)).astype(np.float32)
        outs = []
        for m, pkg in ((jmod, jmx), (tmod, mt)):
            m.forward(_batch(pkg, d, key), is_train=True)
            m.backward()
            g = m._curr_module._exec.grad_dict["lstm_parameters"]
            outs.append((_np(m.get_outputs()[0]), _np(g)))
            m.update()
        np.testing.assert_allclose(outs[1][0], outs[0][0], **FWD)
        np.testing.assert_allclose(outs[1][1], outs[0][1], **GRAD)
    jp, _ = jmod.get_params()
    tp, _ = tmod.get_params()
    for k in jp:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), err_msg=k,
                                   **GRAD)
    b10, b20 = tmod._buckets[10], tmod._buckets[20]
    for name in ("embed_weight", "lstm_parameters", "pred_weight"):
        assert b10._exec.arg_dict[name]._data.data_ptr() == \
            b20._exec.arg_dict[name]._data.data_ptr()
    assert b10._optimizer is b20._optimizer
    assert b10._updater is b20._updater
    # the default bucket keeps its own input arrays
    assert b20._exec.arg_dict["data"].shape == (batch, 20)
    assert b10._exec.arg_dict["data"].shape == (batch, 10)


def test_equal_buckets_share_programs_by_key():
    def sym_gen(bucket_key):
        data = mt.sym.Variable("data")
        h = mt.sym.FullyConnected(data, num_hidden=16, name="fc1")
        h = mt.sym.Activation(h, act_type="relu", name="act1")
        h = mt.sym.FullyConnected(h, num_hidden=8, name="fc2")
        return (mt.sym.SoftmaxOutput(h, name="softmax"), ("data",),
                ("softmax_label",))

    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key="a",
                                 context=mt.cpu())
    mod.bind([("data", (4, 12))], [("softmax_label", (4,))])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05})
    rng = np.random.RandomState(0)
    w0 = _np(mod.get_params()[0]["fc1_weight"]).copy()
    for key in ("a", "b", "a", "b"):
        b = mt.io.DataBatch(
            [mt.nd.array(rng.rand(4, 12).astype(np.float32), ctx="cpu")],
            [mt.nd.array(rng.randint(0, 8, (4,)).astype(np.float32),
                         ctx="cpu")], bucket_key=key,
            provide_data=[("data", (4, 12))],
            provide_label=[("softmax_label", (4,))])
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
    ea, eb = mod._buckets["a"]._exec, mod._buckets["b"]._exec
    assert ea._key.digest == eb._key.digest
    assert ea._progs is eb._progs and eb.shared
    assert not np.array_equal(_np(mod.get_params()[0]["fc1_weight"]), w0)


def _fused_pair(mode, bi, get_next_state=False, T=5, layout="NTC"):
    outs = []
    for pkg in (jmx, mt):
        cell = pkg.rnn.FusedRNNCell(6, num_layers=2, mode=mode,
                                    bidirectional=bi, prefix=f"{mode}_",
                                    get_next_state=get_next_state)
        out, states = cell.unroll(T, pkg.sym.Variable("data"),
                                  layout=layout, merge_outputs=True)
        outs.append((cell, pkg.sym.Group([out] + states)
                     if get_next_state else out))
    return outs


@pytest.mark.parametrize("mode,bi", [(m, b) for m in ("lstm", "gru",
                                                      "rnn_tanh")
                                     for b in (False, True)])
def test_fused_rnn_cell_matches_jax_symbol(mode, bi):
    (jc, jsym), (tc, tsym) = _fused_pair(mode, bi)
    assert tsym.list_arguments() == jsym.list_arguments()
    n, t, c = 3, 5, 4
    jex = jsym.simple_bind(jmx.cpu(), data=(n, t, c))
    init = jmx.init.Xavier()
    for name, arr in jex.arg_dict.items():
        if name != "data":
            init(jmx.init.InitDesc(name, attrs=jsym.attr_dict().get(name, {}),
                                   global_init=init), arr)
    x = np.random.RandomState(0).randn(n, t, c).astype(np.float32)
    pname = f"{mode}_parameters"
    flat = jex.arg_dict[pname].asnumpy()
    ct = np.random.RandomState(1).randn(n, t, 12 if bi else 6) \
        .astype(np.float32)
    jy = jex.forward(is_train=True, data=x)[0].asnumpy()
    jex.backward([jmx.nd.array(ct)])
    tex = tsym.simple_bind("cpu", data=(n, t, c))
    ty = tex.forward(is_train=True, data=x, **{pname: flat})[0].asnumpy()
    tex.backward([mt.nd.array(ct, ctx="cpu")])
    np.testing.assert_allclose(ty, jy, **FWD)
    np.testing.assert_allclose(tex.grad_dict[pname].asnumpy(),
                               jex.grad_dict[pname].asnumpy(), **GRAD)
    np.testing.assert_allclose(tex.grad_dict["data"].asnumpy(),
                               jex.grad_dict["data"].asnumpy(), **GRAD)


def test_get_next_state_matches_jax():
    (jc, jsym), (tc, tsym) = _fused_pair("lstm", False, True, T=3,
                                         layout="TNC")
    size = mt.ops.nn.rnn_param_size("lstm", 2, 4, 6)
    flat = np.random.RandomState(2).uniform(-0.3, 0.3, size) \
        .astype(np.float32)
    x = np.random.RandomState(3).randn(3, 2, 4).astype(np.float32)
    jo = jsym.simple_bind(jmx.cpu(), data=(3, 2, 4)).forward(
        data=x, lstm_parameters=flat)
    to = tsym.simple_bind("cpu", data=(3, 2, 4), grad_req="null").forward(
        data=x, lstm_parameters=flat)
    assert [o.shape for o in to] == [(3, 2, 6), (2, 2, 6), (2, 2, 6)]
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **FWD)


def test_pack_unpack_roundtrip_and_jax_names():
    h, layers, c = 6, 2, 4
    size = mt.ops.nn.rnn_param_size("lstm", layers, c, h)
    vec = np.random.RandomState(0).randn(size).astype(np.float32)
    tcell = mt.rnn.FusedRNNCell(h, num_layers=layers, mode="lstm",
                                prefix="lstm_")
    jcell = jmx.rnn.FusedRNNCell(h, num_layers=layers, mode="lstm",
                                 prefix="lstm_")
    tun = tcell.unpack_weights({"lstm_parameters":
                                mt.nd.array(vec, ctx="cpu")})
    jun = jcell.unpack_weights({"lstm_parameters": jmx.nd.array(vec)})
    assert sorted(tun) == sorted(jun) and "lstm_parameters" not in tun
    for k in jun:
        np.testing.assert_array_equal(tun[k].asnumpy(), jun[k].asnumpy())
    assert tun["lstm_l1_i2h_f_weight"].shape == (h, h)
    pk = tcell.pack_weights(tun)
    np.testing.assert_array_equal(pk["lstm_parameters"].asnumpy(), vec)
    # torch tensors and numpy arrays are taken too
    pk2 = tcell.pack_weights({k: torch.tensor(v.asnumpy())
                              for k, v in tun.items()})
    np.testing.assert_array_equal(pk2["lstm_parameters"].asnumpy(), vec)


def test_unfuse_structure_gate_split_and_parity():
    fused = mt.rnn.FusedRNNCell(5, num_layers=3, mode="gru", dropout=0.3,
                                prefix="g_")
    jfused = jmx.rnn.FusedRNNCell(5, num_layers=3, mode="gru", dropout=0.3,
                                  prefix="g_")
    kinds = [type(c).__name__ for c in fused.unfuse()._cells]
    assert kinds == [type(c).__name__ for c in jfused.unfuse()._cells] == \
        ["GRUCell", "DropoutCell", "GRUCell", "DropoutCell", "GRUCell"]
    cell = fused.unfuse()._cells[0]
    w = np.random.RandomState(1).randn(15, 4).astype(np.float32)
    un = cell.unpack_weights({"g_l0_i2h_weight": mt.nd.array(w, ctx="cpu")})
    assert un["g_l0_i2h_r_weight"].shape == (5, 4)
    np.testing.assert_array_equal(
        cell.pack_weights(un)["g_l0_i2h_weight"].asnumpy(), w)
    # the unfused stack computes the fused cell's output
    for mode in ("lstm", "gru", "rnn_tanh"):
        fc = mt.rnn.FusedRNNCell(6, num_layers=2, mode=mode,
                                 prefix=f"{mode}_")
        data = mt.sym.Variable("data")
        out_f, _ = fc.unroll(5, data, layout="NTC", merge_outputs=True)
        stack = fc.unfuse()
        out_u, _ = stack.unroll(5, data, layout="NTC", merge_outputs=True)
        pname = f"{mode}_parameters"
        size = mt.ops.nn.rnn_param_size(mode, 2, 4, 6)
        flat = np.random.RandomState(4).uniform(-0.4, 0.4, size) \
            .astype(np.float32)
        x = np.random.RandomState(5).randn(3, 5, 4).astype(np.float32)
        yf = out_f.simple_bind("cpu", data=(3, 5, 4), grad_req="null") \
            .forward(data=x, **{pname: flat})[0].asnumpy()
        ua = stack.pack_weights(fc.unpack_weights(
            {pname: mt.nd.array(flat, ctx="cpu")}))
        exu = out_u.simple_bind("cpu", data=(3, 5, 4), grad_req="null")
        yu = exu.forward(data=x, **{k: v.asnumpy() for k, v in ua.items()
                                    if k in exu.arg_dict})[0].asnumpy()
        np.testing.assert_allclose(yu, yf, err_msg=mode, **FWD)


def test_fused_rnn_initializer_forget_bias():
    h, layers, c = 4, 1, 3
    size = mt.ops.nn.rnn_param_size("lstm", layers, c, h)
    t = torch.zeros(size)
    mt.init.FusedRNN(mt.init.Zero(), h, layers, "lstm", forget_bias=2.5)(
        mt.init.InitDesc("lstm_parameters"), t)
    cell = mt.rnn.FusedRNNCell(h, num_layers=layers, mode="lstm", prefix="")
    un = cell.unpack_weights({"parameters": t})
    np.testing.assert_allclose(un["l0_i2h_f_bias"].asnumpy(), 2.5)
    np.testing.assert_allclose(un["l0_h2h_f_bias"].asnumpy(), 2.5)
    np.testing.assert_allclose(un["l0_i2h_i_bias"].asnumpy(), 0.0)
    np.testing.assert_allclose(un["l0_i2h_i_weight"].asnumpy(), 0.0)


def _batches(it):
    out = []
    for b in it:
        out.append((b.bucket_key, _np(b.data[0]), _np(b.label[0])))
    return out


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_gives_jax_batches(layout):
    rng = np.random.RandomState(0)
    sentences = [list(rng.randint(1, 50, rng.randint(3, 25)))
                 for _ in range(300)]
    got = []
    for pkg in (jmx, mt):
        random.seed(1)
        np.random.seed(1)
        it = pkg.rnn.BucketSentenceIter(sentences, batch_size=8,
                                        buckets=[5, 10, 20],
                                        invalid_label=0, layout=layout)
        first = _batches(it)
        it.reset()
        got.append((first, _batches(it), it.default_bucket_key,
                    [tuple(d.shape) for d in it.provide_data]))
    (jf, js, jk, jp), (tf, ts, tk, tp) = got
    assert (tk, tp) == (jk, jp)
    assert len(tf) == len(jf) > 10
    for (a, b) in ((tf, jf), (ts, js)):
        for (ka, da, la), (kb, db, lb) in zip(a, b):
            assert ka == kb
            np.testing.assert_array_equal(da, db)
            np.testing.assert_array_equal(la, lb)
    key, d, lab = tf[0]
    axis = 1 if layout == "NT" else 0
    assert d.shape[axis] == key
    np.testing.assert_array_equal(np.take(d, range(1, key), axis),
                                  np.take(lab, range(key - 1), axis))
