"""The port's ``gluon.rnn`` layers and cells and the Gluon ``Embedding`` /
``Dropout`` layers against the JAX package's, on the CPU (mirrors
``tests/test_rnn.py``).

Each JAX block is built with an explicit prefix, initialized and run
once (deferred shapes), and its parameters are carried onto the port's
block of the same prefix with ``interop.gluon_params_from_jax``; then
the same seeded numpy inputs go through both, the port inside
``with mxnet_tpu_torch.cpu():``. Tolerances (fp32): outputs and states
within 1e-5 relative + 1e-5 absolute (the fused layers' input product
runs over all steps at once in the port); parameter gradients of
``sum(out * ct)`` under ``autograd.record()`` within 1e-4 relative +
1e-5 absolute.

- ``LSTM``, ``GRU``, ``RNN`` (relu and tanh): 1 and 2 layers, one and
  two directions, layouts TNC and NTC, with and without begin states;
  parameter names and shapes equal the JAX package's.
- ``RNNCell``, ``LSTMCell``, ``GRUCell`` unrolled in both layouts, merged
  and per step; ``SequentialRNNCell`` with ``ResidualCell`` and
  ``DropoutCell``; ``BidirectionalCell``; ``ZoneoutCell`` in predict
  mode; ``valid_length`` masking.
- The fused LSTM equals a step-by-step ``LSTMCell`` with its weights
  (as the JAX test); every parameter of a 2-layer LSTM gets a gradient.
- ``Embedding`` forward and weight gradient; ``Dropout`` the identity in
  predict mode and inverted dropout in training.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon import rnn as jrnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn
from torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return x.asnumpy()


def _carry(jblock, tblock):
    params = {n: p.data().asnumpy()
              for n, p in jblock.collect_params().items()}
    mt.interop.gluon_params_from_jax(params, tblock, "cpu")
    return params


def _run_both(jblock, tblock, x, states=None, ct_seed=1, train=True):
    """Forward both (and backward of sum(out * ct) with the same ct),
    recorded in training mode or, with ``train=False``, in predict mode
    (dropout off): ((jax outs), (port outs), jax grads, port grads)."""
    jx = jmx.nd.array(x)
    jstates = [jmx.nd.array(s) for s in states] if states else None
    with jmx.autograd.record(train_mode=train):
        jout = jblock(jx, jstates) if jstates is not None else jblock(jx)
    jo = jout[0] if isinstance(jout, tuple) else jout
    ct = np.random.RandomState(ct_seed).randn(*jo.shape).astype(np.float32)
    with jmx.autograd.record(train_mode=train):
        jout = jblock(jx, jstates) if jstates is not None else jblock(jx)
        jo = jout[0] if isinstance(jout, tuple) else jout
        loss = (jo * jmx.nd.array(ct)).sum()
    loss.backward()
    jgrads = {n: p.grad().asnumpy()
              for n, p in jblock.collect_params().items()}
    with mt.cpu():
        _carry(jblock, tblock)
        tx = mt.nd.array(x)
        tstates = [mt.nd.array(s) for s in states] if states else None
        with mt.autograd.record(train_mode=train):
            tout = tblock(tx, tstates) if tstates is not None \
                else tblock(tx)
            to = tout[0] if isinstance(tout, tuple) else tout
            tloss = (to * mt.nd.array(ct)).sum()
        tloss.backward()
        tgrads = {n: p.grad().asnumpy()
                  for n, p in tblock.collect_params().items()}
    return jout, tout, jgrads, tgrads


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [_np(out)]


LAYERS = [(cls, nl, bi, layout)
          for cls in ("LSTM", "GRU", "RNN_relu", "RNN_tanh")
          for nl in (1, 2) for bi in (False, True)
          for layout in ("TNC", "NTC")]


def _layer(pkg, cls, nl, bi, layout):
    if cls.startswith("RNN"):
        return pkg.RNN(6, num_layers=nl, activation=cls[4:], layout=layout,
                       bidirectional=bi, prefix="rnn_")
    return getattr(pkg, cls)(6, num_layers=nl, layout=layout,
                             bidirectional=bi, prefix="rnn_")


@pytest.mark.parametrize("cls,nl,bi,layout", LAYERS)
def test_layer_matches_jax(cls, nl, bi, layout):
    jl = _layer(jrnn, cls, nl, bi, layout)
    jl.initialize(jmx.init.Xavier())
    with mt.cpu():
        tl = _layer(trnn, cls, nl, bi, layout)
        tl.initialize()
    rng = np.random.RandomState(0)
    x = rng.randn(*((5, 3, 4) if layout == "TNC" else (3, 5, 4))) \
        .astype(np.float32)
    jl(jmx.nd.array(x))                    # deferred shapes
    jo, to, jg, tg = _run_both(jl, tl, x)
    assert sorted(tl.collect_params().keys()) == \
        sorted(jl.collect_params().keys())
    for n, p in tl.collect_params().items():
        assert p.shape == jl.collect_params()[n].shape
    np.testing.assert_allclose(_np(to), _np(jo), **FWD)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **GRAD)


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "RNN_tanh"])
def test_layer_with_states_matches_jax(cls):
    jl = _layer(jrnn, cls, 2, True, "NTC")
    jl.initialize(jmx.init.Xavier())
    with mt.cpu():
        tl = _layer(trnn, cls, 2, True, "NTC")
        tl.initialize()
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 4).astype(np.float32)
    n_states = 2 if cls == "LSTM" else 1
    states = [(0.5 * rng.randn(4, 3, 6)).astype(np.float32)
              for _ in range(n_states)]
    jl(jmx.nd.array(x))
    jo, to, jg, tg = _run_both(jl, tl, x, states)
    assert len(to[1]) == n_states
    for a, b in zip(_flat(to), _flat(jo)):
        np.testing.assert_allclose(a, b, **FWD)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **GRAD)
    with mt.cpu():
        st = tl.begin_state(3)
    assert [s.shape for s in st] == [(4, 3, 6)] * n_states


CELLS = [(cls, layout, merge) for cls in ("RNNCell", "LSTMCell", "GRUCell")
         for layout in ("TNC", "NTC") for merge in (True, False)]


class _Unroll:
    """A cell's unroll as a block call, for ``_run_both``."""

    def __init__(self, cell, length, layout, merge, valid=None):
        self.cell, self.length, self.layout, self.merge = \
            cell, length, layout, merge
        self.valid = valid

    def collect_params(self):
        return self.cell.collect_params()

    def __call__(self, x, states=None):
        outs, st = self.cell.unroll(self.length, x, begin_state=states,
                                    layout=self.layout,
                                    merge_outputs=self.merge,
                                    valid_length=self.valid)
        if not self.merge:
            outs = _stack(outs, self.layout)
        return outs, st


def _stack(outs, layout):
    axis = layout.find("T")
    pkg = jmx if type(outs[0]).__module__.startswith("mxnet_tpu.") else mt
    return pkg.nd.concat(*[o.expand_dims(axis) for o in outs], dim=axis)


@pytest.mark.parametrize("cls,layout,merge", CELLS)
def test_cell_unroll_matches_jax(cls, layout, merge):
    jc = getattr(jrnn, cls)(6, input_size=4, prefix="cell_")
    jc.initialize(jmx.init.Xavier())
    with mt.cpu():
        tc = getattr(trnn, cls)(6, input_size=4, prefix="cell_")
        tc.initialize()
    x = np.random.RandomState(4).randn(
        *((5, 3, 4) if layout == "TNC" else (3, 5, 4))).astype(np.float32)
    jo, to, jg, tg = _run_both(_Unroll(jc, 5, layout, merge),
                               _Unroll(tc, 5, layout, merge), x)
    for a, b in zip(_flat(to), _flat(jo)):
        np.testing.assert_allclose(a, b, **FWD)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **GRAD)


def _stack_cells(pkg):
    cell = pkg.SequentialRNNCell(prefix="seq_")
    with cell.name_scope():
        cell.add(pkg.LSTMCell(8, input_size=8))
        cell.add(pkg.ResidualCell(pkg.GRUCell(8, input_size=8)))
        cell.add(pkg.DropoutCell(0.3))
    return cell


def test_sequential_residual_dropout_cells_match_jax():
    jc = _stack_cells(jrnn)
    jc.collect_params().initialize(jmx.init.Xavier())
    with mt.cpu():
        tc = _stack_cells(trnn)
        tc.collect_params().initialize()
    x = np.random.RandomState(5).randn(2, 4, 8).astype(np.float32)
    jo, to, jg, tg = _run_both(_Unroll(jc, 4, "NTC", True),
                               _Unroll(tc, 4, "NTC", True), x, train=False)
    with mt.cpu():
        assert len(tc.begin_state(batch_size=2)) == 3
    for a, b in zip(_flat(to), _flat(jo)):
        np.testing.assert_allclose(a, b, **FWD)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **GRAD)


def test_bidirectional_cell_matches_jax():
    def build(pkg):
        return pkg.BidirectionalCell(
            pkg.LSTMCell(4, input_size=3, prefix="l_"),
            pkg.LSTMCell(4, input_size=3, prefix="r_"))
    jc = build(jrnn)
    jc.collect_params().initialize(jmx.init.Xavier())
    with mt.cpu():
        tc = build(trnn)
        tc.collect_params().initialize()
    x = np.random.RandomState(6).randn(2, 5, 3).astype(np.float32)
    jo, to, jg, tg = _run_both(_Unroll(jc, 5, "NTC", True),
                               _Unroll(tc, 5, "NTC", True), x)
    assert to[0].shape == (2, 5, 8)
    for a, b in zip(_flat(to), _flat(jo)):
        np.testing.assert_allclose(a, b, **FWD)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **GRAD)


def test_zoneout_predict_mode_and_valid_length_match_jax():
    def build(pkg):
        return pkg.ZoneoutCell(pkg.RNNCell(4, input_size=4, prefix="z_"),
                               zoneout_outputs=0.3, zoneout_states=0.5)
    jc = build(jrnn)
    jc.base_cell.initialize(jmx.init.Xavier())
    with mt.cpu():
        tc = build(trnn)
        tc.base_cell.initialize()
    x = np.random.RandomState(7).randn(3, 4, 4).astype(np.float32)
    jo, to, _, _ = _run_both(_Unroll(jc, 4, "NTC", True),
                             _Unroll(tc, 4, "NTC", True), x, train=False)
    for a, b in zip(_flat(to), _flat(jo)):
        np.testing.assert_allclose(a, b, **FWD)
    # valid_length: outputs past a sequence's end are 0, states frozen
    jl = jrnn.LSTMCell(5, input_size=4, prefix="v_")
    jl.initialize(jmx.init.Xavier())
    with mt.cpu():
        tl = trnn.LSTMCell(5, input_size=4, prefix="v_")
        tl.initialize()
    valid = np.array([4, 2, 1], np.float32)
    jo = jl.unroll(4, jmx.nd.array(x), layout="NTC", merge_outputs=True,
                   valid_length=jmx.nd.array(valid))
    with mt.cpu():
        _carry(jl, tl)
        to = tl.unroll(4, mt.nd.array(x), layout="NTC", merge_outputs=True,
                       valid_length=mt.nd.array(valid))
    for a, b in zip(_flat(to), _flat(jo)):
        np.testing.assert_allclose(a, b, **FWD)
    assert np.all(_np(to[0])[1, 2:] == 0)


def test_lstm_matches_manual_cell():
    """The fused LSTM equals a step-by-step LSTMCell with its weights."""
    with mt.cpu():
        mt.random.seed(0)
        layer = trnn.LSTM(6, input_size=4)
        layer.initialize(mt.init.Xavier())
        x = mt.nd.array(np.random.RandomState(0).randn(3, 2, 4)
                        .astype(np.float32))
        h0 = [mt.nd.zeros((1, 2, 6)), mt.nd.zeros((1, 2, 6))]
        out, _ = layer(x, h0)
        cell = trnn.LSTMCell(6, input_size=4, prefix="cell_")
        cell.initialize()
        for nm in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
            getattr(cell, nm).set_data(getattr(layer, "l0_" + nm).data())
        outputs, _ = cell.unroll(3, x, layout="TNC", merge_outputs=False)
    manual = np.stack([o.asnumpy() for o in outputs])
    np.testing.assert_allclose(out.asnumpy(), manual, **FWD)


def test_every_lstm_parameter_gets_a_gradient():
    with mt.cpu():
        layer = trnn.LSTM(8, num_layers=2)
        layer.initialize()
        x = mt.nd.array(np.random.RandomState(0).randn(4, 2, 6)
                        .astype(np.float32))
        with mt.autograd.record():
            loss = layer(x).sum()
        loss.backward()
        for name, p in layer.collect_params().items():
            assert np.abs(p.grad().asnumpy()).sum() > 0, name


def test_embedding_layer_matches_jax():
    je = jnn.Embedding(20, 5, prefix="emb_")
    je.initialize(jmx.init.Uniform(0.1))
    with mt.cpu():
        te = tnn.Embedding(20, 5, prefix="emb_")
        te.initialize()
    ids = np.random.RandomState(8).randint(0, 20, (4, 7)).astype(np.float32)
    jo, to, jg, tg = _run_both(je, te, ids)
    np.testing.assert_allclose(_np(to), _np(jo), **FWD)
    np.testing.assert_allclose(tg["emb_weight"], jg["emb_weight"], **GRAD)
    assert repr(te) == repr(je)


def test_dropout_layer():
    with mt.cpu():
        d = tnn.Dropout(0.4)
        x = mt.nd.ones((200, 100))
        np.testing.assert_array_equal(d(x).asnumpy(), x.asnumpy())
        mt.random.seed(1)
        with mt.autograd.record():
            y = d(x).asnumpy()
    kept = y != 0
    assert abs(kept.mean() - 0.6) < 0.01
    np.testing.assert_allclose(y[kept], 1 / 0.6, rtol=1e-6)
    assert repr(d) == repr(jnn.Dropout(0.4))
