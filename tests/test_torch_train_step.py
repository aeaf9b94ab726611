"""The port's ``parallel.TrainStep`` against the JAX package's, on the CPU.

The same Gluon model is built in both packages with the same prefixes,
the JAX package's initial parameters are carried onto the port's
(``interop.gluon_params_from_jax``), and both steps run over the same
seeded numpy batches. Tolerances: fp32 losses within 1e-5 relative +
1e-6 absolute, parameters after three steps within 1e-4 relative +
1e-5 absolute (the products run in another order; the LSTM's input
product is one matmul over all steps in the port); bf16 within 2e-2
relative + 2e-2 absolute (each package rounds at other places).

- A small LSTM LM (``Embedding`` -> 2-layer ``rnn.LSTM`` -> ``Dense``,
  the bench_lstm model at vocab 30, widths 8 / 12) over three steps,
  with sgd + momentum and with adam; ``compute_dtype="bfloat16"``; an
  ``lr_schedule``; ``remat`` (also bit for bit the step without it).
- A ``HybridSequential`` with ``BatchNorm``: the running statistics
  folded by the step, and ``lr_mult`` / ``wd_mult``.
- ``sync_params`` copies the masters into the net; deferred parameters
  are materialised by the first call; ``mesh`` / ``param_spec_fn`` /
  ``partition_rules`` raise; ``remat`` with Dropout raises; Dropout in
  the staged forward draws from the generator; ``staged_forward``
  returns the BatchNorm writes and leaves the Parameters as they were.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.gluon as jgluon
from mxnet_tpu.parallel.step import TrainStep as JTrainStep

import mxnet_tpu_torch as mt
import mxnet_tpu_torch.gluon as tgluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import TrainStep
from torch_threads import one_torch_thread  # noqa: F401

LOSS = dict(rtol=1e-5, atol=1e-6)
PARAM = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
V, E, H, B, T = 30, 8, 12, 4, 6


def _lm(gluon):
    class LM(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = gluon.nn.Embedding(V, E)
                self.lstm = gluon.rnn.LSTM(H, num_layers=2, layout="NTC",
                                           input_size=E)
                self.decoder = gluon.nn.Dense(V, flatten=False, in_units=H)

        def hybrid_forward(self, F, x):
            return self.decoder(self.lstm(self.embed(x))).reshape((-1, V))
    return LM(prefix="lm_")


def _bn_net(gluon):
    net = gluon.nn.HybridSequential(prefix="bn_")
    with net.name_scope():
        net.add(gluon.nn.Dense(16, in_units=10),
                gluon.nn.BatchNorm(in_channels=16),
                gluon.nn.Activation("relu"), gluon.nn.Dense(5, in_units=16))
    return net


def _pair(build, seed=0):
    jmx.random.seed(seed)
    jnet = build(jgluon)
    jnet.initialize(jmx.init.Xavier())
    with mt.cpu():
        tnet = build(tgluon)
        tnet.initialize()
    params = {n: p.data().asnumpy()
              for n, p in jnet.collect_params().items()}
    mt.interop.gluon_params_from_jax(params, tnet, "cpu")
    return jnet, tnet


def _lm_batches(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, V, (B, T)).astype(np.int32),
             rng.randint(0, V, (B * T,)).astype(np.int32))
            for _ in range(n)]


def _bn_batches(n=3, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 10).astype(np.float32),
             rng.randint(0, 5, (8,)).astype(np.int32)) for _ in range(n)]


def _run(jstep, tstep, batches):
    jl, tl = [], []
    for x, y in batches:
        jl.append(float(jstep(jmx.nd.array(x, dtype=x.dtype),
                              jmx.nd.array(y, dtype=y.dtype)).asnumpy()))
        with mt.cpu():
            tl.append(float(tstep(mt.nd.array(x, dtype=x.dtype),
                                  mt.nd.array(y, dtype=y.dtype)).asnumpy()))
    jstep.sync_params()
    tstep.sync_params()
    return jl, tl


def _params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _assert_same(jnet, tnet, jl, tl, loss_tol, param_tol):
    np.testing.assert_allclose(tl, jl, **loss_tol)
    jp, tp = _params(jnet), _params(tnet)
    assert set(jp) == set(tp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], err_msg=n, **param_tol)


OPTS = {"sgd": {"momentum": 0.9}, "adam": {}}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_lstm_lm_steps_match_jax(opt):
    jnet, tnet = _pair(_lm)
    kw = dict(optimizer=opt, optimizer_params=dict(OPTS[opt], wd=1e-4),
              lr=0.1 if opt == "sgd" else 0.01)
    jl, tl = _run(JTrainStep(jnet, **kw), TrainStep(tnet, **kw),
                  _lm_batches())
    assert tl[-1] < tl[0]
    _assert_same(jnet, tnet, jl, tl, LOSS, PARAM)


def test_lstm_lm_bf16_matches_jax():
    jnet, tnet = _pair(_lm)
    kw = dict(optimizer="sgd", optimizer_params={"momentum": 0.9}, lr=0.1,
              compute_dtype="bfloat16")
    tstep = TrainStep(tnet, **kw)
    jl, tl = _run(JTrainStep(jnet, **kw), tstep, _lm_batches())
    # the masters stay fp32
    assert all(p.dtype == torch.float32 for p in tstep._p)
    _assert_same(jnet, tnet, jl, tl, BF16, BF16)


def test_lr_schedule_matches_jax():
    jnet, tnet = _pair(_lm)

    def sched(n):
        return 0.2 * 0.5 ** n

    kw = dict(optimizer="sgd", optimizer_params={"momentum": 0.5},
              lr_schedule=sched)
    tstep = TrainStep(tnet, **kw)
    jl, tl = _run(JTrainStep(jnet, **kw), tstep, _lm_batches())
    assert tstep._lr_host == sched(2) and tstep.num_update == 3
    assert int(tstep._t) == 3
    _assert_same(jnet, tnet, jl, tl, LOSS, PARAM)


def test_remat_matches_jax_and_plain_step():
    jnet, tnet = _pair(_lm)
    kw = dict(optimizer="adam", lr=0.01)
    jl, tl = _run(JTrainStep(jnet, remat=True, **kw),
                  TrainStep(tnet, remat=True, **kw), _lm_batches())
    _assert_same(jnet, tnet, jl, tl, LOSS, PARAM)
    _, tnet2 = _pair(_lm)
    step = TrainStep(tnet2, remat=False, **kw)
    with mt.cpu():
        tl2 = [float(step(mt.nd.array(x, dtype=x.dtype),
                          mt.nd.array(y, dtype=y.dtype)).asnumpy())
               for x, y in _lm_batches()]
    step.sync_params()
    assert tl2 == tl
    for n, v in _params(tnet2).items():
        np.testing.assert_array_equal(v, _params(tnet)[n])


def test_batchnorm_fold_and_mults_match_jax():
    jnet, tnet = _pair(_bn_net)
    for net in (jnet, tnet):
        net.collect_params()["bn_dense0_weight"].lr_mult = 0.5
        net.collect_params()["bn_dense1_bias"].wd_mult = 0.0
    kw = dict(optimizer="sgd", optimizer_params={"momentum": 0.9,
                                                 "wd": 1e-3}, lr=0.1)
    jl, tl = _run(JTrainStep(jnet, **kw), TrainStep(tnet, **kw),
                  _bn_batches())
    _assert_same(jnet, tnet, jl, tl, LOSS, PARAM)
    start = _pair(_bn_net)[1]
    for n in ("bn_batchnorm0_running_mean", "bn_batchnorm0_running_var"):
        assert not np.allclose(_params(tnet)[n], _params(start)[n])


def test_sync_params_and_deferred_init():
    with mt.cpu():
        net = tgluon.nn.HybridSequential(prefix="d_")
        with net.name_scope():
            net.add(tgluon.nn.Dense(7), tgluon.nn.Dense(3))
        net.initialize()
        step = TrainStep(net, optimizer="sgd", lr=0.5)
        x, y = _bn_batches(1)[0]
        # the first call materialises the deferred shapes (x[:1])
        step(mt.nd.array(x), mt.nd.array(y % 3, dtype="int32"))
        w = net[0].weight
        assert w.shape == (7, 10)
        before = w.data().asnumpy().copy()
        master = step._p[step._index[id(w)]].numpy().copy()
        # the step trains masters of its own ...
        assert not np.array_equal(before, master)
        step.sync_params()
        # ... and sync_params copies them into the net
        np.testing.assert_array_equal(w.data().asnumpy(), master)


@pytest.mark.parametrize("kw", [{"mesh": object()},
                                {"param_spec_fn": lambda p: None},
                                {"partition_rules": [("w", None)]}])
def test_mesh_raises(kw):
    with mt.cpu():
        net = _lm(tgluon)
    with pytest.raises(NotImplementedError, match="A10"):
        TrainStep(net, **kw)


def _dropout_net(gluon):
    net = gluon.nn.HybridSequential(prefix="do_")
    with net.name_scope():
        net.add(gluon.nn.Dense(32, in_units=10), gluon.nn.Dropout(0.5),
                gluon.nn.Dense(5, in_units=32))
    return net


def test_dropout_in_step_and_remat_with_dropout_raises():
    x, y = _bn_batches(1)[0]
    with mt.cpu():
        net = _dropout_net(tgluon)
        net.initialize()
        mt.random.seed(0)
        a = TrainStep(net, optimizer="sgd", lr=0.0)
        la = float(a(mt.nd.array(x), mt.nd.array(y, dtype="int32"))
                   .asnumpy())
        mt.random.seed(0)
        b = TrainStep(net, optimizer="sgd", lr=0.0)
        lb = float(b(mt.nd.array(x), mt.nd.array(y, dtype="int32"))
                   .asnumpy())
        lc = float(b(mt.nd.array(x), mt.nd.array(y, dtype="int32"))
                   .asnumpy())
        # lr 0: only the masks differ between calls
        assert la == lb and lc != lb
        r = TrainStep(net, optimizer="sgd", lr=0.1, remat=True)
        with pytest.raises(MXNetError, match="remat"):
            r(mt.nd.array(x), mt.nd.array(y, dtype="int32"))


def test_staged_forward_returns_writes_and_restores():
    with mt.cpu():
        net = _bn_net(tgluon)
        net.initialize()
        staged = net.staged_forward(training=True)
        plist = net._get_param_list()
        assert [p.name for p in plist] == sorted(
            net.collect_params().keys())
        before = {p.name: p.data().asnumpy().copy() for p in plist}
        pv = [torch.tensor(v) * 2 for v in before.values()]
        x = torch.tensor(_bn_batches(1)[0][0])
        outs, writes = staged(pv, (x,))
        assert outs[0].shape == (8, 5)
        assert sorted(p.name for p, _ in writes) == [
            "bn_batchnorm0_running_mean", "bn_batchnorm0_running_var"]
        for p in plist:
            np.testing.assert_array_equal(p.data().asnumpy(),
                                          before[p.name])
        # predict mode: no writes, the moving statistics are read
        outs2, writes2 = net.staged_forward(training=False)(pv, (x,))
        assert writes2 == []
