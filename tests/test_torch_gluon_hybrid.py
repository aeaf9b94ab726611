"""The hybridized ``HybridBlock`` (``gluon/cached_op.py``) against the
JAX package's (one ``jax.jit`` a call, ``jax.vjp`` under ``record()``),
on the CPU, where the port runs the same keyed path eagerly.

The same seeded numpy inputs and parameters (carried by name with
``interop.gluon_params_from_jax``) go through both packages, both
hybridized. Tolerances (fp32): outputs and losses within 1e-5
absolute; each gradient within 1e-4 relative L2, plus 2e-6 in L2 norm
for a gradient that is 0 up to rounding (a convolution's bias in front
of a BatchNorm reads ~1e-7 an element in both packages); running
statistics within 1e-5 (read: all ~1e-7). Cases: an MLP and a conv +
BatchNorm net (forward, parameter and input gradients, and two SGD
steps: parameters and running statistics), a Dropout net in predict
mode, ``rnn.LSTM`` with its states, a block called twice under one
``record()``, tied weights, and deferred initialization. Then the
keying on the port alone: a new input shape makes a new program and a
retrace in ``compile_report()``,
``hybridize(False)`` runs eagerly, and ``cast``, ``load_parameters`` and
a parameter whose storage moved refresh what a hybridized block reads.
"""
import os
import tempfile

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.name import NameManager as JaxNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.name import NameManager as TorchNameManager
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
GRAD_REL_L2 = 1e-4
GRAD_FLOOR = 2e-6
OPT = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.fixture(autouse=True)
def _cpu_scope():
    tmx.compile.reset()
    with tmx.cpu():
        yield


def _mlp(nn):
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"),
                nn.Dense(8, activation="tanh"), nn.Dense(5))
    return net


def _conv_bn(nn):
    net = nn.HybridSequential(prefix="cbn_")
    with net.name_scope():
        net.add(nn.Conv2D(6, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(), nn.Conv2D(4, 3),
                nn.BatchNorm(), nn.Flatten(), nn.Dense(5))
    return net


def _dropout_net(nn):
    net = nn.HybridSequential(prefix="drop_")
    with net.name_scope():
        net.add(nn.Dense(12, activation="relu"), nn.Dropout(0.5),
                nn.Dense(5))
    return net


NETS = {"mlp": (_mlp, (4, 10)), "conv_bn": (_conv_bn, (4, 3, 8, 8)),
        "dropout": (_dropout_net, (4, 10))}


def _params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _pair(build, shape, seed=0, hybridize=True):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    with JaxNameManager():
        jnet = build(jgluon.nn)
    with TorchNameManager():
        tnet = build(tgluon.nn)
    jmx.random.seed(seed)
    jnet.initialize(jmx.init.Xavier())
    jnet(jnd.array(x))
    tmx.interop.gluon_params_from_jax(_params(jnet), tnet, "cpu")
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    return jnet, tnet


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _close_grad(got, want):
    assert np.linalg.norm(got - want) <= \
        GRAD_REL_L2 * np.linalg.norm(want) + GRAD_FLOOR, _rel(got, want)


def _labels(n, classes=5, seed=7):
    return np.random.default_rng(seed).integers(0, classes, n).astype(
        np.float32)


def _step(pkg_nd, ag, gluon, net, x, y, calls=1):
    """One recorded forward (``calls`` times, on row-rolled copies of x)
    and backward; returns (loss, input gradient)."""
    xa = pkg_nd.array(x)
    xa.attach_grad()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with ag.record():
        loss = None
        for k in range(calls):
            xi = xa if k == 0 else pkg_nd.array(np.roll(x, k, axis=0))
            li = loss_fn(net(xi), pkg_nd.array(y))
            loss = li if loss is None else loss + li
    loss.backward()
    return loss.asnumpy(), xa.grad.asnumpy()


@pytest.mark.parametrize("name", ["mlp", "conv_bn"])
def test_hybrid_step_matches_jax(name):
    """Forward in predict mode, then two training steps: the loss, every
    parameter's and the input's gradient, the updated parameters and
    the running statistics."""
    build, shape = NETS[name]
    jnet, tnet = _pair(build, shape)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(tnet(tnd.array(x)).asnumpy(),
                               jnet(jnd.array(x)).asnumpy(), atol=ATOL)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", OPT)
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", OPT)
    for step in range(2):
        xs = np.random.default_rng(10 + step).standard_normal(shape).astype(
            np.float32)
        y = _labels(shape[0], seed=step)
        jl, jgx = _step(jnd, jag, jgluon, jnet, xs, y)
        tl, tgx = _step(tnd, tag, tgluon, tnet, xs, y)
        np.testing.assert_allclose(tl, jl, atol=ATOL)
        _close_grad(tgx, jgx)
        for n, p in tnet.collect_params().items():
            if p.grad_req != "null":
                _close_grad(p.grad().asnumpy(),
                            jnet.collect_params()[n].grad().asnumpy())
        jtr.step(shape[0])
        ttr.step(shape[0])
    want = _params(jnet)
    for n, v in _params(tnet).items():
        np.testing.assert_allclose(v, want[n], atol=ATOL, err_msg=n)
    if name == "conv_bn":
        assert any("running_mean" in n for n in want)


def test_dropout_net_in_predict_mode_matches_jax():
    build, shape = NETS["dropout"]
    jnet, tnet = _pair(build, shape)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = jnet(jnd.array(x)).asnumpy()
    got = tnet(tnd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # recorded in predict mode: dropout is the identity, the gradients
    # are the JAX package's
    y = _labels(shape[0])
    xa_j, xa_t = jnd.array(x), tnd.array(x)
    with jag.record(train_mode=False):
        jl = jgluon.loss.SoftmaxCrossEntropyLoss()(jnet(xa_j), jnd.array(y))
    jl.backward()
    with tag.record(train_mode=False):
        tl = tgluon.loss.SoftmaxCrossEntropyLoss()(tnet(xa_t), tnd.array(y))
    tl.backward()
    np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), atol=ATOL)
    for n, p in tnet.collect_params().items():
        _close_grad(p.grad().asnumpy(),
                    jnet.collect_params()[n].grad().asnumpy())


def test_dropout_in_training_draws_a_mask_a_call():
    build, shape = NETS["dropout"]
    _, tnet = _pair(build, shape)
    x = tnd.array(np.ones(shape, np.float32))
    with tag.train_mode():
        a, b = tnet(x).asnumpy(), tnet(x).asnumpy()
    assert not np.array_equal(a, b)


def _lstm(nn_unused=None, pkg=None):
    return pkg.gluon.rnn.LSTM(8, 2, input_size=5, prefix="lstm_")


def test_lstm_with_states_matches_jax():
    """``rnn.LSTM`` called with its states: the outputs, the new states
    and every gradient. The JAX package's hybridized LSTM fails when
    given its states (``_call_cached`` wraps the state list with
    ``jnp.asarray``: a TypeError; ROADMAP.md queue C), so its LSTM runs
    unhybridized here, the same math."""
    x = np.random.default_rng(3).standard_normal((6, 3, 5)).astype(
        np.float32)
    h0 = np.random.default_rng(4).standard_normal((2, 3, 8)).astype(
        np.float32)
    with JaxNameManager():
        jl = _lstm(pkg=jmx)
    with TorchNameManager():
        tl = _lstm(pkg=tmx)
    jl.initialize(jmx.init.Xavier())
    jl(jnd.array(x), [jnd.array(h0), jnd.array(h0)])
    tmx.interop.gluon_params_from_jax(_params(jl), tl, "cpu")
    tl.hybridize()
    out = {}
    for pkg_nd, ag, layer, key in ((jnd, jag, jl, "j"), (tnd, tag, tl, "t")):
        xa = pkg_nd.array(x)
        xa.attach_grad()
        with ag.record():
            y, (h, c) = layer(xa, [pkg_nd.array(h0), pkg_nd.array(h0 * 0.5)])
            loss = (y * y).sum() + (h * c).sum()
        loss.backward()
        out[key] = ([y.asnumpy(), h.asnumpy(), c.asnumpy()], xa.grad.asnumpy(),
                    {n: p.grad().asnumpy()
                     for n, p in layer.collect_params().items()})
    for g, w in zip(out["t"][0], out["j"][0]):
        np.testing.assert_allclose(g, w, atol=ATOL)
    _close_grad(out["t"][1], out["j"][1])
    for n, g in out["t"][2].items():
        _close_grad(g, out["j"][2][n])


def test_block_called_twice_under_one_record_matches_jax():
    build, shape = NETS["conv_bn"]
    jnet, tnet = _pair(build, shape)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    y = _labels(shape[0])
    jl, jgx = _step(jnd, jag, jgluon, jnet, x, y, calls=2)
    tl, tgx = _step(tnd, tag, tgluon, tnet, x, y, calls=2)
    np.testing.assert_allclose(tl, jl, atol=ATOL)
    _close_grad(tgx, jgx)
    for n, p in tnet.collect_params().items():
        if p.grad_req != "null":
            _close_grad(p.grad().asnumpy(),
                        jnet.collect_params()[n].grad().asnumpy())


class _Tied:
    """An embedding and a decoder sharing one weight, each hybridized."""

    @staticmethod
    def build(pkg):
        nn = pkg.gluon.nn

        class Net(pkg.gluon.Block):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.encoder = nn.Embedding(10, 6)
                    self.decoder = nn.Dense(10, in_units=6,
                                            params=self.encoder.params)

            def forward(self, x):
                return self.decoder(self.encoder(x).reshape((-1, 6)))

        return Net(prefix="tied_")


def test_tied_weights_sum_both_paths_like_jax():
    ids = np.random.default_rng(6).integers(0, 10, (4, 3)).astype(np.float32)
    y = _labels(12, classes=10)
    with JaxNameManager():
        jnet = _Tied.build(jmx)
    with TorchNameManager():
        tnet = _Tied.build(tmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jnd.array(ids))
    assert len(list(jnet.collect_params().keys())) == 2  # shared
    tmx.interop.gluon_params_from_jax(_params(jnet), tnet, "cpu")
    jnet.hybridize()
    tnet.hybridize()
    for pkg_nd, ag, gluon, net in ((jnd, jag, jgluon, jnet),
                                   (tnd, tag, tgluon, tnet)):
        with ag.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                net(pkg_nd.array(ids)), pkg_nd.array(y))
        loss.backward()
    for n, p in tnet.collect_params().items():
        _close_grad(p.grad().asnumpy(),
                    jnet.collect_params()[n].grad().asnumpy())


def _programs(name=None):
    return [p for p in tmx.compile_report()["programs"]
            if p["kind"] == "gluon" and (name is None or p["name"] == name)]


def test_deferred_init_runs_the_first_call_eagerly_like_jax():
    build, shape = NETS["conv_bn"]
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    with JaxNameManager():
        jnet = build(jgluon.nn)
    with TorchNameManager():
        tnet = build(tgluon.nn)
    jnet.initialize(jmx.init.Xavier())
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    jnet.hybridize()
    tnet.hybridize()
    jnet(jnd.array(x))
    tnet(tnd.array(x))
    assert _programs() == []                  # the first call ran eagerly
    assert [p.shape for p in tnet.collect_params().values()] == \
        [p.shape for p in jnet.collect_params().values()]
    tmx.interop.gluon_params_from_jax(_params(jnet), tnet, "cpu")
    np.testing.assert_allclose(tnet(tnd.array(x)).asnumpy(),
                               jnet(jnd.array(x)).asnumpy(), atol=ATOL)
    assert [p["name"] for p in _programs()] == ["gluon:cbn"]


def test_new_input_shape_makes_a_new_program_and_a_retrace():
    build, shape = NETS["mlp"]
    _, tnet = _pair(build, shape)
    for rows in (4, 4, 3, 4):
        tnet(tnd.array(np.ones((rows, 10), np.float32)))
    rep = tmx.compile_report()
    assert len(_programs("gluon:mlp")) == 2
    assert rep["retraces"]["gluon:mlp"]["count"] == 1
    assert rep["retraces"]["gluon:mlp"]["events"][0]["to_sig"] == \
        ["(3, 10):float32"]
    # recording is another program of the same entry point
    with tag.record():
        tnet(tnd.array(np.ones((4, 10), np.float32)))
    assert len(_programs("gluon:mlp")) == 3
    assert "extra.recording" in tmx.compile_report()["retraces"][
        "gluon:mlp"]["events"][-1]["detail"]


def test_hybridize_false_runs_eagerly():
    build, shape = NETS["mlp"]
    jnet, tnet = _pair(build, shape, hybridize=False)
    tnet.hybridize()
    tnet.hybridize(False)
    x = np.ones(shape, np.float32)
    np.testing.assert_allclose(tnet(tnd.array(x)).asnumpy(),
                               jnet(jnd.array(x)).asnumpy(), atol=ATOL)
    assert _programs() == []


def test_cast_drops_the_programs():
    build, shape = NETS["mlp"]
    _, tnet = _pair(build, shape)
    x = np.random.default_rng(9).standard_normal(shape)
    want = tnet(tnd.array(x.astype(np.float32))).asnumpy()
    tnet.cast("float64")
    assert tnet._cached_op is None
    got = tnet(tnd.array(x, dtype="float64"))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got.asnumpy(), want, atol=ATOL)
    params = _programs("gluon:mlp")[-1]
    assert params["captures"] == 0 and len(_programs("gluon:mlp")) == 2


def test_load_parameters_and_moved_storage_refresh_a_hybridized_block():
    build, shape = NETS["conv_bn"]
    _, tnet = _pair(build, shape, seed=0)
    _, other = _pair(build, shape, seed=1)
    x = tnd.array(np.random.default_rng(11).standard_normal(shape).astype(
        np.float32))
    tnet(x)
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "p.params")
        other.save_parameters(f)
        tnet.load_parameters(f)
    np.testing.assert_array_equal(tnet(x).asnumpy(), other(x).asnumpy())
    # a parameter whose storage moved retires the programs over it
    entry = next(iter(tnet._cached_op.entries.values()))
    tnet.collect_params().initialize(tmx.init.Xavier(), force_reinit=True)
    tnet(x)
    assert next(iter(tnet._cached_op.entries.values())) is not entry


def test_flatten_round_trips_nested_arguments():
    from mxnet_tpu_torch.gluon.cached_op import flatten, unflatten
    a, b, c = (tnd.array(np.full((2,), v, np.float32)) for v in (1, 2, 3))
    obj = (a, [b, (c, None)], 3.5)
    leaves = []
    spec = flatten(obj, leaves)
    assert leaves == [a, b, c]
    back = unflatten(spec, iter(leaves))
    assert back[0] is a and back[1][0] is b and back[1][1] == (c, None)
    assert back[2] == 3.5 and hash(spec) is not None
