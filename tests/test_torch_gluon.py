"""The port's Gluon (``mxnet_tpu_torch.gluon``) against the JAX
package's, on the CPU.

The same seeded numpy inputs and the same parameters (carried by name
with ``interop.gluon_params_from_jax``) go through both packages: the
JAX package's nets hybridized (one ``jax.jit``), the port's eager, on
CPU tensors inside ``with mxnet_tpu_torch.cpu():``.

- Narrow ResNets: ``ResNetV1(BottleneckV1, [1, 1, 1, 1],
  [16, 32, 48, 64, 80], classes=10, thumbnail=True)`` and the same with
  ``ResNetV2`` / ``BottleneckV2``, batch 4 of 3x32x32. (Channels
  ``[16, 32, 32, 64, 64]`` give a stage whose input and output widths are
  equal at stride 2: it gets no downsample and its residual add fails in
  both packages.) The forward in predict mode within 1e-5 of the JAX
  package's (read: 9e-8); three ``Trainer("sgd", momentum 0.9, wd 1e-4)``
  steps under ``autograd.record()`` with ``SoftmaxCrossEntropyLoss``, on
  three batches. Each port step starts from the JAX package's state after
  its previous step (parameters, running statistics, momentum), as
  ``tests/test_torch_training.py`` does and for its reason: the loss is
  piecewise smooth (ReLU), so after a step the packages' ~1e-7 apart
  parameters can sit on two sides of a kink, and free-running the V2 net
  read 5e-5 apart at its stem after three steps. Even from one state, a
  ReLU input within an fp32 rounding of 0 can land on either side: at the
  V2 net's third step one does, and moves the gradients of the params
  behind it by up to 8e-4 relative L2 (2e-6 at the other steps). Held:
  losses within 1e-5 relative; each trained parameter's update and each
  momentum state within 5e-3 relative L2 of the JAX package's (+1e-6:
  the biases of convolutions followed by a BatchNorm get rounding noise
  of 1e-8 for a gradient that is 0 exactly); every
  running statistic within 1e-5 absolute (read 1.7e-7). The exact SGD
  rule (momentum, wd, clipping, rescale) is held on its own below.
- The full ResNet-50 v1 of ``__graft_entry__.entry()``: parameter names,
  order and shapes after deferred init (a forward at 32x32) equal the
  JAX package's, 25,629,032 parameters.
- Every loss of ``gluon/loss.py``, the layers' deferred init, BatchNorm's
  running statistics, the Trainer's rules, ``utils``, and the user's
  softmax cross-entropy of ``chip_smoke.py`` through the kernel hook
  (its plain version on the CPU) against ``SoftmaxCrossEntropyLoss``.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

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

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = ([1, 1, 1, 1], [16, 32, 48, 64, 80])
BATCH = 4
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
FWD_ATOL = 1e-5
STEP_ATOL = 1e-5
UPDATE_REL_L2 = 5e-3
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_scope():
    with tmx.cpu():
        yield


def _batch(seed=0, classes=10):
    r = np.random.default_rng(seed)
    x = r.standard_normal((BATCH, 3, 32, 32)).astype(np.float32)
    y = r.integers(0, classes, BATCH).astype(np.float32)
    return x, y


def _params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _narrow_pair(version):
    jv = jgluon.model_zoo.vision
    tv = tgluon.model_zoo.vision
    jcls, jblock = ((jv.ResNetV1, jv.BottleneckV1) if version == 1
                    else (jv.ResNetV2, jv.BottleneckV2))
    tcls, tblock = ((tv.ResNetV1, tv.BottleneckV1) if version == 1
                    else (tv.ResNetV2, tv.BottleneckV2))
    with JaxNameManager():
        jnet = jcls(jblock, *NARROW, classes=10, thumbnail=True)
    with TorchNameManager():
        tnet = tcls(tblock, *NARROW, classes=10, thumbnail=True)
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    jnet(jnd.array(_batch()[0]))          # finishes the deferred init
    tmx.interop.gluon_params_from_jax(_params(jnet), tnet, "cpu")
    tnet.hybridize()
    return jnet, tnet


@pytest.mark.parametrize("version", [1, 2])
def test_narrow_resnet_forward_matches_jax(version):
    jnet, tnet = _narrow_pair(version)
    assert list(_params(tnet)) == list(_params(jnet))
    x = _batch(1)[0]
    want = jnet(jnd.array(x)).asnumpy()
    got = tnet(tnd.array(x)).asnumpy()
    assert got.shape == (BATCH, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    # predict mode left the running statistics alone
    np.testing.assert_array_equal(
        np.concatenate([v.ravel() for n, v in _params(tnet).items()
                        if "running" in n]),
        np.concatenate([v.ravel() for n, v in _params(jnet).items()
                        if "running" in n]))


@pytest.mark.parametrize("version", [1, 2])
def test_narrow_resnet_trainer_steps_match_jax(version):
    jnet, tnet = _narrow_pair(version)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", OPT)
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", OPT)
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    start = _params(tnet)
    for step in range(3):
        # the port's step starts from the JAX package's state
        tmx.interop.gluon_params_from_jax(_params(jnet), tnet, "cpu")
        for i, st in jtr._updaters[0].states.items():
            ttr._updaters[0].states[i].data.copy_(torch.tensor(st.asnumpy()))
        before = _params(jnet)
        x, y = _batch(10 + step)
        with jag.record():
            jl = jloss_fn(jnet(jnd.array(x)), jnd.array(y))
        jl.backward()
        jtr.step(BATCH)
        with tag.record():
            tl = tloss_fn(tnet(tnd.array(x)), tnd.array(y))
        tl.backward()
        ttr.step(BATCH)
        np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(),
                                   rtol=LOSS_RTOL, atol=1e-6)
        jp, tp = _params(jnet), _params(tnet)
        for name, p in tnet.collect_params().items():
            if "running" in name:
                np.testing.assert_allclose(tp[name], jp[name], rtol=0,
                                           atol=STEP_ATOL, err_msg=name)
            elif p.grad_req != "null":
                du, dj = tp[name] - before[name], jp[name] - before[name]
                assert np.linalg.norm(du - dj) <= \
                    UPDATE_REL_L2 * np.linalg.norm(dj) + 1e-6, name
        tstates = ttr._updaters[0].states
        assert len(tstates) == len(jtr._updaters[0].states) == len(
            [p for p in tnet.collect_params().values()
             if p.grad_req != "null"])
        for i, st in jtr._updaters[0].states.items():
            a, b = tstates[i].asnumpy(), st.asnumpy()
            assert np.linalg.norm(a - b) <= \
                UPDATE_REL_L2 * np.linalg.norm(b) + 1e-6, i
    # every trained weight and every running statistic moved
    fixed = [n for n, p in tnet.collect_params().items()
             if p.grad_req == "null" and "running" not in n]
    moved = [n for n in start if not np.array_equal(start[n], tp[n])]
    assert sorted(moved) == sorted(set(start) - set(fixed))


def test_resnet50_v1_names_and_shapes_match_jax():
    """``__graft_entry__.entry()``'s model: names, order and shapes of
    every parameter after deferred init."""
    with JaxNameManager():
        jnet = jgluon.model_zoo.vision.get_resnet(1, 50, classes=1000)
    with TorchNameManager():
        tnet = tgluon.model_zoo.vision.get_resnet(1, 50, classes=1000)
    declared = {n: p.shape for n, p in jnet.collect_params().items()}
    assert {n: p.shape for n, p in tnet.collect_params().items()} == \
        declared
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    tmx.random.seed(0)
    tnet.initialize(tmx.init.Xavier())
    x = np.zeros((1, 3, 32, 32), np.float32)
    jnet(jnd.array(x))
    out = tnet(tnd.array(x))
    assert out.shape == (1, 1000)
    jshapes = [(n, p.shape) for n, p in jnet.collect_params().items()]
    tshapes = [(n, p.shape) for n, p in tnet.collect_params().items()]
    assert tshapes == jshapes
    assert tshapes[0] == ("resnetv10_conv0_weight", (64, 3, 7, 7))
    assert sum(int(np.prod(s)) for _, s in tshapes) == 25_629_032
    # Xavier's scale and the name rules of the initializer
    p = tnet.collect_params()
    w = p["resnetv10_dense0_weight"].data().asnumpy()
    assert np.abs(w).max() <= np.sqrt(3.0 / ((2048 + 1000) / 2)) + 1e-7
    assert (p["resnetv10_batchnorm0_gamma"].data().asnumpy() == 1).all()
    assert (p["resnetv10_batchnorm0_running_var"].data().asnumpy()
            == 1).all()
    assert not p["resnetv10_dense0_bias"].data().asnumpy().any()


def test_get_resnet_pretrained_raises_and_zoo_names():
    with pytest.raises(tmx.MXNetError, match="pretrained"):
        tgluon.model_zoo.vision.get_resnet(1, 18, pretrained=True)
    with TorchNameManager():
        net = tgluon.model_zoo.vision.get_model("resnet18_v2", classes=4)
    assert isinstance(net, tgluon.model_zoo.vision.ResNetV2)
    with pytest.raises(ValueError, match="not supported"):
        tgluon.model_zoo.vision.get_model("vgg16")


# ---------------------------------------------------------------------------
# losses: gluon/loss.py, whole
# ---------------------------------------------------------------------------
def _loss_inputs():
    r = np.random.default_rng(5)
    pred = r.standard_normal((4, 6)).astype(np.float32)
    return {"pred": pred,
            "label_cls": np.array([0, 5, 2, 2], np.float32),
            "label_dense": np.abs(r.standard_normal((4, 6))).astype(
                np.float32) / 6.0,
            "label_pm": np.sign(r.standard_normal((4, 6))).astype(
                np.float32),
            "label_01": (r.uniform(size=(4, 6)) > 0.5).astype(np.float32),
            "prob": r.uniform(0.05, 0.95, (4, 6)).astype(np.float32),
            "sw": r.uniform(0.5, 1.5, (4, 1)).astype(np.float32),
            "pos": r.standard_normal((4, 6)).astype(np.float32),
            "neg": r.standard_normal((4, 6)).astype(np.float32),
            "seq": r.standard_normal((4, 7, 5)).astype(np.float32),
            "seq_label": np.array([[1, 2, -1], [3, 3, 1], [0, -1, -1],
                                   [2, 1, 0]], np.float32)}


# (loss name, constructor kwargs, differentiated input, other inputs)
LOSS_CASES = {
    "l2": ("L2Loss", {}, "pred", ("label_dense",)),
    "l2_weighted": ("L2Loss", {"weight": 0.5}, "pred", ("label_dense",
                                                        "sw")),
    "l1": ("L1Loss", {}, "pred", ("label_dense",)),
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {}, "pred",
                    ("label_01",)),
    "sigmoid_bce_from_sigmoid": ("SigmoidBCELoss", {"from_sigmoid": True},
                                 "prob", ("label_01",)),
    "softmax_ce": ("SoftmaxCrossEntropyLoss", {}, "pred", ("label_cls",)),
    "softmax_ce_weighted": ("SoftmaxCELoss", {}, "pred", ("label_cls",
                                                          "sw")),
    "softmax_ce_dense": ("SoftmaxCrossEntropyLoss", {"sparse_label": False},
                         "pred", ("label_dense",)),
    "kl_div": ("KLDivLoss", {"from_logits": False}, "pred",
               ("label_dense",)),
    "huber": ("HuberLoss", {"rho": 0.5}, "pred", ("label_dense",)),
    "hinge": ("HingeLoss", {}, "pred", ("label_pm",)),
    "squared_hinge": ("SquaredHingeLoss", {}, "pred", ("label_pm",)),
    "logistic_signed": ("LogisticLoss", {}, "pred", ("label_pm",)),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"}, "pred",
                        ("label_01",)),
    "triplet": ("TripletLoss", {}, "pred", ("pos", "neg")),
    "ctc": ("CTCLoss", {"layout": "NTC"}, "seq", ("seq_label",)),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_gradient_match_jax(case):
    cls, kw, diff, others = LOSS_CASES[case]
    ins = _loss_inputs()
    res = {}
    for name, gl, F, ag in (("jax", jgluon, jnd, jag),
                            ("torch", tgluon, tnd, tag)):
        fn = getattr(gl.loss, cls)(**kw)
        x = F.array(ins[diff])
        x.attach_grad()
        with ag.record():
            loss = fn(x, *[F.array(ins[o]) for o in others])
        loss.backward()
        res[name] = (loss.asnumpy(), x.grad.asnumpy())
    assert res["torch"][0].shape == res["jax"][0].shape
    for g, w in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# layers, parameters, trainer, utils
# ---------------------------------------------------------------------------
def _layer_pair(make_j, make_t):
    with JaxNameManager():
        jl = make_j()
    with TorchNameManager():
        tl = make_t()
    return jl, tl


@pytest.mark.parametrize("kind", ["dense", "dense_act_noflatten", "conv",
                                  "conv_bias_act", "maxpool", "avgpool",
                                  "global_avg", "flatten",
                                  "activation"])
def test_layer_deferred_init_and_forward_match_jax(kind):
    makers = {
        "dense": lambda nn: nn.Dense(5),
        "dense_act_noflatten": lambda nn: nn.Dense(5, activation="tanh",
                                                   flatten=False),
        "conv": lambda nn: nn.Conv2D(4, 3, strides=2, padding=1,
                                     use_bias=False),
        "conv_bias_act": lambda nn: nn.Conv2D(4, (3, 1),
                                              activation="relu"),
        "maxpool": lambda nn: nn.MaxPool2D(3, 2, 1),
        "avgpool": lambda nn: nn.AvgPool2D(2),
        "global_avg": lambda nn: nn.GlobalAvgPool2D(),
        "flatten": lambda nn: nn.Flatten(),
        "activation": lambda nn: nn.Activation("softrelu"),
    }
    jl, tl = _layer_pair(lambda: makers[kind](jgluon.nn),
                         lambda: makers[kind](tgluon.nn))
    x = np.random.default_rng(2).standard_normal((2, 3, 6, 6)).astype(
        np.float32)
    jmx.random.seed(0)
    jl.initialize(jmx.init.Xavier())
    want = jl(jnd.array(x)).asnumpy()
    tl.initialize(tmx.init.Xavier())
    tl(tnd.array(x))                          # deferred init
    if _params(jl):
        assert {n: v.shape for n, v in _params(tl).items()} == \
            {n: v.shape for n, v in _params(jl).items()}
        tmx.interop.gluon_params_from_jax(_params(jl), tl, "cpu")
    np.testing.assert_allclose(tl(tnd.array(x)).asnumpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_batchnorm_running_stats_match_jax():
    """Training mode: batch statistics, biased variance, momentum 0.9;
    predict mode: the running statistics."""
    jl, tl = _layer_pair(lambda: jgluon.nn.BatchNorm(momentum=0.8),
                         lambda: tgluon.nn.BatchNorm(momentum=0.8))
    r = np.random.default_rng(3)
    xs = [r.standard_normal((4, 3, 5, 5)).astype(np.float32) * 2 + 1
          for _ in range(3)]
    jl.initialize()
    tl.initialize()
    for x in xs[:2]:
        with jag.record():
            jo = jl(jnd.array(x))
        with tag.record():
            to = tl(tnd.array(x))
        np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), rtol=1e-5,
                                   atol=1e-5)
    for n, v in _params(jl).items():
        np.testing.assert_allclose(_params(tl)[n], v, rtol=1e-6, atol=1e-6)
    var0 = 1.0 * 0.8 + xs[0].var(axis=(0, 2, 3)) * 0.2
    np.testing.assert_allclose(
        _params(tl)["batchnorm0_running_var"],
        var0 * 0.8 + xs[1].var(axis=(0, 2, 3)) * 0.2, rtol=1e-5)
    np.testing.assert_allclose(tl(tnd.array(xs[2])).asnumpy(),
                               jl(jnd.array(xs[2])).asnumpy(), rtol=1e-5,
                               atol=1e-5)


def _tiny_net(gl, prefix):
    net = gl.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(gl.nn.Dense(4, activation="relu"), gl.nn.Dense(3))
    return net


def test_grad_write_not_accumulated_and_add_is():
    net = _tiny_net(tgluon, "tiny_")
    net.initialize(tmx.init.Xavier())
    x = tnd.array(np.random.default_rng(4).standard_normal((5, 2)))
    grads = []
    for _ in range(2):
        with tag.record():
            loss = net(x).sum()
        loss.backward()
        grads.append(net[0].weight.grad().asnumpy().copy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)
    net.collect_params().setattr("grad_req", "add")
    net.collect_params().zero_grad()
    for _ in range(2):
        with tag.record():
            loss = net(x).sum()
        loss.backward()
    np.testing.assert_allclose(net[0].weight.grad().asnumpy(),
                               2 * grads[0], rtol=1e-5)


def test_trainer_rules():
    net = _tiny_net(tgluon, "tiny_")
    net.initialize(tmx.init.Xavier())
    with pytest.raises(tmx.MXNetError, match="one device"):
        tgluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    tr = tgluon.Trainer(net.collect_params(), "sgd", OPT, kvstore="local")
    x = tnd.array(np.ones((2, 2)))
    net(x)                                   # finishes the deferred init
    with pytest.raises(UserWarning, match="has not been updated"):
        tr.step(2)                           # no backward yet
    with tag.record():
        loss = net(x).sum()
    loss.backward()
    tr.step(2)
    assert tr._optimizer.rescale_grad == 0.5
    with pytest.raises(UserWarning, match="has not been updated"):
        tr.step(2)                           # the same gradients again
    tr.step(2, ignore_stale_grad=True)
    assert tr.learning_rate == 0.1


def test_trainer_sgd_update_matches_jax_formula():
    """One SGD-momentum step on a single parameter, both packages."""
    w0 = np.random.default_rng(6).standard_normal((3, 2)).astype(np.float32)
    res = {}
    for name, gl, F, ag in (("jax", jgluon, jnd, jag),
                            ("torch", tgluon, tnd, tag)):
        p = gl.Parameter("w", shape=(3, 2))
        p.initialize(init=jmx.init.Zero() if name == "jax"
                     else tmx.init.Zero())
        p.set_data(F.array(w0))
        tr = gl.Trainer([p], "sgd", {"learning_rate": 0.5, "momentum": 0.9,
                                     "wd": 0.1, "clip_gradient": 0.3})
        for _ in range(2):
            with ag.record():
                loss = (p.data() * p.data()).sum()
            loss.backward()
            tr.step(4)
        res[name] = p.data().asnumpy()
    np.testing.assert_allclose(res["torch"], res["jax"], rtol=1e-6)


def test_updater_per_parameter_matches_trainer_groups():
    """``Optimizer.update`` through ``get_updater`` (one parameter at a
    time) and ``Trainer.step`` (lists grouped by lr and wd) apply the same
    rule: after two steps the weights and momenta agree to 1e-6. The
    Trainer leaves the gradients as backward wrote them."""
    rng = np.random.default_rng(7)
    w0 = [rng.standard_normal(s).astype(np.float32) for s in ((3, 2), (4,))]
    hp = {"learning_rate": 0.5, "momentum": 0.9, "wd": 0.1,
          "clip_gradient": 0.3}
    res = []
    for use_trainer in (False, True):
        ps = [tgluon.Parameter(n, shape=w.shape)
              for n, w in zip(("a_weight", "b_bias"), w0)]
        for p, w in zip(ps, w0):
            p.initialize(init=tmx.init.Zero())
            p.set_data(tnd.array(w))
        ps[1].wd_mult, ps[1].lr_mult = 0.0, 2.0
        tr = tgluon.Trainer(ps, "sgd", hp)
        upd = tmx.optimizer.get_updater(tr._optimizer)
        for _ in range(2):
            with tag.record():
                loss = sum((p.data() * p.data()).sum() for p in ps)
            loss.backward()
            grads = [p.grad().asnumpy() for p in ps]
            if use_trainer:
                tr.step(4)
                states = tr._updaters[0].states
            else:
                tr._optimizer.rescale_grad = 1 / 4
                for i, p in enumerate(ps):
                    upd(i, p.grad(), p.data())
                states = upd.states
            for p, g in zip(ps, grads):
                np.testing.assert_array_equal(p.grad().asnumpy(), g)
        res.append([p.data().asnumpy() for p in ps] +
                   [states[i].asnumpy() for i in range(2)])
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_parameter_api():
    p = tgluon.Parameter("fc_weight", shape=(2, 0), allow_deferred_init=True)
    p.initialize(init=tmx.init.One())
    with pytest.raises(tgluon.parameter.DeferredInitializationError):
        p.data()
    p._infer_shape((2, 3))
    p._finish_deferred_init()
    assert p.data().shape == (2, 3) and p.grad().shape == (2, 3)
    assert p.data().data.requires_grad and p.data().data.is_leaf
    p.set_data(np.full((2, 3), 4.0, np.float32))
    assert (p.data().asnumpy() == 4).all() and p.data().data.is_leaf
    p.grad_req = "null"
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        p.grad()
    p.grad_req = "write"
    p.cast("float64")
    assert p.data().dtype == np.float64 and p.grad().dtype == np.float64
    c = tgluon.Constant("c", np.arange(3.0))
    c.initialize()
    np.testing.assert_array_equal(c.data().asnumpy(), [0, 1, 2])
    assert c.grad_req == "null"
    d = tgluon.ParameterDict("net_")
    a = d.get("w", shape=(2, 0))
    assert d.get("w", shape=(0, 5)) is a and a.shape == (2, 5)
    shared = tgluon.ParameterDict("net_", shared=d)
    assert shared.get("w") is a
    with pytest.raises(ValueError, match="invalid shape"):
        tgluon.Parameter("v", shape=(0,)).initialize()


def test_block_names_scopes_and_hybridize_match_jax():
    jnet = _tiny_net(jgluon, "tiny_")
    tnet = _tiny_net(tgluon, "tiny_")
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert list(tnet.collect_params(".*bias")) == \
        list(jnet.collect_params(".*bias"))
    tnet.initialize()
    x = tnd.array(np.ones((2, 7)))
    before = tnet(x).asnumpy()
    tnet.hybridize(static_alloc=True)
    assert tnet._active and tnet._flags["static_alloc"]
    np.testing.assert_array_equal(tnet(x).asnumpy(), before)
    assert len(tnet) == 2 and tnet[1] is list(tnet)[1]


def test_split_and_load_and_clip_global_norm_match_jax():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    jparts = jgluon.utils.split_and_load(x, [jmx.cpu(), jmx.cpu()])
    tparts = tgluon.utils.split_and_load(x, [tmx.cpu(), tmx.cpu()])
    assert len(tparts) == 2
    for t, j in zip(tparts, jparts):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert len(tgluon.utils.split_and_load(x, [tmx.cpu()])) == 1
    with pytest.raises(ValueError, match="evenly split"):
        tgluon.utils.split_data(tnd.array(x), 4)
    uneven = tgluon.utils.split_data(tnd.array(x), 4, even_split=False)
    assert [u.shape[0] for u in uneven] == [1, 1, 1, 3]
    r = np.random.default_rng(7)
    arrs = [r.standard_normal(s).astype(np.float32) for s in ((3,), (2, 2))]
    jn = jgluon.utils.clip_global_norm([jnd.array(a) for a in arrs], 1.0)
    ta = [tnd.array(a) for a in arrs]
    tn = tgluon.utils.clip_global_norm(ta, 1.0)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    total = np.sqrt(sum((t.asnumpy() ** 2).sum() for t in ta))
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# the user's softmax cross-entropy through the kernel hook
# ---------------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_gluon", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def _softmax_ce_op():
    cs = _chip_smoke()
    placeholder = tmx.rtc.CudaFunction(tmx.rtc.CudaModule(
        cs.USER_CUDA_SRC, options=("-DNUM_CLASSES=10",)), "softmax_ce_fwd",
        None)
    fwd, bwd = cs.register_softmax_ce(tmx, placeholder, placeholder,
                                      name="test_softmax_ce")
    yield fwd, bwd
    from mxnet_tpu_torch.ops.registry import _OPS
    _OPS.pop("test_softmax_ce", None)
    delattr(tnd, "test_softmax_ce")


def test_user_softmax_ce_matches_gluon_loss(_softmax_ce_op):
    """The loss of the chip's training check, on the CPU: the hook runs
    the user's plain version forward and, from the VJP, backward; it is
    held against SoftmaxCrossEntropyLoss on the same logits, inside a
    narrow net's training step."""
    fwd, bwd = _softmax_ce_op
    with TorchNameManager():
        net = tgluon.model_zoo.vision.ResNetV1(
            tgluon.model_zoo.vision.BottleneckV1, *NARROW, classes=10,
            thumbnail=True)
    tmx.random.seed(0)
    net.initialize(tmx.init.Xavier())
    x, y = _batch(2)
    ref_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    res = {}
    for name, fn in (("ref", ref_fn),
                     ("user", lambda out, lab: tnd.test_softmax_ce(out,
                                                                   lab))):
        with tag.record():
            out = net(tnd.array(x))
            loss = fn(out, tnd.array(y))
        g_out = tag.grad(loss, [out], retain_graph=True)[0]
        loss.backward()
        res[name] = (loss.asnumpy(), g_out.asnumpy(),
                     {n: p.grad().asnumpy()
                      for n, p in net.collect_params().items()
                      if p.grad_req != "null"})
    np.testing.assert_allclose(res["user"][0], res["ref"][0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(res["user"][1], res["ref"][1], rtol=1e-5,
                               atol=1e-7)
    # per parameter, within 1e-4 of its largest entry (+1e-6: the biases
    # of convolutions followed by a BatchNorm have a zero gradient, read
    # as rounding noise of 5e-7)
    for n, g in res["ref"][2].items():
        np.testing.assert_allclose(res["user"][2][n], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-6,
                                   err_msg=n)
    assert fwd.launches == 0 and bwd.launches == 0
