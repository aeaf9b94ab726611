"""The port's training slice (``mxnet_tpu_torch.mod.Module`` and what it
runs) against the JAX package's, on the CPU.

The same numpy inputs go through both packages: the JAX package on CPU
JAX with its Pallas kernels in interpret mode, the port on CPU tensors,
where every kernel wrapper takes its plain version.

- ``Module(fused=True)`` on a narrow ResNet with the ``s2d`` stem
  (3x64x64, batch 4, both rewrite passes on), SGD lr 0.1, momentum 0.9,
  wd 1e-4, 3 steps in fp32 and in bf16. Each port step starts from the
  JAX package's state after the previous step (params, aux, momentum)
  and must reach its next state. Why not two free-running trajectories:
  the loss is piecewise smooth (ReLU, max-pool), so its exact gradient
  jumps where a pre-activation crosses 0. After one step the packages'
  params differ by ~1e-6 (summation order), enough to cross such a kink
  at the second step: there the JAX package's own gradient matches the
  float64 gradient at its params, and the port's matches the float64
  gradient at its params, to 5e-6, yet the two differ by 14% in one
  BatchNorm beta. Tolerances (fp32): each param within 1e-4 of its
  update's largest entry (+1e-6), aux within 1e-5, outputs within 2e-5,
  the loss within 1e-5 relative. bf16: at batch 4 a bf16 step's update
  is far from the fp32 one in both packages (relative L2 over all
  params 0.27-0.61 in the JAX package, measured), so the port's bf16
  step is held to the fp32 step from the same state (the port's fp32
  step, held to the JAX package above): its relative L2 error may be at
  most 1.25x the JAX package's bf16 error (measured 0.87-0.98x); the
  outputs within 0.03 of the JAX package's bf16 outputs, aux within
  0.05 (a few bf16 steps), the loss within 2%.
- The train-mode pass report of the full ResNet-50 (s2d) graph names the
  same sites and bail-outs as the JAX package's (28 and 16).
- ``conv_s2d_stem``, SoftmaxOutput's implicit loss, ``set_wd_mult``, the
  learning-rate schedules, the initializers' name rules, the metrics and
  ``NDArrayIter`` against the JAX package's; ``fit`` over an
  ``NDArrayIter`` for one short epoch.
"""
import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.symbol import passes as jax_passes

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.model_zoo.symbols import resnet as torch_resnet
from mxnet_tpu_torch.name import NameManager as TorchNameManager
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.symbol import passes as torch_passes
from torch_threads import one_torch_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(units=[2, 1, 1, 1], num_stages=4,
              filter_list=[8, 32, 64, 128, 256], num_classes=10,
              image_shape=[3, 64, 64], bottle_neck=True, stem="s2d")
BATCH = 4
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _jax_resnet_module():
    path = os.path.join(_ROOT, "examples", "image_classification",
                        "symbols", "resnet.py")
    spec = importlib.util.spec_from_file_location("_jax_resnet_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _narrow_pair():
    with JaxNameManager():
        js = _jax_resnet_module().resnet(**NARROW)
    with TorchNameManager():
        ts = torch_resnet.resnet(**NARROW)
    return js, ts


def _passes_on(pkg):
    class _On:
        def __enter__(self):
            self._a = pkg.config.override("MXTPU_PALLAS_FUSION", "1")
            self._b = pkg.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1")
            self._a.__enter__()
            self._b.__enter__()

        def __exit__(self, *exc):
            self._b.__exit__(*exc)
            self._a.__exit__(*exc)
    return _On()


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(BATCH, 3, 64, 64).astype(np.float32),
             rng.randint(0, 10, (BATCH,)).astype(np.float32))
            for _ in range(n)]


def _initial_state(js):
    """Seeded params (Xavier-style weights, BN scales and shifts away
    from 1 and 0) and aux (moving means and variances away from 0 and
    1), as numpy."""
    rng = np.random.default_rng(0)
    a, _, x = js.infer_shape(data=(BATCH, 3, 64, 64))
    args, aux = {}, {}
    for n, s in zip(js.list_arguments(), a):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("weight"):
            v = rng.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("gamma"):
            v = 1.0 + 0.1 * rng.standard_normal(s)
        else:
            v = 0.1 * rng.standard_normal(s)
        args[n] = v.astype(np.float32)
    for n, s in zip(js.list_auxiliary_states(), x):
        v = rng.uniform(0.5, 1.5, s) if n.endswith("var") \
            else 0.1 * rng.standard_normal(s)
        aux[n] = v.astype(np.float32)
    return args, aux


def _jax_trajectory(js, batches, cdt):
    """The JAX package's Module over ``batches``: the state before each
    step and after the last, and each step's outputs."""
    args, aux = _initial_state(js)
    with _passes_on(jmx):
        m = jmx.mod.Module(context=jmx.cpu(), symbol=js, fused=True,
                           compute_dtype=cdt)
        m.bind(data_shapes=[("data", (BATCH, 3, 64, 64))],
               label_shapes=[("softmax_label", (BATCH,))])
        m.init_params(arg_params={k: jmx.nd.array(v)
                                  for k, v in args.items()},
                      aux_params={k: jmx.nd.array(v)
                                  for k, v in aux.items()})
        m.init_optimizer(kvstore=None, optimizer="sgd",
                         optimizer_params=OPT)
        states = [(args, aux, {k: np.zeros_like(v)
                               for k, v in args.items()})]
        outs = []
        for d, lab in batches:
            m.forward(jmx.io.DataBatch([jmx.nd.array(d)],
                                       [jmx.nd.array(lab)]), is_train=True)
            m.backward()
            m.update()
            outs.append(np.asarray(m.get_outputs()[0].asnumpy(),
                                   np.float32))
            a, x = m.get_params()
            mom = {n: np.asarray(s[0], np.float32) for n, s in pickle.loads(
                m._fused.get_states())["state"].items()}
            states.append(({k: v.asnumpy() for k, v in a.items()},
                           {k: v.asnumpy() for k, v in x.items()}, mom))
        return states, outs


def _port_steps(ts, batches, states, cdt):
    """Each step of the port's Module from the JAX package's state
    before it: [(params, aux, momentum, outputs, loss)]."""
    args, aux, _ = states[0]
    with _passes_on(tmx):
        m = tmx.mod.Module(ts, context="cpu", compute_dtype=cdt)
        m.bind(data_shapes=[("data", (BATCH, 3, 64, 64))],
               label_shapes=[("softmax_label", (BATCH,))])
        m.init_params(arg_params=args, aux_params=aux)
        m.init_optimizer(kvstore=None, optimizer="sgd",
                         optimizer_params=OPT)
        rep = {e["pass"]: len(e["sites"]) for e in m.pass_report["passes"]}
        assert rep["pallas_fusion"] == 6 and rep["residual_fusion"] == 5
        res = []
        for (d, lab), (a0, x0, mom0) in zip(batches, states):
            m.init_params(arg_params=a0, aux_params=x0, force_init=True)
            for n, (mom,) in m._fused._state.items():
                mom.copy_(torch.from_numpy(mom0[n]))
            m.forward(tmx.io.DataBatch([torch.from_numpy(d)],
                                       [torch.from_numpy(lab)]),
                      is_train=True)
            m.backward()
            m.update()
            a, x = m.get_params()
            res.append(({k: v.numpy().copy() for k, v in a.items()},
                        {k: v.numpy().copy() for k, v in x.items()},
                        {n: s[0].numpy().copy()
                         for n, s in m._fused._state.items()},
                        m.get_outputs()[0].asnumpy(),
                        float(m._fused.last_loss)))
        return res


def _loss_from_probs(p, lab):
    return float(-np.log(p[np.arange(len(lab)), lab.astype(int)]).sum())


@pytest.fixture(scope="module")
def narrow():
    return _narrow_pair()


def test_module_trains_like_jax_fp32(narrow):
    js, ts = narrow
    batches = _batches(3)
    states, jouts = _jax_trajectory(js, batches, None)
    got = _port_steps(ts, batches, states, None)
    for i, (a, x, mom, out, loss) in enumerate(got):
        prev, want = states[i], states[i + 1]
        for n in want[0]:
            upd = np.abs(want[0][n] - prev[0][n]).max()
            np.testing.assert_allclose(a[n], want[0][n], rtol=0,
                                       atol=1e-4 * upd + 1e-6,
                                       err_msg=f"step {i} param {n}")
            np.testing.assert_allclose(mom[n], want[2][n], rtol=0,
                                       atol=1e-4 * upd + 1e-6,
                                       err_msg=f"step {i} momentum {n}")
        for n in want[1]:
            np.testing.assert_allclose(x[n], want[1][n], rtol=0, atol=1e-5,
                                       err_msg=f"step {i} aux {n}")
        np.testing.assert_allclose(out, jouts[i], rtol=0, atol=2e-5)
        np.testing.assert_allclose(
            loss, _loss_from_probs(jouts[i], batches[i][1]), rtol=1e-5)


def _l2(a):
    return float(np.sqrt((a.astype(np.float64) ** 2).sum()))


def test_module_trains_like_jax_bf16(narrow):
    js, ts = narrow
    batches = _batches(3)
    states, jouts = _jax_trajectory(js, batches, "bfloat16")
    got16 = _port_steps(ts, batches, states, "bfloat16")
    got32 = _port_steps(ts, batches, states, None)
    names = sorted(states[0][0])
    for i, (a, x, _, out, loss) in enumerate(got16):
        prev, want = states[i], states[i + 1]

        def upd(params):
            return np.concatenate([(params[n] - prev[0][n]).ravel()
                                   for n in names])
        ref = upd(got32[i][0])
        err_port = _l2(upd(a) - ref) / _l2(ref)
        err_jax = _l2(upd(want[0]) - ref) / _l2(ref)
        assert err_port <= 1.25 * err_jax, (i, err_port, err_jax)
        for n in want[1]:
            np.testing.assert_allclose(x[n], want[1][n], rtol=0, atol=0.05,
                                       err_msg=f"step {i} aux {n}")
        np.testing.assert_allclose(out, jouts[i], rtol=0, atol=0.03)
        np.testing.assert_allclose(
            loss, _loss_from_probs(jouts[i], batches[i][1]), rtol=0.02)


def _resnet50_pair():
    with JaxNameManager():
        js = _jax_resnet_module().get_symbol(1000, 50, "3,224,224",
                                             stem="s2d")
    with TorchNameManager():
        ts = torch_resnet.get_symbol(1000, 50, "3,224,224", stem="s2d")
    return js, ts


def test_resnet50_s2d_train_pass_report_matches_jax():
    """The train-mode pipeline over the full ResNet-50 (s2d stem) at
    batch 128 (built, never run) rewrites the same sites, with the same
    bail-outs, in both packages."""
    js, ts = _resnet50_pair()
    assert ts.tojson() == js.tojson()
    a, _, x = ts.infer_shape(data=(128, 3, 224, 224))
    shapes = dict(zip(ts.list_arguments(), map(tuple, a)))
    shapes.update(zip(ts.list_auxiliary_states(), map(tuple, x)))
    with _passes_on(jmx):
        _, jrep = jax_passes.apply_pipeline(
            js, shapes, tag="fused_step", mode="train",
            batch_names={"data", "softmax_label"})
    with _passes_on(tmx):
        _, trep = torch_passes.apply_pipeline(
            ts, shapes, tag="fused_step", mode="train",
            device=torch.device("cpu"),
            data_names={"data", "softmax_label"})
    je = {e["pass"]: e for e in jrep["passes"]}
    te = {e["pass"]: e for e in trep["passes"]}
    # the s2d stem is not a Convolution, so bn_data -> conv0 (a
    # residual_fusion site with the std stem) is not one here
    for name, n_sites in (("pallas_fusion", 28), ("residual_fusion", 16)):
        assert te[name]["status"] == je[name]["status"] == "applied"
        assert len(te[name]["sites"]) == n_sites
        assert te[name]["sites"] == je[name]["sites"]
        assert te[name]["bailouts"] == je[name]["bailouts"]


def test_conv_s2d_stem_is_the_7x7_conv_and_the_jax_op():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 16, 12)).astype(np.float32)
    w = (0.1 * rng.standard_normal((8, 3, 7, 7))).astype(np.float32)
    got = tnn.conv_s2d_stem(torch.from_numpy(x), torch.from_numpy(w))
    conv = torch.nn.functional.conv2d(torch.from_numpy(x),
                                      torch.from_numpy(w), stride=2,
                                      padding=3)
    want = np.asarray(jnn.conv_s2d_stem(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), conv.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="even spatial"):
        tnn.conv_s2d_stem(torch.zeros(1, 3, 5, 6), torch.zeros(8, 3, 7, 7))
    with pytest.raises(ValueError, match="exactly"):
        tnn.conv_s2d_stem(torch.zeros(1, 3, 6, 6), torch.zeros(8, 3, 7, 7),
                          stride=(1, 1))


@pytest.mark.parametrize("kw", [
    {}, {"normalization": "batch", "grad_scale": 2.0},
    {"use_ignore": True, "ignore_label": 3, "normalization": "valid"},
    {"use_ignore": True, "ignore_label": 3}])
def test_softmax_output_loss_and_grad_match_jax(kw):
    """SoftmaxOutput's implicit loss and its gradient (p - y per row for
    "null") against the JAX package's; fp32 rtol 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    lab = np.array([0, 3, 1, 3, 4, 2], np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    loss = tnn.softmax_output_loss(xt, torch.from_numpy(lab), **kw)
    (gt,) = torch.autograd.grad(loss, xt)
    jl, jg = jax.value_and_grad(
        lambda v: jnn.softmax_output_loss(v, jnp.asarray(lab), **kw))(
            jnp.asarray(x))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    if not kw:
        p = torch.softmax(torch.from_numpy(x), -1).numpy()
        p[np.arange(6), lab.astype(int)] -= 1
        np.testing.assert_allclose(gt.numpy(), p, rtol=1e-5, atol=1e-6)


def test_set_wd_mult_matches_jax():
    """Weight decay by name: every param not ending in _weight or _gamma
    goes wd-free, with and without symbol attributes."""
    js, ts = _resnet50_pair()
    names = [n for n in ts.list_arguments()
             if n not in ("data", "softmax_label")]
    idx2name = dict(enumerate(names))
    jo = jmx.optimizer.create("sgd", param_idx2name=idx2name, wd=1e-4)
    to = tmx.optimizer.create("sgd", param_idx2name=idx2name, wd=1e-4)
    assert to.wd_mult == jo.wd_mult
    assert set(to.wd_mult) == {n for n in names
                               if n.endswith(("_beta", "_bias"))}
    assert all(to._get_wd(i) == jo._get_wd(i) for i in idx2name)
    assert to._get_wd(names.index("fc1_bias")) == 0.0
    assert to._get_wd(names.index("fc1_weight")) == 1e-4
    to.set_wd_mult({"fc1_weight": 0.5})
    jo.set_wd_mult({"fc1_weight": 0.5})
    assert to.wd_mult == jo.wd_mult


def test_functional_sgd_inplace_matches_pure_and_jax():
    """The foreach SGD update the fused step applies equals the pure
    rule and the JAX package's rule (rescale, clip, + wd*p, momentum)."""
    from mxnet_tpu.parallel import functional_opt as jfo
    from mxnet_tpu_torch.parallel import functional_opt as tfo
    rng = np.random.default_rng(5)
    ps = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (7,))]
    gs = [rng.standard_normal(p.shape).astype(np.float32) for p in ps]
    ms = [rng.standard_normal(p.shape).astype(np.float32) for p in ps]
    kw = dict(momentum=0.9, rescale_grad=0.25, clip_gradient=0.3)
    rule = tfo.create("sgd", **kw)
    jrule = jfo.create("sgd", **kw)
    pt = [torch.from_numpy(p.copy()) for p in ps]
    mt = [(torch.from_numpy(m.copy()),) for m in ms]
    rule.update_(pt, [torch.from_numpy(g.copy()) for g in gs], mt, 0.1,
                 1e-4)
    for i, (p, g, m) in enumerate(zip(ps, gs, ms)):
        wp, (wm,) = rule.update(torch.from_numpy(p), torch.from_numpy(g),
                                (torch.from_numpy(m),), 0.1, 1, 1e-4)
        jp, (jm,) = jrule.update(jnp.asarray(p), jnp.asarray(g),
                                 (jnp.asarray(m),), 0.1, 1, 1e-4)
        for got, a, b in ((pt[i], wp, jp), (mt[i][0], wm, jm)):
            np.testing.assert_allclose(got.numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(got.numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("make", [
    lambda lr: lr.FactorScheduler(step=3, factor=0.5, stop_factor_lr=1e-3),
    lambda lr: lr.MultiFactorScheduler(step=[2, 5, 6], factor=0.1)])
def test_lr_schedulers_match_jax(make):
    ts_, js_ = make(tmx.lr_scheduler), make(jmx.lr_scheduler)
    ts_.base_lr = js_.base_lr = 0.1
    assert [ts_(n) for n in range(1, 12)] == [js_(n) for n in range(1, 12)]


def test_initializer_name_rules_and_xavier():
    """The by-name defaults of the JAX package (gamma 1, beta/bias 0,
    moving_mean 0, moving_var 1), ``__init__`` overrides, and Xavier's
    scale from a seeded ``torch.Generator``."""
    init = tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                           magnitude=2)
    g = torch.Generator().manual_seed(0)
    for name, want in (("bn_gamma", 1.0), ("bn_beta", 0.0), ("fc_bias", 0.0),
                       ("bn_moving_mean", 0.0), ("bn_moving_var", 1.0)):
        t = torch.full((5,), 7.0)
        init(tmx.init.InitDesc(name), t, g)
        assert bool((t == want).all()), name
    w = torch.empty(256, 64, 3, 3)
    init(tmx.init.InitDesc("conv_weight"), w, g)
    assert abs(float(w.std()) - np.sqrt(2 / (64 * 9))) < 0.01 * np.sqrt(
        2 / (64 * 9)) * 3
    w2, w3 = torch.empty(256, 64, 3, 3), torch.empty(256, 64, 3, 3)
    init(tmx.init.InitDesc("conv_weight"), w2,
         torch.Generator().manual_seed(0))
    init(tmx.init.InitDesc("conv_weight"), w3, g)
    assert torch.equal(w, w2)              # the generator's seed decides
    assert not torch.equal(w, w3)          # and it advances
    t = torch.zeros(4)
    init(tmx.init.InitDesc("x_weight", {"__init__": tmx.init.Constant(
        0.5).dumps()}), t, g)
    assert bool((t == 0.5).all())
    with pytest.raises(ValueError, match="vector"):
        init(tmx.init.InitDesc("v_weight"), torch.zeros(3), g)


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    probs = rng.dirichlet(np.ones(5), size=9).astype(np.float32)
    lab = rng.integers(0, 5, 9).astype(np.float32)
    for name, kw in (("acc", {}), ("top_k_accuracy", {"top_k": 3}),
                     ("ce", {})):
        tm_, jm_ = tmx.metric.create(name, **kw), jmx.metric.create(name,
                                                                    **kw)
        tm_.update([torch.from_numpy(lab)],
                   [torch.from_numpy(probs).to(torch.bfloat16).float()])
        jm_.update([jmx.nd.array(lab)],
                   [jmx.nd.array(torch.from_numpy(probs)
                                 .to(torch.bfloat16).float().numpy())])
        assert tm_.get()[0] == jm_.get()[0]
        np.testing.assert_allclose(tm_.get()[1], jm_.get()[1], rtol=1e-6)
    comp = tmx.metric.create(["acc", "ce"])
    comp.update_dict({"softmax_label": torch.from_numpy(lab)},
                     {"softmax_output": torch.from_numpy(probs)})
    assert comp.get()[0] == ["accuracy", "cross-entropy"]


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(handle):
    rng = np.random.default_rng(7)
    data = rng.standard_normal((10, 3)).astype(np.float32)
    lab = np.arange(10, dtype=np.float32)
    ti = tmx.io.NDArrayIter(data, lab, batch_size=4,
                            last_batch_handle=handle)
    ji = jmx.io.NDArrayIter(data, lab, batch_size=4,
                            last_batch_handle=handle)
    assert [tuple(d.shape) for d in ti.provide_data] == \
        [tuple(d.shape) for d in ji.provide_data]
    for _ in range(2):
        tb, jb = list(ti), list(ji)
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
            assert a.pad == b.pad
        ti.reset()
        ji.reset()


def test_fit_one_short_epoch_over_ndarray_iter(narrow):
    """``fit`` over an ``NDArrayIter`` (12 rows, batch 4, last batch
    padded): 3 fused steps, the same params as 3 explicit forward /
    backward / update calls, a finite loss, and a train metric."""
    _, ts = narrow
    rng = np.random.default_rng(8)
    data = rng.random((10, 3, 64, 64)).astype(np.float32)
    lab = rng.integers(0, 10, 10).astype(np.float32)

    def module():
        m = tmx.mod.Module(ts, context="cpu")
        m.bind(data_shapes=[("data", (BATCH, 3, 64, 64))],
               label_shapes=[("softmax_label", (BATCH,))])
        m.init_params(tmx.init.Xavier(), generator=torch.Generator()
                      .manual_seed(1))
        return m

    seen = []
    fitted = module()
    it = tmx.io.NDArrayIter(data, lab, batch_size=BATCH)
    fitted.fit(it, eval_metric="acc", optimizer_params=OPT, num_epoch=1,
               force_init=False,
               batch_end_callback=lambda p: seen.append(
                   (p.nbatch, p.eval_metric.get()[1])))
    assert [n for n, _ in seen] == [0, 1, 2]
    assert 0.0 <= seen[-1][1] <= 1.0
    assert fitted._fused.num_update == 3
    assert np.isfinite(float(fitted._fused.last_loss))
    manual = module()
    manual.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    it.reset()
    for batch in it:
        manual.forward_backward(batch)
        manual.update()
    for got, want in zip(fitted.get_params(), manual.get_params()):
        for n in want:
            torch.testing.assert_close(got[n], want[n], rtol=0, atol=0)
    score = fitted.score(tmx.io.NDArrayIter(data, lab, batch_size=BATCH),
                         "acc")
    assert score[0][0] == "accuracy" and 0.0 <= score[0][1] <= 1.0


def test_step_frees_its_activations_without_the_cyclic_collector(narrow):
    """A training forward's intermediate tensors die with the step's last
    reference, not at the next cyclic garbage collection: the graph walk
    is a recursive closure (a reference cycle) and must not keep its
    cache of every activation, and with it the autograd graph, alive
    (on the card that held several steps' activations at once)."""
    import gc
    import weakref
    _, ts = narrow
    m = tmx.mod.Module(ts, context="cpu")
    m.bind(data_shapes=[("data", (BATCH, 3, 64, 64))],
           label_shapes=[("softmax_label", (BATCH,))])
    m.init_params(tmx.init.Xavier(), generator=torch.Generator()
                  .manual_seed(2))
    m.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    from mxnet_tpu_torch.ops import registry
    op = registry.get_op("Activation")
    real, kept = op.fn, []

    def tapped(data, **kw):
        out = real(data, **kw)
        kept.append(weakref.ref(out))
        return out

    feed = {"data": torch.rand(BATCH, 3, 64, 64),
            "softmax_label": torch.zeros(BATCH)}
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    op.fn = tapped
    try:
        loss, outs, aux = m._fused.forward_loss(feed)
        assert kept
        del loss, outs, aux
        alive = sum(r() is not None for r in kept)
    finally:
        op.fn = real
        if enabled:
            gc.enable()
    assert alive == 0, f"{alive} of {len(kept)} activations outlive the step"
