"""The port's eager optimizer classes (``mxnet_tpu_torch.optimizer``),
schedulers and ``Updater`` against the JAX package's, on the CPU.

- Every registered class, 5 updates through an ``Updater`` from the same
  seeded numpy weights and gradients (the cases of the JAX package's
  ``tests/test_functional_opt.py`` and ``tests/test_optimizer.py``), held
  against ``mxnet_tpu.optimizer``: rtol 2e-6, atol 1e-7 on weights and
  every state leaf (the same fp32 operations; the bias corrections are
  Python floats in both).
- sgld, whose noise cannot equal JAX's draws: the update less its
  deterministic part has mean 0 and variance lr.
- lr / wd multipliers, ``_get_lr`` under a scheduler, and the three new
  schedulers against the JAX package's values (exact: Python floats).
- ``multi_precision``: a bf16 weight trains an fp32 master, against the
  JAX package's (the master rtol 2e-6; the bf16 weight equal).
- ``Updater`` states cross the packages in both directions, and the JAX
  package's ``multi_precision`` states load in the port; a pickled JAX
  optimizer object raises.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu import lr_scheduler as jlrs

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch.base import MXNetError

CASES = [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "clip_gradient": 0.3}),
    ("nag", {}),
    ("nag", {"momentum": 0.9}),
    ("adam", {}),
    ("adam", {"clip_gradient": 0.1}),
    ("adagrad", {}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True}),
    ("rmsprop", {"clip_weights": 0.5}),
    ("adadelta", {}),
    ("ftrl", {}),
    ("adamax", {}),
    ("adamax", {"clip_gradient": 0.1}),
    ("nadam", {}),
    ("nadam", {"clip_gradient": 0.1}),
    ("ftml", {}),
    ("ftml", {"clip_gradient": 0.1}),
    ("lbsgd", {"momentum": 0.9, "warmup_strategy": "lars"}),
    ("lbsgd", {"momentum": 0.9, "warmup_strategy": "linear",
               "warmup_epochs": 2, "updates_per_epoch": 4,
               "batch_scale": 4}),
    ("lbsgd", {}),
    ("signum", {"momentum": 0.9, "wd_lh": 0.01}),
    ("signum", {"momentum": 0.0}),
    ("dcasgd", {"momentum": 0.5}),
    ("dcasgd", {}),
    ("test", {}),
]
LR, WD = 0.05, 0.01


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for v in s for x in _leaves(v)]
    return [s.asnumpy()]


def _run(pkg, opt_mod, name, kwargs, w0, grads, idx2name=None):
    o = opt_mod.create(name, learning_rate=LR, wd=WD,
                       param_idx2name=idx2name or {}, **kwargs)
    upd = opt_mod.get_updater(o)
    w = pkg.nd.array(w0.copy())
    for g in grads:
        upd(0, pkg.nd.array(g), w)
    return w.asnumpy(), _leaves(upd.states[0]), o


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_eager_class_matches_jax(name, kwargs):
    rng = np.random.RandomState(42)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(5)]
    with tmx.cpu():
        tw, ts, to = _run(tmx, topt, name, kwargs, w0, grads)
    jw, js, jo = _run(jmx, jopt, name, kwargs, w0, grads)
    np.testing.assert_allclose(tw, jw, rtol=2e-6, atol=1e-7, err_msg=name)
    assert len(ts) == len(js), name
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7,
                                   err_msg=f"{name} state")
    # (the reference's Test optimizer counts no update)
    assert to.num_update == jo.num_update == (0 if name == "test" else 5)
    if name == "nadam":
        assert to.m_schedule == pytest.approx(jo.m_schedule, rel=1e-12)


def test_sgld_noise_statistics():
    rng = np.random.RandomState(1)
    w0 = rng.randn(64, 64).astype(np.float32)
    g = rng.randn(64, 64).astype(np.float32)
    lr = 0.04
    with tmx.cpu():
        tmx.random.seed(3)
        o = topt.create("sgld", learning_rate=lr, wd=WD)
        w = tmx.nd.array(w0.copy())
        topt.get_updater(o)(0, tmx.nd.array(g), w)
        noise = (w.asnumpy() - (w0 - lr / 2 * (g + WD * w0))).ravel()
    assert abs(noise.mean()) < 4 * np.sqrt(lr / noise.size)
    assert abs(noise.var() / lr - 1) < 0.1


def test_lr_wd_mult_and_scheduler():
    names = {0: "w_weight", 1: "b_bias", 2: "bn_gamma"}
    for pkg_opt in (topt, jopt):
        o = pkg_opt.create("sgd", learning_rate=1.0, param_idx2name=names,
                           wd=0.1)
        o.set_lr_mult({"w_weight": 0.5})
        assert o._get_lr(0) == 0.5 and o._get_lr(1) == 1.0
        assert o._get_wd(1) == 0.0
        assert o._get_wd(0) == pytest.approx(0.1)
        assert o._get_wd(2) == pytest.approx(0.1)
    rng = np.random.RandomState(0)
    w0 = rng.randn(4).astype(np.float32)
    grads = [rng.randn(4).astype(np.float32) for _ in range(3)]
    for kw in ({"lr_scheduler_fn": "factor"}, {"lr_scheduler_fn": "cos"}):
        got = []
        for pkg, opt_mod, lrs in ((tmx, topt, tlrs), (jmx, jopt, jlrs)):
            sched = lrs.FactorScheduler(step=1, factor=0.5) \
                if kw["lr_scheduler_fn"] == "factor" \
                else lrs.CosineScheduler(max_update=4, base_lr=0.1)
            o = opt_mod.create("sgd", learning_rate=0.1, momentum=0.9,
                               lr_scheduler=sched,
                               param_idx2name={0: "x_weight"})
            o.set_lr_mult({"x_weight": 0.25})
            upd = opt_mod.get_updater(o)
            w = pkg.nd.array(w0.copy(), ctx=tmx.cpu() if pkg is tmx
                             else None)
            for g in grads:
                upd(0, pkg.nd.array(g, ctx=tmx.cpu() if pkg is tmx
                                    else None), w)
            got.append(w.asnumpy())
        np.testing.assert_allclose(got[0], got[1], rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("make", [
    lambda m: m.PolyScheduler(max_update=20, base_lr=0.3, pwr=2),
    lambda m: m.CosineScheduler(max_update=20, base_lr=0.3, final_lr=0.01,
                                warmup_steps=4, warmup_begin_lr=0.05),
    lambda m: m.WarmupScheduler(m.FactorScheduler(step=3, factor=0.7),
                                warmup_steps=5, warmup_begin_lr=0.0),
], ids=["poly", "cosine", "warmup"])
def test_new_schedulers_match_jax(make):
    ts, js = make(tlrs), make(jlrs)
    for s in (ts, js):
        s.base_lr = getattr(s, "base_lr", 0.3)
    for n in range(0, 25):
        assert ts(n) == js(n), n
    with pytest.raises(ValueError):
        tlrs.PolyScheduler(max_update=0)


def test_multi_precision_bf16():
    rng = np.random.RandomState(5)
    w0 = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) for _ in range(3)]
    outs = []
    for pkg, opt_mod in ((tmx, topt), (jmx, jopt)):
        kw = {"ctx": tmx.cpu()} if pkg is tmx else {}
        o = opt_mod.create("adam", learning_rate=0.1, multi_precision=True)
        upd = opt_mod.get_updater(o)
        w = pkg.nd.array(w0, **kw).astype("bfloat16")
        for g in grads:
            upd(0, pkg.nd.array(g, **kw).astype("bfloat16"), w)
        st = upd.states[0]
        assert isinstance(st, opt_mod._MPState)
        assert st.master.dtype == np.float32
        outs.append((w.asnumpy().astype(np.float32), st.master.asnumpy(),
                     upd))
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(outs[0][0], outs[1][0])

    # the JAX package's multi_precision states load in the port
    blob = outs[1][2].get_states()
    upd = topt.get_updater(topt.create("adam", multi_precision=True))
    upd.set_states(blob, device="cpu")
    st = upd.states[0]
    assert isinstance(st, topt._MPState)
    np.testing.assert_array_equal(st.master.asnumpy(), outs[1][1])
    assert len(st.inner) == 2


@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "ftml",
                                  "dcasgd"])
def test_updater_states_cross_packages(name):
    kw = {"momentum": 0.9} if name in ("sgd", "dcasgd") else {}
    rng = np.random.RandomState(2)
    w0 = rng.randn(3, 4).astype(np.float32)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(4)]

    def fresh(pkg, opt_mod):
        o = opt_mod.create(name, learning_rate=LR, wd=WD, **kw)
        return opt_mod.get_updater(o)

    def nd(pkg, a):
        return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx \
            else pkg.nd.array(a)

    # two steps in one package, its states into the other, two more
    for src, dst in (((tmx, topt), (jmx, jopt)), ((jmx, jopt), (tmx, topt))):
        us = fresh(*src)
        w = nd(src[0], w0.copy())
        for g in grads[:2]:
            us(0, nd(src[0], g), w)
        blob = us.get_states()
        ud = fresh(*dst)
        if dst[0] is tmx:
            ud.set_states(blob, device="cpu")
        else:
            ud.set_states(blob)
        w2 = nd(dst[0], w.asnumpy())
        for upd, wt, pkg in ((us, w, src[0]), (ud, w2, dst[0])):
            # the per-index counts travel with the optimizer, not the
            # states: carry them so the bias corrections agree
            upd.optimizer._index_update_count = {0: 2}
            upd.optimizer.num_update = 2
            for g in grads[2:]:
                upd(0, nd(pkg, g), wt)
        np.testing.assert_allclose(w2.asnumpy(), w.asnumpy(), rtol=2e-6,
                                   atol=1e-7, err_msg=f"{src[0].__name__}")
        for a, b in zip(_leaves(ud.states[0]), _leaves(us.states[0])):
            np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)


def test_pickled_jax_optimizer_raises_in_port():
    upd = jopt.get_updater(jopt.create("sgd", momentum=0.9))
    w = jmx.nd.array(np.ones(3, np.float32))
    upd(0, jmx.nd.array(np.ones(3, np.float32)), w)
    blob = upd.get_states(dump_optimizer=True)
    with pytest.raises(MXNetError, match="cannot cross packages"):
        topt.get_updater(topt.create("sgd")).set_states(blob, device="cpu")
    # the port's own dump_optimizer round trip keeps the optimizer
    o = topt.create("adam", learning_rate=0.3)
    u = topt.get_updater(o)
    with tmx.cpu():
        u(0, tmx.nd.array(np.ones(3, np.float32)),
          tmx.nd.array(np.ones(3, np.float32)))
    u2 = topt.get_updater(topt.create("adam"))
    u2.set_states(u.get_states(dump_optimizer=True), device="cpu")
    assert u2.optimizer.lr == 0.3 and len(u2.states[0]) == 2


def test_optimizer_ops_registered():
    """The ten update ops under the reference's names, through ``nd``."""
    rng = np.random.RandomState(4)
    w, g, m, v = (rng.randn(5).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    with tmx.cpu():
        tw, tm, tv = tmx.nd.adam_update(
            tmx.nd.array(w), tmx.nd.array(g), tmx.nd.array(m),
            tmx.nd.array(v), lr=0.1, wd=0.01)
    jw, jm, jv = jmx.nd.adam_update(
        jmx.nd.array(w), jmx.nd.array(g), jmx.nd.array(m), jmx.nd.array(v),
        lr=0.1, wd=0.01)
    for a, b in ((tw, jw), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=2e-6,
                                   atol=1e-7)
    for name in ("sgd_update", "sgd_mom_update", "nag_mom_update",
                 "adam_update", "rmsprop_update", "rmspropalex_update",
                 "ftrl_update", "signsgd_update", "signum_update",
                 "ftml_update"):
        assert hasattr(tmx.nd, name) and hasattr(tmx.sym, name), name


def test_trainer_every_rule_and_states(tmp_path):
    """The Gluon Trainer takes each rule; save_states / load_states
    round-trip."""
    from mxnet_tpu_torch import autograd, gluon
    for name in ("adam", "nadam", "rmsprop", "sgld", "ftml"):
        with tmx.cpu():
            net = gluon.nn.Dense(2, in_units=3)
            net.initialize(ctx=tmx.cpu())
            tr = gluon.Trainer(net.collect_params(), name,
                               {"learning_rate": 0.1})
            x = tmx.nd.ones((4, 3))
            for _ in range(2):
                with autograd.record():
                    loss = net(x).sum()
                loss.backward()
                tr.step(4)
            f = str(tmp_path / f"{name}.states")
            tr.save_states(f)
            before = {i: [x.asnumpy() for x in _leaves_nd(s)]
                      for i, s in tr._updaters[0].states.items()}
            tr.load_states(f)
            assert tr._optimizer.num_update == 2
            for i, s in tr._updaters[0].states.items():
                for a, b in zip(_leaves_nd(s), before[i]):
                    np.testing.assert_array_equal(a.asnumpy(), b)
            with autograd.record():
                loss = net(x).sum()
            loss.backward()
            tr.step(4)
            assert all(np.isfinite(p.data().asnumpy()).all()
                       for p in net.collect_params().values())


def _leaves_nd(s):
    if s is None:
        return []
    return list(s) if isinstance(s, (tuple, list)) else [s]
