"""The port's Module beyond the SGD fused step, against the JAX package's,
on the CPU: ``Module(fused=False)`` (the bound Executor and the
``Updater``), the fused step with Adam, Nadam and LBSGD, optimizer states
crossing the packages, the guard with Adam, ``backward(out_grads)``
leaving the fused regime, ``get_input_grads``, ``reshape`` and
``Monitor``.

Tolerances: params and aux rtol 1e-5, atol 2e-6 after a few steps (the
two packages' fp32 matrix products and BatchNorm statistics sum in other
orders; the same limit as ``tests/test_torch_ft_guard.py``'s parity
check); the fused Adam-family steps take their bias corrections in fp32
in both packages.
"""
import logging
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import faultinject as jfi

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import faultinject
from mxnet_tpu_torch.base import MXNetError

BATCH = 8
SHAPE = (BATCH, 1, 6, 6)
RTOL, ATOL = 1e-5, 2e-6


def _sym(pkg, tag, bn=True):
    data = pkg.sym.Variable("data")
    # no bias in front of the BatchNorm: its gradient would be rounding
    # noise, which Adam's normalisation blows up to lr-sized steps
    h = pkg.sym.FullyConnected(pkg.sym.Flatten(data, name=f"eflat{tag}"),
                               num_hidden=16, name=f"e1{tag}", no_bias=bn)
    if bn:
        h = pkg.sym.BatchNorm(h, name=f"ebn{tag}", fix_gamma=False)
    h = pkg.sym.Activation(h, act_type="relu", name=f"erelu{tag}")
    h = pkg.sym.FullyConnected(h, num_hidden=10, name=f"e2{tag}")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _init(tag, bn=True, seed=8):
    s = _sym(tmx, tag, bn)
    a, _, x = s.infer_shape(data=SHAPE)
    wr = np.random.default_rng(seed)
    args = {n: (wr.standard_normal(sh) * 0.3).astype(np.float32)
            for n, sh in zip(s.list_arguments(), a)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.abs(wr.standard_normal(sh)) + 0.5).astype(np.float32)
           for n, sh in zip(s.list_auxiliary_states(), x)}
    return args, aux


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random(SHAPE).astype(np.float32),
             rng.integers(0, 10, (BATCH,)).astype(np.float32))
            for _ in range(n)]


def _np(v):
    return np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                      else v.detach().cpu().numpy())


def _module(pkg, tag, fused, optimizer, opt_params, bn=True, **bind_kw):
    ctx = "cpu" if pkg is tmx else jmx.cpu()
    arr = torch.from_numpy if pkg is tmx else jmx.nd.array
    mod = pkg.mod.Module(symbol=_sym(pkg, tag, bn), context=ctx,
                         fused=fused)
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (BATCH,))], **bind_kw)
    args, aux = _init(tag, bn)
    mod.init_params(arg_params={k: arr(v) for k, v in args.items()},
                    aux_params={k: arr(v) for k, v in aux.items()})
    mod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    return mod, arr


def _train(pkg, mod, arr, batches):
    for x, y in batches:
        mod.forward(pkg.io.DataBatch([arr(x)], [arr(y)]), is_train=True)
        mod.backward()
        mod.update()


def _state(mod):
    a, x = mod.get_params()
    return {k: _np(v).copy() for k, v in list(a.items()) + list(x.items())}


def _close(got, want, what=""):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


OPTS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
    "adam": {"learning_rate": 0.01, "wd": 1e-4},
    "nadam": {"learning_rate": 0.01},
    "lbsgd": {"learning_rate": 0.1, "momentum": 0.9,
              "warmup_strategy": "linear", "warmup_epochs": 1,
              "updates_per_epoch": 4, "batch_scale": 2},
}


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_eager_module_matches_jax(optimizer):
    """``Module(fused=False)``: the Executor's forward / backward and the
    Updater, 4 steps; aux pinned after the first (folded in the training
    forward and again in the backward, as the reference does)."""
    batches = _batches(4)
    res = {}
    for pkg in (tmx, jmx):
        mod, arr = _module(pkg, "a", False, optimizer, OPTS[optimizer])
        assert mod._fused is None
        _train(pkg, mod, arr, batches[:1])
        one = _state(mod)
        _train(pkg, mod, arr, batches[1:])
        res[pkg] = (one, _state(mod), [_np(o) for o in mod.get_outputs()])
    _close(res[tmx][0], res[jmx][0], "after one step")
    _close(res[tmx][1], res[jmx][1], "after four steps")
    np.testing.assert_allclose(res[tmx][2][0], res[jmx][2][0], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("optimizer", ["adam", "nadam", "lbsgd"])
def test_fused_rule_matches_jax_and_states_cross(optimizer):
    """The fused step with another rule than SGD, 3 steps against the JAX
    fused step; then each package's optimizer states loaded into a fresh
    module of the other, 2 more steps each, still equal."""
    batches = _batches(5, seed=1)
    mods = {}
    for pkg in (tmx, jmx):
        mod, arr = _module(pkg, "b", True, optimizer, OPTS[optimizer])
        assert mod._fused is not None
        _train(pkg, mod, arr, batches[:3])
        mods[pkg] = (mod, arr)
    _close(_state(mods[tmx][0]), _state(mods[jmx][0]), optimizer)
    tm, jm = mods[tmx][0], mods[jmx][0]
    assert int(tm._fused._t) == tm._fused.num_update == 3
    tst = pickle.loads(tm._fused.get_states())
    jst = pickle.loads(jm._fused.get_states())
    assert tst["num_update"] == jst["num_update"] == 3
    for n, leaves in jst["state"].items():
        assert len(tst["state"][n]) == len(leaves), n
        for a, b in zip(tst["state"][n], leaves):
            assert np.shape(a) == np.shape(b), n
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=n)
    # each package resumes from the other's states and params
    for src, dst in ((tmx, jmx), (jmx, tmx)):
        smod = mods[src][0]
        blob = smod._fused.get_states()
        params = _state(smod)
        dmod, arr = _module(dst, "b", True, optimizer, OPTS[optimizer])
        dmod.set_params({k: arr(v) for k, v in params.items()
                         if k in dmod._arg_params},
                        {k: arr(v) for k, v in params.items()
                         if k not in dmod._arg_params})
        dmod._fused.set_states(blob)
        dmod._optimizer.num_update = dmod._fused.num_update
        ref, rarr = _module(src, "b", True, optimizer, OPTS[optimizer])
        ref.set_params({k: rarr(v) for k, v in params.items()
                        if k in ref._arg_params},
                       {k: rarr(v) for k, v in params.items()
                        if k not in ref._arg_params})
        ref._fused.set_states(blob)
        ref._optimizer.num_update = ref._fused.num_update
        _train(dst, dmod, arr, batches[3:])
        _train(src, ref, rarr, batches[3:])
        _close(_state(dmod), _state(ref), f"{src.__name__} -> "
               f"{dst.__name__}")
        if dst is tmx:
            assert int(dmod._fused._t) == 5


def test_guard_protects_adam_state_too():
    """A NaN step leaves params and every Adam leaf bit-identical, and
    ``t`` advances on it (the next bias correction is step 4's)."""
    faultinject.reset()
    tmx.fault_report(reset=True)
    batches = _batches(4, seed=2)
    mod, arr = _module(tmx, "c", True, "adam", OPTS["adam"])
    _train(tmx, mod, arr, batches[:2])
    pre = _state(mod)
    opt_pre = pickle.loads(mod._fused.get_states())["state"]
    with faultinject.inject("nan_grad:step=2"):
        _train(tmx, mod, arr, batches[2:3])
    post = _state(mod)
    for k in pre:
        np.testing.assert_array_equal(pre[k], post[k], err_msg=k)
    opt_post = pickle.loads(mod._fused.get_states())["state"]
    for k in opt_pre:
        for a, b in zip(opt_pre[k], opt_post[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert tmx.fault_report()["skipped_steps"] == 1
    assert int(mod._fused._t) == 3 == mod._fused.num_update
    faultinject.reset()
    # the same in the JAX package: the 4th step's params agree
    jmod, jarr = _module(jmx, "c", True, "adam", OPTS["adam"])
    _train(jmx, jmod, jarr, batches[:2])
    with jfi.inject("nan_grad:step=2"):
        _train(jmx, jmod, jarr, batches[2:3])
    jfi.reset()
    _train(jmx, jmod, jarr, batches[3:])
    _train(tmx, mod, arr, batches[3:])
    _close(_state(mod), _state(jmod), "after the skipped step")


def test_backward_out_grads_leaves_fused_regime(caplog):
    batches = _batches(2, seed=3)
    mod, arr = _module(tmx, "d", None, "sgd", OPTS["sgd"])
    assert mod._fused is not None
    x, y = batches[0]
    mod.forward(tmx.io.DataBatch([arr(x)], [arr(y)]), is_train=True)
    with caplog.at_level(logging.WARNING):
        mod.backward(out_grads=[torch.zeros(BATCH, 10)])
    assert mod._fused is None
    assert "disables the fused update path" in caplog.text
    mod.update()
    mod2, arr = _module(tmx, "d", None, "sgd", OPTS["sgd"])
    _train(tmx, mod2, arr, batches[:1])
    x, y = batches[1]
    mod2.forward(tmx.io.DataBatch([arr(x)], [arr(y)]), is_train=True)
    with pytest.raises(MXNetError, match="once training has begun"):
        mod2.backward(out_grads=[torch.zeros(BATCH, 10)])
    with pytest.raises(MXNetError, match="impossible"):
        _module(tmx, "d", True, "sgd", OPTS["sgd"], grad_req="add")


def test_input_grads_and_reshape_match_jax():
    batches = _batches(1, seed=4)
    x, y = batches[0]
    got = {}
    for pkg in (tmx, jmx):
        mod, arr = _module(pkg, "e", None, "sgd", OPTS["sgd"],
                           inputs_need_grad=True)
        assert mod._fused is None        # inputs_need_grad: eager loop
        mod.forward(pkg.io.DataBatch([arr(x)], [arr(y)]), is_train=True)
        mod.backward()
        got[pkg] = _np(mod.get_input_grads()[0])
        # a batch of 4 reshapes the executor, the params shared
        x4, y4 = x[:4], y[:4]
        mod.forward(pkg.io.DataBatch([arr(x4)], [arr(y4)]), is_train=False)
        got[(pkg, "r")] = _np(mod.get_outputs()[0])
    np.testing.assert_allclose(got[tmx], got[jmx], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got[(tmx, "r")], got[(jmx, "r")], rtol=RTOL,
                               atol=ATOL)
    assert got[(tmx, "r")].shape == (4, 10)


@pytest.mark.parametrize("fused", [False, None])
def test_monitor_matches_jax(fused):
    """``Monitor(interval=2)``: the same names and statistics as the JAX
    package's on batches 0 and 2, none on batch 1; in the fused regime
    the tapped forward runs at the pre-update params."""
    batches = _batches(3, seed=5)
    res = {}
    for pkg in (tmx, jmx):
        mod, arr = _module(pkg, "f", fused, "sgd", OPTS["sgd"])
        mon = pkg.monitor.Monitor(2, pattern=".*", sort=True)
        mod.install_monitor(mon)
        out = []
        for x, y in batches:
            mon.tic()
            mod.forward(pkg.io.DataBatch([arr(x)], [arr(y)]),
                        is_train=True)
            mod.backward()
            mod.update()
            out.append(mon.toc())
        res[pkg] = out
    for t_batch, j_batch in zip(res[tmx], res[jmx]):
        assert [k for _, k, _ in t_batch] == [k for _, k, _ in j_batch]
        for (_, k, tv), (_, _, jv) in zip(t_batch, j_batch):
            np.testing.assert_allclose(float(tv), float(jv), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert res[tmx][1] == [] and len(res[tmx][0]) > 10


def test_optimizer_states_cross_in_updater_regime(tmp_path):
    batches = _batches(4, seed=6)
    for src, dst in ((tmx, jmx), (jmx, tmx)):
        smod, sarr = _module(src, "g", False, "adam", OPTS["adam"])
        _train(src, smod, sarr, batches[:2])
        f = str(tmp_path / f"{src.__name__}.states")
        smod.save_optimizer_states(f)
        params = _state(smod)
        dmod, darr = _module(dst, "g", False, "adam", OPTS["adam"])
        dmod.set_params({k: darr(v) for k, v in params.items()
                         if k in dmod._arg_params},
                        {k: darr(v) for k, v in params.items()
                         if k not in dmod._arg_params})
        dmod.load_optimizer_states(f)
        for m in (smod, dmod):
            m._optimizer._index_update_count = {
                i: 2 for i in range(len(m._param_names))}
            m._optimizer.num_update = 2
        _train(src, smod, sarr, batches[2:])
        _train(dst, dmod, darr, batches[2:])
        _close(_state(dmod), _state(smod), src.__name__)


def test_fixed_params_and_grad_req_null():
    batches = _batches(2, seed=7)
    mod = tmx.mod.Module(symbol=_sym(tmx, "h"), context="cpu",
                         fixed_param_names=["e1h_weight"], fused=False)
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (BATCH,))])
    args, aux = _init("h")
    mod.init_params(arg_params={k: torch.from_numpy(v)
                                for k, v in args.items()},
                    aux_params={k: torch.from_numpy(v)
                                for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPTS["sgd"])
    _train(tmx, mod, torch.from_numpy, batches)
    p = _state(mod)
    np.testing.assert_array_equal(p["e1h_weight"], args["e1h_weight"])
    assert not np.array_equal(p["e2h_weight"], args["e2h_weight"])
    # an inference bind: grad_req null everywhere, no gradient arrays
    inf = tmx.mod.Module(symbol=_sym(tmx, "h"), context="cpu")
    inf.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (BATCH,))],
             for_training=False)
    assert inf._exec.grad_dict == {}
    assert inf._exec.pass_report["tag"] == "executor_infer"


RULES = ["sgd", "signum", "ftml", "dcasgd", "nag", "adam", "adagrad",
         "rmsprop", "adadelta", "ftrl", "adamax", "nadam", "lbsgd", "test"]


@pytest.mark.parametrize("optimizer", RULES)
def test_fused_step_every_rule_matches_jax(optimizer):
    """Each registered class's functional rule inside the fused step
    (eager here; captured on the card), 3 steps against the JAX
    package's fused step, with the guard on; the state leaves too."""
    batches = _batches(3, seed=9)
    params = {"learning_rate": 0.01, "wd": 1e-4}
    if optimizer in ("sgd", "nag", "dcasgd", "lbsgd"):
        params["momentum"] = 0.9
    res = {}
    for pkg in (tmx, jmx):
        mod, arr = _module(pkg, "r", True, optimizer, params)
        _train(pkg, mod, arr, batches)
        res[pkg] = (_state(mod), pickle.loads(mod._fused.get_states()))
    _close(res[tmx][0], res[jmx][0], optimizer)
    ts, js = res[tmx][1]["state"], res[jmx][1]["state"]
    for n in js:
        assert len(ts[n]) == len(js[n]), n
        for a, b in zip(ts[n], js[n]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{optimizer} {n}")


def test_fused_sgld_draws_from_its_generator():
    """sgld in the fused step: the step's own generator, seeded from the
    global seed, makes a run repeatable; the noise moves the params off
    the deterministic update (noise scale 0 through the test hook)."""
    from mxnet_tpu_torch.parallel import functional_opt as tfo
    batches = _batches(2, seed=10)
    runs = []
    for scale in (1.0, 1.0, 0.0):
        tmx.random.seed(4)
        old, tfo.sgld_noise_scale = tfo.sgld_noise_scale, scale
        try:
            mod, arr = _module(tmx, "s", True, "sgld",
                               {"learning_rate": 0.01})
            _train(tmx, mod, arr, batches)
        finally:
            tfo.sgld_noise_scale = old
        runs.append(_state(mod))
        assert int(mod._fused._t) == 2
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)
    assert any(not np.array_equal(runs[0][k], runs[2][k]) for k in runs[0]
               if "weight" in k)


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "rmsprop", "nadam"])
def test_group_slice_update_equals_per_view_update(optimizer):
    """An elementwise rule updates each (lr_mult, wd) group as one slice
    of the flat buffers; the result is bit for bit the update over a
    view per parameter. sgd (written in place, no gradient gather) and
    nadam (a 0-dim leaf) take the per-view path."""
    batches = _batches(2, seed=11)
    params = {"learning_rate": 0.01, "wd": 1e-4}
    if optimizer == "sgd":
        params["momentum"] = 0.9
    res = []
    for per_view in (False, True):
        mod, arr = _module(tmx, "v", True, optimizer, params)
        f = mod._fused
        spans = [f._group_span(ns) for _, ns in f._groups]
        if optimizer in ("sgd", "nadam"):
            assert spans == [None] * len(spans)
        else:
            assert all(s is not None for s in spans) and len(spans) == 2
        if per_view:
            f._group_span = lambda ns: None
        _train(tmx, mod, arr, batches)
        res.append((_state(mod), pickle.loads(f.get_states())["state"]))
    for k in res[0][0]:
        np.testing.assert_array_equal(res[0][0][k], res[1][0][k], err_msg=k)
    for k in res[0][1]:
        for a, b in zip(res[0][1][k], res[1][1][k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
