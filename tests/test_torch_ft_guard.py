"""The port's non-finite step guard (``mxnet_tpu_torch.module.fused``)
against the JAX package's, on the CPU.

- The four SGD cases of ``tests/test_ft_guard.py`` on the port: an
  injected NaN gradient (``nan_grad:step=N``) is skipped inside the
  step, params and optimizer state bit-identical to before it,
  ``fault_report()`` 1 / 1 then 1 / 0, and no new program; with
  ``MXTPU_FT_GUARD=0`` the NaN lands; ``MXTPU_FT_MAX_CONSEC_SKIPS``
  aborts; ``fault_report(reset=True)`` zeroes the counters. (The Adam
  case waits for the port's Adam rule.)
- Parity: the same batches with ``nan_grad:step=3`` through both
  packages' Modules from one set of numpy weights give the same skip
  counts and params within 2e-6 + 1e-5 relative (fp32 sums in another
  order over 6 steps).
- A clean guarded step is bit-identical to the unguarded step, and a
  skipped one leaves the aux and the in-step metric counters as they
  were.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import faultinject as jfi

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import faultinject
from mxnet_tpu_torch.base import MXNetError

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _reset_faults():
    faultinject.reset()
    tmx.fault_report(reset=True)
    yield
    faultinject.reset()


def _mlp(pkg, tag, bn=False):
    data = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(pkg.sym.Flatten(data), num_hidden=16,
                               name=f"g1{tag}")
    if bn:
        h = pkg.sym.BatchNorm(h, name=f"bn{tag}")
    h = pkg.sym.Activation(h, act_type="relu")
    h = pkg.sym.FullyConnected(h, num_hidden=10, name=f"g2{tag}")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _module(tag, bn=False, **opt_params):
    mod = tmx.mod.Module(symbol=_mlp(tmx, tag, bn), context="cpu")
    mod.bind(data_shapes=[("data", (8, 1, 8, 8))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        opt_params or {"learning_rate": 0.1, "momentum": 0.9}))
    return mod


def _batch(rng):
    return (rng.random((8, 1, 8, 8)).astype(np.float32),
            rng.integers(0, 10, (8,)).astype(np.float32))


def _step(mod, rng):
    x, y = _batch(rng)
    b = tmx.io.DataBatch([torch.from_numpy(x)], [torch.from_numpy(y)])
    mod.forward(b, is_train=True)
    mod.backward()
    mod.update()
    return b


def _opt_leaves(mod):
    st = pickle.loads(mod._fused.get_states())
    return {k: [np.asarray(x) for x in v] for k, v in st["state"].items()}


def _params(mod):
    a, x = mod.get_params()
    return {k: v.numpy().copy() for k, v in list(a.items()) +
            list(x.items())}


def test_nan_step_skipped_bit_identical_no_retrace():
    rng = np.random.default_rng(0)
    mod = _module("a", bn=True)
    for _ in range(3):
        _step(mod, rng)
    pre = _params(mod)
    opt_pre = _opt_leaves(mod)
    programs = len(mod._fused._programs)
    report = tmx.compile_report()["totals"]

    with faultinject.inject("nan_grad:step=3"):
        _step(mod, rng)                      # num_update 3: poisoned

    post = _params(mod)
    for k in pre:
        np.testing.assert_array_equal(pre[k], post[k],
                                      err_msg=f"{k} changed")
    for k, leaves in _opt_leaves(mod).items():
        for a, b in zip(opt_pre[k], leaves):
            np.testing.assert_array_equal(a, b, err_msg=f"state {k}")
    rep = tmx.fault_report()
    assert rep["skipped_steps"] == 1, rep
    assert rep["consecutive_skips"] == 1
    assert rep["guard_active"]
    assert rep["injected"] == {"nan_grad": 1}
    assert len(mod._fused._programs) == programs
    assert tmx.compile_report()["totals"]["retraces"] == \
        report["retraces"], "a skipped step must not change the program"

    # training continues after the skip; the consecutive count resets
    _step(mod, rng)
    rep = tmx.fault_report()
    assert rep["skipped_steps"] == 1
    assert rep["consecutive_skips"] == 0
    after = _params(mod)
    assert any(not np.array_equal(pre[k], after[k]) for k in pre)


def test_guard_off_lets_nan_through():
    """With ``MXTPU_FT_GUARD=0`` the NaN lands in the params: the guard,
    not luck, keeps them finite in the other cases."""
    with tmx.config.override("MXTPU_FT_GUARD", "0"):
        rng = np.random.default_rng(2)
        mod = _module("c")
        assert not mod._fused.guard_enabled
        _step(mod, rng)
        with faultinject.inject("nan_grad:step=1"):
            _step(mod, rng)
        args = mod.get_params()[0]
        assert any(not torch.isfinite(v).all() for v in args.values())
        assert not tmx.fault_report()["guard_active"]


def test_abort_after_k_consecutive_skips():
    with tmx.config.override("MXTPU_FT_MAX_CONSEC_SKIPS", "3"):
        rng = np.random.default_rng(3)
        mod = _module("d")
        with pytest.raises(MXNetError, match="consecutive non-finite"):
            with faultinject.inject(nan_grad={}):    # every step poisons
                for _ in range(20):
                    _step(mod, rng)
        # the abort came laggedly, within 2K steps
        assert mod._fused.num_update <= 6
        assert tmx.fault_report()["consecutive_skips"] >= 3
        assert tmx.fault.counters()["guard.aborts"] == 1


def test_report_reset_zeroes_counters():
    rng = np.random.default_rng(4)
    mod = _module("e")
    with faultinject.inject("nan_grad:step=0"):
        _step(mod, rng)
    assert tmx.fault_report()["skipped_steps"] == 1
    state = mod._fused.fault_state
    rep = tmx.fault_report(reset=True)
    assert rep["skipped_steps"] == 1
    assert tmx.fault_report()["skipped_steps"] == 0
    assert mod._fused.fault_state is state, "reset must write in place"


def test_clean_guarded_step_bit_identical_to_unguarded():
    """The guard's out-of-place update and select give the in-place
    update's bits on a clean step (params, momenta, aux)."""
    rng = np.random.default_rng(5)
    batches = [_batch(rng) for _ in range(3)]
    init = None
    out = []
    for flag in ("1", "0"):
        with tmx.config.override("MXTPU_FT_GUARD", flag):
            mod = _module("f", bn=True, learning_rate=0.1, momentum=0.9,
                          wd=1e-4)
            assert mod._fused.guard_enabled == (flag == "1")
            if init is None:
                init = _params(mod)
            mod.set_params({k: v for k, v in init.items()
                            if k in mod._arg_params},
                           {k: v for k, v in init.items()
                            if k in mod._aux_params})
            for x, y in batches:
                mod.forward(tmx.io.DataBatch([torch.from_numpy(x)],
                                             [torch.from_numpy(y)]),
                            is_train=True)
                mod.update()
            out.append((_params(mod), _opt_leaves(mod)))
    (pg, og), (pu, ou) = out
    for k in pg:
        np.testing.assert_array_equal(pg[k], pu[k], err_msg=k)
    for k in og:
        for a, b in zip(og[k], ou[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_skipped_step_keeps_aux_and_metric_counters():
    rng = np.random.default_rng(6)
    mod = _module("g", bn=True)
    acc = tmx.metric.Accuracy()
    ce = tmx.metric.CrossEntropy()
    for _ in range(2):
        b = _step(mod, rng)
        mod.update_metric(acc, b.label)
        mod.update_metric(ce, b.label)
    counters = [mod._fused.metric_state(i).clone() for i in range(2)]
    aux = {k: v.clone() for k, v in mod._fused._aux.items()}
    with faultinject.inject("nan_grad:step=2"):
        b = _step(mod, rng)
    mod.update_metric(acc, b.label)
    mod.update_metric(ce, b.label)
    for i, c in enumerate(counters):
        assert torch.equal(mod._fused.metric_state(i), c)
    for k, v in aux.items():
        assert torch.equal(mod._fused._aux[k], v), k


def test_skip_counts_and_params_match_jax():
    """One sequence with ``nan_grad:step=3``, both packages, one set of
    numpy weights."""
    rng = np.random.default_rng(7)
    batches = [_batch(rng) for _ in range(6)]
    tsym = _mlp(tmx, "p")
    a, _, _ = tsym.infer_shape(data=(8, 1, 8, 8))
    wr = np.random.default_rng(8)
    args = {n: (wr.standard_normal(s) * 0.2).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), a)
            if n not in ("data", "softmax_label")}
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}

    def run(pkg, fi, arr, ctx):
        pkg.fault_report(reset=True)
        mod = pkg.mod.Module(symbol=_mlp(pkg, "p"), context=ctx)
        mod.bind(data_shapes=[("data", (8, 1, 8, 8))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(arg_params={k: arr(v) for k, v in args.items()},
                        aux_params={})
        mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
        with fi.inject("nan_grad:step=3"):
            for x, y in batches:
                mod.forward(pkg.io.DataBatch([arr(x)], [arr(y)]),
                            is_train=True)
                mod.backward()
                mod.update()
        rep = pkg.fault_report()
        return ({k: np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                               else v.numpy())
                 for k, v in mod.get_params()[0].items()},
                rep["skipped_steps"], rep["consecutive_skips"])

    tp, ts, tc = run(tmx, faultinject, torch.from_numpy, "cpu")
    jp, js, jc = run(jmx, jfi, jmx.nd.array, jmx.cpu())
    assert (ts, tc) == (js, jc) == (1, 0)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=2e-6,
                                   err_msg=k)
