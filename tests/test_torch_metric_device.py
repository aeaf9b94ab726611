"""The port's in-step metric counters (``mxnet_tpu_torch.metric_device``)
against the host path and against the JAX package's, on the CPU.

- The eight cases of ``tests/test_metric_device.py`` on the port's
  Module: each pins the counters against the host path on the same step
  outputs (exact: accuracy and top-k are counts; 1e-9 on the ratios).
  Two are adapted: the port has no eager update path and no
  ``Module.reshape``, so the fit parity case holds the port's in-step
  ``fit`` against the JAX package's ``fit`` from the same numpy weights
  (rtol 1e-4, the reference case's tolerance; 3 epochs of fp32 SGD in
  two packages differ by ~1e-6 in the params), and the shape-change case
  changes the label's shape instead of the batch's.
- Each device rule's counter against the JAX package's rule on the same
  arrays: integer counters exactly, float counters within rtol 1e-6
  (fp32 sums in another order).
- Top-k ties: the rule keeps the lower class index, as ``lax.top_k``
  orders ties, checked row by row on scores with many ties.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import metric_device as jmd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import metric_device as tmd
from torch_threads import one_torch_thread  # noqa: F401


def _mlp(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=10,
                                 name="fc")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _mod(bs=20):
    mod = tmx.mod.Module(_mlp(tmx), context="cpu")
    mod.bind(data_shapes=[("data", (bs, 8))],
             label_shapes=[("softmax_label", (bs,))])
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd")
    return mod


def _batch(rng, bs=20):
    x = torch.from_numpy(rng.random((bs, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, bs).astype(np.float32))
    return tmx.io.DataBatch([x], [y])


def _step(mod, rng, bs=20):
    b = _batch(rng, bs)
    mod.forward(b, is_train=True)
    mod.backward()
    mod.update()
    return b


def _host(ref, mod, b, label=None):
    ref.update_dict({"softmax_label": b.label[0] if label is None
                     else label},
                    {"softmax_output": mod.get_outputs()[0]})


def test_fit_metric_parity_in_step_vs_jax():
    """``fit`` with the composite counted in the step matches the JAX
    package's ``fit`` (its in-step counters) from the same weights."""
    rng = np.random.default_rng(3)
    x = rng.random((200, 20)).astype(np.float32)
    y = ((x.sum(1) * 2).astype(np.int32) % 10).astype(np.float32)
    w = (rng.standard_normal((10, 20)) * 0.3).astype(np.float32)
    args = {"fc_weight": w, "fc_bias": np.zeros(10, np.float32)}

    def run(pkg, **ctx):
        it = pkg.io.NDArrayIter(x, y, batch_size=50)
        mod = pkg.mod.Module(symbol=_mlp(pkg), **ctx)
        em = pkg.metric.CompositeEvalMetric(
            [pkg.metric.Accuracy(), pkg.metric.TopKAccuracy(top_k=3),
             pkg.metric.CrossEntropy()])
        sp = pkg.callback.Speedometer(50, 2, auto_reset=True)
        mod.fit(it, eval_metric=em, num_epoch=3, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                batch_end_callback=sp,
                arg_params={k: pkg.nd.array(v) if pkg is jmx else v
                            for k, v in args.items()})
        return em, mod

    tem, tmod = run(tmx, context="cpu")
    jem, _ = run(jmx, context=jmx.cpu())
    assert all(m._dev_acc is not None for m in tem.metrics), \
        "fit's metrics did not take the in-step counters"
    assert tmod._fused.num_metric_slots == 3
    np.testing.assert_allclose(tem.get()[1], jem.get()[1], rtol=1e-4)


def test_two_metric_objects_and_label_shape_change_parity():
    """A second metric object takes a slot of its own; a label of another
    shape folds the counters exactly and attaches anew."""
    rng = np.random.default_rng(0)
    mod = _mod(20)
    acc, topk = tmx.metric.Accuracy(), tmx.metric.TopKAccuracy(top_k=3)
    acc_ref, topk_ref = tmx.metric.Accuracy(), \
        tmx.metric.TopKAccuracy(top_k=3)
    for i in range(9):
        b = _step(mod, rng)
        label = b.label[0] if i < 5 else b.label[0].reshape(20, 1)
        mod.update_metric(acc, [label])
        _host(acc_ref, mod, b, label)
        mod.update_metric(topk, b.label)
        _host(topk_ref, mod, b)
    assert acc._dev_acc.shape_sig[0] == ((20, 1),)
    assert acc.get() == acc_ref.get()
    assert topk.get() == topk_ref.get()
    assert acc.num_inst == acc_ref.num_inst == 180


def test_eval_score_uses_sync_path():
    """``score`` (eval forwards) never engages the in-step counters: no
    fused step runs there."""
    rng = np.random.default_rng(0)
    x = rng.random((120, 8)).astype(np.float32)
    y = rng.integers(0, 10, 120).astype(np.float32)
    it = tmx.io.NDArrayIter(x, y, batch_size=20)
    mod = tmx.mod.Module(_mlp(tmx), context="cpu")
    mod.fit(it, num_epoch=1, optimizer="sgd",
            initializer=tmx.init.Xavier())
    it.reset()
    acc = tmx.metric.Accuracy()
    s = mod.score(it, acc)[0][1]
    assert getattr(acc, "_dev_acc", None) is None
    it.reset()
    hits = 0
    for b in it:
        mod.forward(b, is_train=False)
        hits += int((mod.get_outputs()[0].asnumpy().argmax(1) ==
                     b.label[0].asnumpy()).sum())
    assert abs(s - hits / 120) < 1e-9


def test_partial_reattach_no_double_count():
    """A leaf whose window is folded while it re-attaches (it joins a
    composite) is not counted again by the host update of that batch."""
    rng = np.random.default_rng(0)
    mod = _mod(20)
    acc, ref = tmx.metric.Accuracy(), tmx.metric.Accuracy()
    for _ in range(2):
        b = _step(mod, rng)
        mod.update_metric(acc, b.label)
        _host(ref, mod, b)
    topk = tmx.metric.TopKAccuracy(top_k=3)
    topk_ref = tmx.metric.TopKAccuracy(top_k=3)
    em = tmx.metric.CompositeEvalMetric([acc, topk])
    b = _step(mod, rng)
    mod.update_metric(em, b.label)
    _host(ref, mod, b)
    _host(topk_ref, mod, b)
    acc.get()
    assert acc.num_inst == ref.num_inst == 60
    assert abs(acc.get()[1] - ref.get()[1]) < 1e-9
    assert abs(topk.get()[1] - topk_ref.get()[1]) < 1e-9


def test_partial_reattach_with_gap_discards():
    """A still-valid leaf whose window has a gap (steps without
    ``update_metric``) drops that window when it re-attaches."""
    rng = np.random.default_rng(0)
    mod = _mod(20)
    acc = tmx.metric.Accuracy()
    b = _step(mod, rng)
    mod.update_metric(acc, b.label)          # batch 1 counted (attach)
    _step(mod, rng)                          # batches 2-3: no
    _step(mod, rng)                          # update_metric, a gap
    em = tmx.metric.CompositeEvalMetric(
        [acc, tmx.metric.TopKAccuracy(top_k=3)])
    b = _step(mod, rng)
    mod.update_metric(em, b.label)           # batch 4 through the composite
    acc.get()
    assert acc.num_inst == 40                # batches 1 and 4 only


def test_double_update_call_flushes_not_discards():
    """A second ``update_metric`` for the same batch folds the open
    window before the slot is released; the batch counts twice, as on
    the host path."""
    rng = np.random.default_rng(0)
    mod = _mod(20)
    acc, ref = tmx.metric.Accuracy(), tmx.metric.Accuracy()
    b = None
    for _ in range(3):
        b = _step(mod, rng)
        mod.update_metric(acc, b.label)
        _host(ref, mod, b)
    mod.update_metric(acc, b.label)
    _host(ref, mod, b)
    acc.get()
    assert acc.num_inst == ref.num_inst == 80
    assert abs(acc.get()[1] - ref.get()[1]) < 1e-9


def test_mixed_composite_states_settle_per_leaf():
    """One leaf also updated alone this batch (a double call) beside a
    contiguous sibling: each settles under its own contract."""
    rng = np.random.default_rng(0)
    mod = _mod(20)
    acc = tmx.metric.Accuracy()
    topk = tmx.metric.TopKAccuracy(top_k=3)
    em = tmx.metric.CompositeEvalMetric([acc, topk])
    for i in range(3):
        b = _step(mod, rng)
        if i == 2:
            mod.update_metric(acc, b.label)
        mod.update_metric(em, b.label)
    acc.get()
    topk.get()
    assert topk.num_inst == 60      # 3 batches, nothing dropped
    assert acc.num_inst == 80       # 3 batches + the repeat of batch 3


def test_composite_name_filters_respected():
    rng = np.random.default_rng(0)
    mod = _mod(20)
    em = tmx.metric.CompositeEvalMetric(
        [tmx.metric.Accuracy()], output_names=["softmax_output"],
        label_names=["softmax_label"])
    ref = tmx.metric.Accuracy()
    for _ in range(4):
        b = _step(mod, rng)
        mod.update_metric(em, b.label)
        _host(ref, mod, b)
    assert em.metrics[0]._dev_acc is not None
    assert abs(em.get()[1][0] - ref.get()[1]) < 1e-9


# -- each rule against the JAX package's ------------------------------------

def _rule_inputs(kind, rng):
    if kind in ("mae", "mse", "rmse", "loss"):
        lab = rng.standard_normal((6, 3)).astype(np.float32)
        return lab, (lab + rng.standard_normal((6, 3))).astype(np.float32)
    lab = rng.integers(0, 7, 9).astype(np.float32)
    x = rng.random((9, 7)).astype(np.float32) + 1e-3
    return lab, x / x.sum(1, keepdims=True)


RULES = {
    "accuracy": (lambda p: p.metric.Accuracy(), jnp.int32),
    "top_k": (lambda p: p.metric.TopKAccuracy(top_k=3), jnp.int32),
    "cross_entropy": (lambda p: p.metric.CrossEntropy(), jnp.float32),
    "nll": (lambda p: p.metric.NegativeLogLikelihood(), jnp.float32),
    "mae": (lambda p: p.metric.MAE(), jnp.float32),
    "mse": (lambda p: p.metric.MSE(), jnp.float32),
    "rmse": (lambda p: p.metric.RMSE(), jnp.float32),
    "loss": (lambda p: p.metric.Loss(), jnp.float32),
}


@pytest.mark.parametrize("kind", sorted(RULES))
def test_rule_counter_matches_jax_rule(kind):
    make, _ = RULES[kind]
    rng = np.random.default_rng(5)
    tm, jm = make(tmx), make(jmx)
    tbuild, jbuild = tmd._RULES[type(tm)], jmd._RULES[type(jm)]
    jstate = tstate = None
    for _ in range(3):
        lab, pred = _rule_inputs(kind, rng)
        jl = [jax.ShapeDtypeStruct(lab.shape, lab.dtype)]
        jp = [jax.ShapeDtypeStruct(pred.shape, pred.dtype)]
        jinit, jfn, jinst = jbuild(jm, jl, jp)
        tdtype, tfn, tinst = tbuild(
            tm, [tmd._spec(torch.from_numpy(lab))],
            [tmd._spec(torch.from_numpy(pred))])
        assert tinst == jinst
        if jstate is None:
            jstate = jinit
            tstate = torch.zeros((), dtype=tdtype)
            assert str(jinit.dtype) == str(tdtype).replace("torch.", "")
        jstate = jfn(jstate, [jnp.asarray(lab)], [jnp.asarray(pred)])
        tstate = tfn(tstate, [torch.from_numpy(lab)],
                     [torch.from_numpy(pred)])
    want, got = np.asarray(jstate), tstate.numpy()
    assert got.dtype == want.dtype
    if want.dtype.kind == "i":
        assert int(got) == int(want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_top_k_ties_go_to_the_lower_index():
    """Scores from a few levels (many ties, also at the k-th value): the
    rule's hits equal membership in ``lax.top_k``'s indices, in fp32 and
    in bf16 (which the captured step's outputs are)."""
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(
            rng.integers(0, 4, (64, 10)).astype(np.float32)).to(dtype)
        lab = rng.integers(0, 10, 64)
        for k in (1, 3, 5):
            _, idx = jax.lax.top_k(jnp.asarray(x.float().numpy()), k)
            want = (np.asarray(idx) == lab[:, None]).any(1)
            got = tmd.top_k_hits(x, torch.from_numpy(lab.astype(np.int32)),
                                 k).numpy()
            np.testing.assert_array_equal(got, want)
    # a label out of range is never a hit (lax.top_k's indices are in
    # range); it does not index out of bounds
    got = tmd.top_k_hits(torch.zeros(2, 4), torch.tensor([4, -1]), 3)
    assert not got.any()


def test_flush_and_detach_before_a_step_is_exact():
    """``flush_and_detach`` between steps folds every live window and
    drops the rules and the programs captured with them; the next
    ``update_metric`` attaches anew (one new program key) and the counts
    stay those of the host path."""
    rng = np.random.default_rng(2)
    mod = _mod(20)
    acc, topk = tmx.metric.Accuracy(), tmx.metric.TopKAccuracy(top_k=3)
    acc_ref, topk_ref = tmx.metric.Accuracy(), \
        tmx.metric.TopKAccuracy(top_k=3)
    for i in range(6):
        if i == 3:
            tmd.flush_and_detach(mod._fused)
            assert mod._fused.num_metric_slots == 0
            assert acc._dev_acc is None and topk._dev_acc is None
        b = _step(mod, rng)
        for m, ref in ((acc, acc_ref), (topk, topk_ref)):
            mod.update_metric(m, b.label)
            _host(ref, mod, b)
    assert mod._fused.num_metric_slots == 2
    assert acc.get() == acc_ref.get() and topk.get() == topk_ref.get()
    assert acc.num_inst == 120
