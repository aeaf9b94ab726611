"""The port's functional optimizer rules
(``mxnet_tpu_torch.parallel.functional_opt``) against the JAX package's,
on the CPU.

- Every rule, over 5 steps on two parameters from the same seeded numpy
  inputs, with ``t`` a Python int and a 0-dim tensor, against the JAX
  rule. Both run the same fp32 operations in the same order; the limit
  (rtol 2e-6, atol 1e-7) covers a last-place difference per operation
  (the bias corrections' ``pow`` and ``sqrt`` in two libraries).
- ``t`` as an int and as a tensor give bit-identical results; the list
  form ``update_`` equals the pure form bit for bit, and ``update_`` with
  ``out=`` equals the in-place form bit for bit; so does ``update_``
  with donated gradients, and without donation the gradients are left
  as they were.
- Each rule against the port's eager class over 5 steps (the JAX
  package's ``tests/test_functional_opt.py`` check: rtol 2e-5, atol
  2e-6; the eager classes fold bias corrections in float64).
- sgld: its deterministic part (noise scale 0 through the test hook)
  equals the JAX rule's result less the JAX noise (rtol 2e-6); the noise
  has mean 0 and variance lr (limits from 4096 draws).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import optimizer as jopt
from mxnet_tpu.parallel import functional_opt as jfo

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.parallel import functional_opt as tfo

CASES = [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "clip_gradient": 0.3}),
    ("nag", {"momentum": 0.9}),
    ("lbsgd", {"momentum": 0.9, "warmup_strategy": "lars"}),
    ("lbsgd", {"momentum": 0.9, "warmup_strategy": "linear",
               "warmup_epochs": 2, "updates_per_epoch": 4,
               "batch_scale": 4}),
    ("lbsgd", {"momentum": 0.9, "warmup_strategy": "power2",
               "warmup_epochs": 2, "updates_per_epoch": 4,
               "batch_scale": 4}),
    ("lbsgd", {"momentum": 0.9, "warmup_strategy": "sqrt",
               "warmup_epochs": 2, "updates_per_epoch": 4,
               "batch_scale": 4}),
    ("lars", {"momentum": 0.9}),
    ("adam", {}),
    ("adam", {"clip_gradient": 0.1, "rescale_grad": 0.5}),
    ("adamax", {}),
    ("adamax", {"clip_gradient": 0.1}),
    ("nadam", {}),
    ("nadam", {"clip_gradient": 0.1}),
    ("ftml", {}),
    ("ftml", {"clip_gradient": 0.1}),
    ("adagrad", {}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True}),
    ("rmsprop", {"clip_weights": 0.5}),
    ("adadelta", {}),
    ("ftrl", {}),
    ("signsgd", {}),
    ("signum", {"momentum": 0.9, "wd_lh": 0.01}),
    ("signum", {"momentum": 0.0}),
    ("dcasgd", {"momentum": 0.5}),
    ("test", {}),
]
IDS = [f"{n}-{i}" for i, (n, _) in enumerate(CASES)]
SHAPES = ((5, 3), (7,))
LR, WD, STEPS = 0.05, 0.01, 5


def _inputs(seed=42):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(STEPS)]
    return ws, gs


def _port_pure(rule, ws, gs, t_kind):
    out = []
    for k, w in enumerate(ws):
        p = torch.from_numpy(w.copy())
        s = rule.init(p)
        for t, g in enumerate(gs, start=1):
            tt = torch.tensor(t, dtype=torch.int32) if t_kind == "tensor" \
                else t
            p, s = rule.update(p, torch.from_numpy(g[k]), s, LR, tt, WD)
        out.append((p, s))
    return out


@pytest.mark.parametrize("t_kind", ["int", "tensor"])
@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_rule_matches_jax(name, kwargs, t_kind):
    ws, gs = _inputs()
    rule = tfo.create(name, **kwargs)
    jrule = jfo.create(name, **kwargs)
    got = _port_pure(rule, ws, gs, t_kind)
    for k, w in enumerate(ws):
        p = jnp.asarray(w)
        s = jrule.init(p)
        for t, g in enumerate(gs, start=1):
            p, s = jrule.update(p, jnp.asarray(g[k]), s, jnp.float32(LR),
                                jnp.uint32(t), WD)
        tp, ts = got[k]
        np.testing.assert_allclose(tp.numpy(), np.asarray(p), rtol=2e-6,
                                   atol=1e-7, err_msg=f"{name} param {k}")
        assert len(ts) == len(s), name
        for a, b in zip(ts, s):
            assert tuple(a.shape) == tuple(np.shape(b)), name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                       atol=1e-7, err_msg=f"{name} state")


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_t_int_tensor_and_list_forms_bit_identical(name, kwargs):
    ws, gs = _inputs(7)
    rule = tfo.create(name, **kwargs)
    by_int = _port_pure(rule, ws, gs, "int")
    by_tensor = _port_pure(rule, ws, gs, "tensor")
    for (a, sa), (b, sb) in zip(by_int, by_tensor):
        assert torch.equal(a, b), name
        assert all(torch.equal(x, y) for x, y in zip(sa, sb)), name
    # the list forms: in place, and into out= (the state left as it was)
    ps = [torch.from_numpy(w.copy()) for w in ws]
    ss = [rule.init(p) for p in ps]
    qs = [p.clone() for p in ps]
    qss = [tuple(x.clone() for x in s) for s in ss]
    for t, g in enumerate(gs, start=1):
        grads = [torch.from_numpy(x) for x in g]
        outs = ([torch.empty_like(q) for q in qs],
                [tuple(torch.empty_like(x) for x in s) for s in qss])
        before = [q.clone() for q in qs]
        rule.update_(qs, grads, qss, LR, WD, out=outs,
                     t=torch.tensor(t, dtype=torch.int32))
        assert all(torch.equal(a, b) for a, b in zip(qs, before))
        for q, o in zip(qs, outs[0]):
            q.copy_(o)
        for s, o in zip(qss, outs[1]):
            for x, y in zip(s, o):
                x.copy_(y)
        rule.update_(ps, grads, ss, LR, WD, t=t)
        for q, p in zip(qs, ps):
            assert torch.equal(q, p), name
    for (want, wst), p, s in zip(by_int, ps, ss):
        assert torch.equal(want, p), name
        assert all(torch.equal(x, y) for x, y in zip(wst, s)), name


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_donated_grads_give_the_same_update(name, kwargs):
    """``update_`` with ``donate_grads=True`` (the training step's call)
    writes the same values, bit for bit, as without; without it the
    gradients are left as they were."""
    ws, gs = _inputs(5)
    rule = tfo.create(name, **kwargs)
    runs = []
    for donate in (False, True):
        ps = [torch.from_numpy(w.copy()) for w in ws]
        ss = [rule.init(p) for p in ps]
        for t, g in enumerate(gs, start=1):
            grads = [torch.from_numpy(x.copy()) for x in g]
            rule.update_(ps, grads, ss, LR, WD, t=t, donate_grads=donate)
            if not donate:
                assert all(np.array_equal(a.numpy(), b)
                           for a, b in zip(grads, g)), name
        runs.append((ps, ss))
    (pa, sa), (pb, sb) = runs
    for a, b in zip(pa, pb):
        assert torch.equal(a, b), name
    for x, y in zip(sa, sb):
        assert all(torch.equal(u, v) for u, v in zip(x, y)), name


_EAGER = [(i, c) for i, c in zip(IDS, CASES)
          if c[0] not in ("lars", "signsgd")]   # no eager class of its own


@pytest.mark.parametrize("name,kwargs", [c for _, c in _EAGER],
                         ids=[i for i, _ in _EAGER])
def test_rule_matches_port_eager_class(name, kwargs):
    """Functional against eager within the port (the JAX package's
    check); lbsgd's eager class folds no eta, as there."""
    rng = np.random.RandomState(42)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(5)]
    with tmx.cpu():
        eager = topt.create(name, learning_rate=LR, wd=WD, **kwargs)
        w_e = tmx.nd.array(w0.copy())
        updater = topt.get_updater(eager)
        for g in grads:
            updater(0, tmx.nd.array(g), w_e)
    rule = tfo.from_optimizer(topt.create(name, learning_rate=LR, wd=WD,
                                          **kwargs))
    p = torch.from_numpy(w0.copy())
    s = rule.init(p)
    for t, g in enumerate(grads, start=1):
        p, s = rule.update(p, torch.from_numpy(g), s, LR, t, WD)
    np.testing.assert_allclose(p.numpy(), w_e.asnumpy(), rtol=2e-5,
                               atol=2e-6, err_msg=name)


def test_from_optimizer_reads_every_class():
    assert tfo.supported() == jfo.supported()
    for name in tfo.supported():
        if name in ("lars", "signsgd"):
            continue
        o = topt.create(name, learning_rate=0.1, clip_gradient=0.5)
        jo = jopt.create(name, learning_rate=0.1, clip_gradient=0.5)
        assert tfo.from_optimizer(o).name == jfo.from_optimizer(jo).name
    ada = tfo.from_optimizer(topt.create("adagrad", eps=1e-3))
    p = torch.ones(3)
    got, _ = ada.update(p, torch.ones(3), ada.init(p), 1.0, 1, 0.0)
    # 1 - 1/sqrt(1 + eps) in fp32: the cancellation leaves 2^-24
    # absolute, not relative, accuracy
    np.testing.assert_allclose(got.numpy(), 1 - 1 / np.sqrt(1 + 1e-3),
                               rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="supported"):
        tfo.create("nope")
    with pytest.raises(TypeError, match="unexpected"):
        tfo.create("adam", momentum=0.9)


def test_lars_uses_per_tensor_norms():
    """Over a list, lars's trust ratio is each tensor's own: the list
    form equals each tensor updated alone."""
    rule = tfo.create("lars", momentum=0.9)
    assert not rule.elementwise
    rng = np.random.RandomState(3)
    ps = [torch.from_numpy(rng.randn(4, 4).astype(np.float32) * sc)
          for sc in (1.0, 100.0)]
    gs = [torch.from_numpy(rng.randn(4, 4).astype(np.float32))
          for _ in ps]
    alone = [rule.update(p, g, rule.init(p), 0.1, 1, 1e-4)[0]
             for p, g in zip(ps, gs)]
    qs = [p.clone() for p in ps]
    rule.update_(qs, gs, [rule.init(p) for p in ps], 0.1, 1e-4)
    for a, q in zip(alone, qs):
        assert torch.equal(a, q)


def test_nadam_schedule_leaf_is_0dim():
    rule = tfo.create("nadam")
    s = rule.init(torch.zeros(3, 2))
    assert [tuple(x.shape) for x in s] == [(3, 2), (3, 2), ()]


def test_sgld_deterministic_part_and_noise():
    rng = np.random.RandomState(11)
    w = rng.randn(64, 64).astype(np.float32)
    g = rng.randn(64, 64).astype(np.float32)
    lr = 0.04
    jrule = jfo.create("sgld")
    key = jax.random.PRNGKey(5)
    jp, _ = jrule.update(jnp.asarray(w), jnp.asarray(g), (), lr,
                         jnp.uint32(1), WD, key=key)
    jnoise = jax.random.normal(key, w.shape, jnp.float32) * jnp.sqrt(lr)
    rule = tfo.create("sgld")
    old = tfo.sgld_noise_scale
    tfo.sgld_noise_scale = 0.0
    try:
        det, _ = rule.update(torch.from_numpy(w), torch.from_numpy(g), (),
                             lr, 1, WD)
    finally:
        tfo.sgld_noise_scale = old
    np.testing.assert_allclose(det.numpy(), np.asarray(jp - jnoise),
                               rtol=2e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    noisy, _ = rule.update(torch.from_numpy(w), torch.from_numpy(g), (),
                           lr, 1, WD, key=gen)
    noise = (noisy - det).numpy().ravel()
    # 4096 draws: the mean within 4 standard errors, the variance within
    # 10% of lr
    assert abs(noise.mean()) < 4 * np.sqrt(lr / noise.size)
    assert abs(noise.var() / lr - 1) < 0.1


def test_rule_list_form_on_views_of_one_buffer():
    """The fused step hands the rule views of one flat buffer: the
    update lands in the buffer."""
    rule = tfo.create("adam")
    flat = torch.zeros(20)
    views = [flat[:12].view(3, 4), flat[16:20]]
    leaves = [torch.zeros(20), torch.zeros(20)]
    states = [(leaves[0][:12].view(3, 4), leaves[1][:12].view(3, 4)),
              (leaves[0][16:20], leaves[1][16:20])]
    grads = [torch.ones(3, 4), torch.ones(4)]
    rule.update_(views, grads, states, torch.tensor(0.1), 0.0,
                 t=torch.tensor(1, dtype=torch.int32))
    assert torch.all(flat[:12] < 0) and torch.all(flat[12:16] == 0)
    assert torch.all(leaves[0][16:20] > 0)
