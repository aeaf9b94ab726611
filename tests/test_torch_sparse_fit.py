"""Row-sparse embedding training in the port's fused step against the JAX
package's, on the CPU.

- ``find_sites``: the same sites and fallbacks as the JAX scan, with a
  tied weight and two sites sharing one table.
- ``row_update`` (sgd, sgd with momentum, adam) against the JAX rules
  from the same rows: within 1e-6 (float32 roundings; measured equal).
- The fused ``Module`` (``SparseEmbedding`` -> FullyConnected ->
  SoftmaxOutput) for 3 steps from the JAX package's weights with partial
  coverage, against the JAX fused step: every weight within 1e-5 of the
  JAX value (measured 3e-8: the same float32 arithmetic in another
  order), the lazy moments alike.
- Full coverage (every row every step): the sparse step equals the dense
  ``Embedding`` step bit for bit, for sgd and adam (the JAX package's
  own pin), and the routed table never has a ``(vocab, dim)`` gradient.
- The lazy contract: rows no batch touched keep their weights and
  moments bit for bit; the trash row stays zero and is never exposed.
- The program key carries the sites; ``sparse::`` counters as the JAX
  package counts them; the dense fallback (no lazy rule, tied weight).
- The guard: a batch whose out-of-range id gives a NaN row is skipped,
  table and moments bit-identical, ``t`` advanced as in the reference.
"""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.io import DataBatch as JBatch
from mxnet_tpu.parallel import functional_opt as jfo
from mxnet_tpu.sparse import embedding as jemb
from mxnet_tpu.sparse import rowsparse as jrs

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.io import DataBatch as TBatch
from mxnet_tpu_torch.parallel import functional_opt as tfo
from mxnet_tpu_torch.sparse import embedding as temb
from mxnet_tpu_torch.sparse import rowsparse as trs
from torch_threads import one_torch_thread  # noqa: F401

VOCAB, DIM, HIDDEN = 12, 6, 4
RULE_TOL = 1e-6
FIT_TOL = 1e-5
SGD = ("sgd", {"learning_rate": 0.5, "momentum": 0.9, "wd": 0.01})
ADAM = ("adam", {"learning_rate": 0.01, "wd": 0.01})
STEP_COUNTERS = ("steps", "ids_total", "touched_rows", "dedup_ratio",
                 "gather_bytes", "scatter_bytes", "sites")


def _two_layer(pkg, op):
    data = pkg.sym.Variable("data")
    emb = getattr(pkg.sym, op)(data=data, input_dim=VOCAB, output_dim=DIM,
                               name="emb")
    fc = pkg.sym.FullyConnected(pkg.sym.Flatten(emb), num_hidden=HIDDEN,
                                name="fc")
    return pkg.sym.SoftmaxOutput(fc, name="softmax")


def _weights(width, seed=2):
    rng = np.random.RandomState(seed)
    return {"emb_weight": (rng.randn(VOCAB, DIM) * 0.1).astype(np.float32),
            "fc_weight": (rng.randn(HIDDEN, width * DIM) * 0.1)
            .astype(np.float32),
            "fc_bias": np.zeros(HIDDEN, np.float32)}


def _torch_module(op, ids_steps, label, opt, params, guard=None):
    mod = tmx.mod.Module(_two_layer(tmx, op), context="cpu")
    mod.bind(data_shapes=[("data", ids_steps[0].shape)],
             label_shapes=[("softmax_label", label.shape)])
    mod.init_params()
    mod.set_params(_weights(ids_steps[0].shape[1]), {}, allow_missing=True)
    mod.init_optimizer(optimizer=opt, optimizer_params=params)
    return mod


def _torch_train(op, ids_steps, label, opt, params):
    mod = _torch_module(op, ids_steps, label, opt, params)
    for ids in ids_steps:
        mod.forward(TBatch(data=[torch.from_numpy(ids)],
                           label=[torch.from_numpy(label)]), is_train=True)
        mod.backward()
        mod.update()
    args, _ = mod.get_params()
    return mod, {n: v.numpy() for n, v in args.items()}


def _jax_train(op, ids_steps, label, opt, params):
    mod = jmx.mod.Module(_two_layer(jmx, op), data_names=("data",),
                         label_names=("softmax_label",), context=jmx.cpu())
    mod.bind(data_shapes=[("data", ids_steps[0].shape)],
             label_shapes=[("softmax_label", label.shape)])
    mod.init_params()
    mod.set_params({k: jmx.nd.array(v) for k, v in
                    _weights(ids_steps[0].shape[1]).items()}, {},
                   allow_missing=True)
    mod.init_optimizer(optimizer=opt, optimizer_params=params)
    for ids in ids_steps:
        mod.forward(JBatch(data=[jmx.nd.array(ids)],
                           label=[jmx.nd.array(label)]), is_train=True)
        mod.backward()
        mod.update()
    args, _ = mod.get_params()
    return mod, {n: np.asarray(v._data) for n, v in args.items()}


def _full_coverage(steps=4):
    return [np.arange(VOCAB).reshape(6, 2).astype(np.int32)
            for _ in range(steps)]


def _partial(steps=3, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB - 3, size=(6, 2)).astype(np.int32)
            for _ in range(steps)]


def _label(seed=1):
    return np.random.RandomState(seed).randint(0, HIDDEN, size=(6,)) \
        .astype(np.float32)


def _graph(pkg, tied):
    ids = pkg.sym.Variable("ids")
    ids2 = pkg.sym.Variable("ids2")
    w = pkg.sym.Variable("shared_weight")
    a = pkg.sym.SparseEmbedding(data=ids, weight=w, input_dim=VOCAB,
                                output_dim=DIM, name="a")
    b = pkg.sym.SparseEmbedding(data=ids2, weight=w, input_dim=VOCAB,
                                output_dim=DIM, name="b")
    c = pkg.sym.SparseEmbedding(data=ids, input_dim=VOCAB, output_dim=DIM,
                                name="c")
    x = pkg.sym.Concat(pkg.sym.Flatten(a), pkg.sym.Flatten(b),
                       pkg.sym.Flatten(c), dim=1)
    if tied:   # c's table also feeds a dense op
        x = pkg.sym.Concat(x, pkg.sym.FullyConnected(
            pkg.sym.Variable("c_weight"), num_hidden=2, name="tie"), dim=0)
    return pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(x, num_hidden=3, name="fc"), name="sm")


@pytest.mark.parametrize("tied", [False, True])
def test_find_sites_matches_the_jax_package(tied):
    out = []
    for pkg, mod in ((jmx, jemb), (tmx, temb)):
        sym = _graph(pkg, tied)
        args = sym.list_arguments()
        params = [n for n in args if n not in ("ids", "ids2", "sm_label")]
        fb = []
        sites = mod.find_sites(sym, params, ["ids", "ids2", "sm_label"],
                               fallbacks=fb)
        out.append(([s.describe() for s in sites], fb))
    assert out[0] == out[1]
    assert len(out[1][0]) == (2 if tied else 3)


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"momentum": 0.9}),
                                     ("adam", {})])
def test_row_update_matches_the_jax_rule(name, kw):
    rng = np.random.RandomState(7)
    p = rng.randn(VOCAB, DIM).astype(np.float32)
    ids = np.array([3, 0, 11, 3, 5], np.int32)
    g = rng.randn(5, DIM).astype(np.float32)
    jr, tr = jfo.create(name, **kw), tfo.create(name, **kw)
    js = tuple(s + 0.1 for s in jr.init(jnp.asarray(p)))
    ts = tuple(torch.from_numpy(np.array(s)) for s in js)
    jrows = jrs.dedup_rows(jnp.asarray(ids), jnp.asarray(g), VOCAB)
    trows = trs.dedup_rows(torch.from_numpy(ids), torch.from_numpy(g),
                           VOCAB)
    jp, jp_s = jnp.asarray(p), js
    tp, tp_s = torch.from_numpy(p), ts
    for t in (1, 2):
        jp, jp_s = jr.row_update(jp, jrows.ids, jrows.rows, jp_s,
                                 jnp.float32(0.05), jnp.int32(t), 0.01)
        tp, tp_s = tr.row_update(tp, trows.ids, trows.rows, tp_s,
                                 torch.tensor(0.05), torch.tensor(t), 0.01)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=RULE_TOL)
    for a, b in zip(tp_s, jp_s):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=RULE_TOL)
    untouched = [r for r in range(VOCAB) if r not in ids]
    np.testing.assert_array_equal(tp.numpy()[untouched], p[untouched])
    assert tfo.row_supported() == jfo.row_supported() == ["adam", "sgd"]
    assert tfo.create(name, lazy_update=False, **kw).row_update is None


@pytest.mark.parametrize("opt", [SGD, ADAM], ids=["sgd", "adam"])
def test_fused_sparse_step_matches_the_jax_package(opt):
    label = _label()
    steps = _partial()
    tmod, tp = _torch_train("SparseEmbedding", steps, label, *opt)
    jmod, jp = _jax_train("SparseEmbedding", steps, label, *opt)
    assert len(tmod._fused._sparse_sites) == 1
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=0, atol=FIT_TOL,
                                   err_msg=n)
    tst = tmod._fused.states_snapshot()["state"]["emb_weight"]
    jst = pickle.loads(jmod._fused.get_states())["state"]["emb_weight"]
    assert len(tst) == len(jst) == (1 if opt is SGD else 2)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=FIT_TOL)


@pytest.mark.parametrize("opt", [SGD, ADAM], ids=["sgd", "adam"])
def test_full_coverage_bit_identical_to_dense(opt):
    label = _label()
    sp_mod, sp = _torch_train("SparseEmbedding", _full_coverage(), label,
                              *opt)
    dn_mod, dn = _torch_train("Embedding", _full_coverage(), label, *opt)
    assert len(sp_mod._fused._sparse_sites) == 1
    assert len(dn_mod._fused._sparse_sites) == 0
    for n in sp:
        np.testing.assert_array_equal(sp[n], dn[n], err_msg=n)
    # the routed table's gradient is rows only: one row per id
    f = sp_mod._fused
    feed = {"data": torch.from_numpy(_full_coverage(1)[0]),
            "softmax_label": torch.from_numpy(label)}
    _, grads, _, _ = f.gradients(feed)
    assert isinstance(grads["emb_weight"], trs.RowSparseRows)
    assert tuple(grads["emb_weight"].rows.shape) == (12, DIM)


def test_untouched_rows_and_moments_stay_frozen():
    label = _label()
    steps = _partial()
    mod, params = _torch_train("SparseEmbedding", steps, label, *ADAM)
    touched = np.unique(np.concatenate([s.reshape(-1) for s in steps]))
    untouched = [r for r in range(VOCAB) if r not in touched]
    assert untouched
    w0 = _weights(2)["emb_weight"]
    np.testing.assert_array_equal(params["emb_weight"][untouched],
                                  w0[untouched])
    f = mod._fused
    for leaf in f._state["emb_weight"]:
        assert tuple(leaf.shape) == (VOCAB, DIM)
        assert (leaf.numpy()[untouched] == 0).all()
        assert (leaf.numpy()[touched] != 0).any()
    # the trash row past the table, and its state rows, never change
    assert (f._tables["emb_weight"][VOCAB] == 0).all()
    assert all((x[VOCAB] == 0).all() for x in f._table_state["emb_weight"])
    assert tuple(mod.get_params()[0]["emb_weight"].shape) == (VOCAB, DIM)


def test_program_key_carries_the_sparse_sites():
    label = _label()
    sp, _ = _torch_train("SparseEmbedding", _full_coverage(1), label, *SGD)
    dn, _ = _torch_train("Embedding", _full_coverage(1), label, *SGD)
    ks = sp._fused._program_key(("sig",))
    kd = dn._fused._program_key(("sig",))
    mat = ks.materials["extra"]["sparse"]
    assert len(mat) == 1
    assert mat[0][1] == "emb_weight" and mat[0][3] == VOCAB
    assert kd.materials["extra"]["sparse"] == []
    assert ks != kd


def test_sparse_counters_match_the_jax_package():
    label = _label()
    reports = []
    for pkg, train in ((jmx, _jax_train), (tmx, _torch_train)):
        with pkg.config.override("MXTPU_SPARSE_STATS", "1"):
            pkg.sparse.sparse_report(reset=True)
            train("SparseEmbedding", _full_coverage(3) + _partial(2), label,
                  *SGD)
            rep = pkg.sparse.sparse_report(reset=True)
            # the counters a step writes (other tests of the same process
            # may have registered others, such as dense_fallback)
            reports.append({k: rep.get(k) for k in STEP_COUNTERS})
    assert reports[0] == reports[1]
    assert reports[1]["steps"] == 5 and reports[1]["sites"] == 1
    assert reports[1]["ids_total"] == 5 * 12


@pytest.mark.parametrize("case", ["no_lazy_rule", "tied_weight"])
def test_dense_fallback_is_counted(case):
    label = _label()
    tmx.sparse.sparse_report(reset=True)
    if case == "no_lazy_rule":
        mod, _ = _torch_train("SparseEmbedding", _full_coverage(1), label,
                              "sgd", {"learning_rate": 0.1,
                                      "lazy_update": False})
        assert mod._fused._sparse_sites == []
    else:
        # tied input and output embeddings: the table is also the head
        w = tmx.sym.Variable("tied_weight")
        e = tmx.sym.SparseEmbedding(data=tmx.sym.Variable("ids"), weight=w,
                                    input_dim=VOCAB, output_dim=DIM)
        sym = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
            tmx.sym.Flatten(e), weight=w, num_hidden=VOCAB, no_bias=True),
            name="sm")
        mod = tmx.mod.Module(sym, data_names=("ids",),
                             label_names=("sm_label",), context="cpu")
        mod.bind(data_shapes=[("ids", (4, 1))],
                 label_shapes=[("sm_label", (4,))])
        mod.init_params()
        mod.init_optimizer(optimizer="sgd")
        assert mod._fused._sparse_sites == []
    assert tmx.sparse.sparse_report()["dense_fallback"] == 1


def test_guard_skips_a_step_with_a_nan_row():
    label = _label()
    mod = _torch_module("SparseEmbedding", _full_coverage(1), label, *ADAM)
    f = mod._fused

    def step(ids):
        mod.forward(TBatch(data=[torch.from_numpy(ids)],
                           label=[torch.from_numpy(label)]), is_train=True)
        mod.update()

    step(_full_coverage(1)[0])
    before = ([f._tables["emb_weight"].clone()]
              + [x.clone() for x in f._table_state["emb_weight"]]
              + [f._flat_p.clone()])
    t0 = int(f._t)
    bad = _full_coverage(1)[0].copy()
    bad[2, 1] = VOCAB + 5          # out of range: a NaN row, NaN grads
    step(bad)
    after = ([f._tables["emb_weight"]] + list(f._table_state["emb_weight"])
             + [f._flat_p])
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert int(f._t) == t0 + 1
    assert int(f.fault_state[0]) == 1
    step(_full_coverage(1)[0])
    assert not torch.equal(f._tables["emb_weight"], before[0])
