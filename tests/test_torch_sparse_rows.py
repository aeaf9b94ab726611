"""The port's row-sparse primitives against the JAX package's, on the CPU
(``sparse/rowsparse.py``, ``sparse/embedding.py``, the two registered
ops and the telemetry registry they report into).

The same ids and rows, made from a seed with numpy, go through
``mxnet_tpu.sparse`` and ``mxnet_tpu_torch.sparse``:

- ``dedup_rows``: the ids equal (sorted unique, the sentinel tail), the
  rows within 1e-6 (float32 sums of a few occurrences in another order:
  the port adds each slot's occurrences in their order, XLA's
  segment-sum in its own); with a capacity override, and the error on a
  capacity below the unique count;
- ``densify`` and ``scatter_rows`` within 1e-6, with ids at 0 and
  vocab - 1 and negative ids in the rows;
- ``segment_rows`` (``_contrib_sparse_segment_sum``) within 1e-6, with
  segment ids out of range;
- ``sparse_embedding``'s forward equal (NaN rows where the JAX gather
  fills) and its weight gradient within 1e-6 of ``jax.vjp`` of the JAX
  op, with ids repeated, negative and out of range;
- the ops through ``nd`` / ``sym`` and the weight shape hint;
- the telemetry registry's snapshot, reset and collector view against
  the JAX package's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.sparse import rowsparse as jrs
from mxnet_tpu.sparse import embedding as jemb
from mxnet_tpu.telemetry import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.sparse import rowsparse as trs
from mxnet_tpu_torch.sparse import embedding as temb
from mxnet_tpu_torch.telemetry import registry as treg
from torch_threads import one_torch_thread  # noqa: F401

ROW_TOL = 1e-6


def _ids_rows(seed, shape, vocab, dim, low=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(low, vocab, size=shape).astype(np.int32)
    ids.flat[0] = 0
    ids.flat[-1] = vocab - 1
    rows = rng.randn(*(shape + (dim,))).astype(np.float32)
    return ids, rows


@pytest.mark.parametrize("shape,vocab,dim,capacity", [
    ((6, 4), 10, 3, None),        # many duplicates
    ((9,), 1000, 5, None),        # few duplicates: a long sentinel tail?
    ((8, 3), 7, 2, 7),            # capacity override = the vocab
])
def test_dedup_rows_matches_the_jax_package(shape, vocab, dim, capacity):
    ids, rows = _ids_rows(1, shape, vocab, dim)
    j = jrs.dedup_rows(jnp.asarray(ids), jnp.asarray(rows), vocab,
                       capacity=capacity)
    t = trs.dedup_rows(torch.from_numpy(ids), torch.from_numpy(rows), vocab,
                       capacity=capacity)
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_allclose(t.rows.numpy(), np.asarray(j.rows),
                               rtol=0, atol=ROW_TOL)
    assert t.num_rows == j.num_rows == vocab
    n_unique = len(np.unique(ids))
    assert (t.ids.numpy()[n_unique:] == vocab).all()
    assert (t.rows.numpy()[n_unique:] == 0).all()


def test_dedup_rows_refuses_an_undersized_capacity():
    ids = np.array([3, 1, 3, 0, 5], np.int32)
    rows = np.ones((5, 2), np.float32)
    for fn, arr in ((jrs.dedup_rows, jnp.asarray), (trs.dedup_rows,
                                                    torch.from_numpy)):
        with pytest.raises(ValueError, match="capacity=3"):
            fn(arr(ids), arr(rows), 8, capacity=3)
        # the unique count itself is enough
        assert fn(arr(ids), arr(rows), 8, capacity=4).ids.shape[0] == 4


def test_densify_and_scatter_rows_match_the_jax_package():
    vocab, dim = 9, 4
    ids = np.array([-9, -1, 0, 2, 8, 9, 12], np.int32)  # wraps, drops
    rows = np.random.RandomState(2).randn(7, dim).astype(np.float32)
    table = np.random.RandomState(3).randn(vocab, dim).astype(np.float32)
    jr = jrs.RowSparseRows(jnp.asarray(ids), jnp.asarray(rows), vocab)
    tr = trs.RowSparseRows(torch.from_numpy(ids).long(),
                           torch.from_numpy(rows), vocab)
    np.testing.assert_allclose(trs.densify(tr).numpy(),
                               np.asarray(jrs.densify(jr)), atol=ROW_TOL)
    np.testing.assert_allclose(
        trs.scatter_rows(torch.from_numpy(table), tr, scale=-0.5).numpy(),
        np.asarray(jrs.scatter_rows(jnp.asarray(table), jr, scale=-0.5)),
        atol=ROW_TOL)


def test_segment_rows_matches_the_jax_package_and_the_op():
    rng = np.random.RandomState(4)
    vals = rng.randn(12, 3).astype(np.float32)
    seg = rng.randint(-2, 7, size=12).astype(np.int32)   # some dropped
    want = np.asarray(jrs.segment_rows(jnp.asarray(vals), jnp.asarray(seg),
                                       5))
    got = trs.segment_rows(torch.from_numpy(vals), torch.from_numpy(seg), 5)
    np.testing.assert_allclose(got.numpy(), want, atol=ROW_TOL)
    op = tmx.nd._contrib_sparse_segment_sum(
        tmx.nd.array(vals, ctx=tmx.cpu()), tmx.nd.array(seg, ctx=tmx.cpu()),
        num_segments=5)
    np.testing.assert_allclose(op.asnumpy(), want, atol=ROW_TOL)


@pytest.mark.parametrize("ids", [
    np.array([[0, 3, 3], [5, 0, 3]], np.int32),            # repeated
    np.array([[-1, 2, -6], [6, 7, -7]], np.int32),         # wrap / out
])
def test_sparse_embedding_forward_and_gradient(ids):
    vocab, dim = 6, 4
    rng = np.random.RandomState(5)
    w = rng.randn(vocab, dim).astype(np.float32)
    ct = rng.randn(*(ids.shape + (dim,))).astype(np.float32)
    jout, vjp = jax.vjp(lambda w_: jemb.sparse_embedding(
        jnp.asarray(ids), w_), jnp.asarray(w))
    (jgw,) = vjp(jnp.asarray(ct))
    tw = torch.from_numpy(w).requires_grad_(True)
    tout = temb.sparse_embedding(torch.from_numpy(ids), tw)
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    (tgw,) = torch.autograd.grad(tout, tw, torch.from_numpy(ct))
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), atol=ROW_TOL)


def test_sparse_embedding_op_and_symbol_surface():
    ids = np.array([[1, 4], [4, 0]], np.float32)
    w = np.random.RandomState(6).randn(5, 3).astype(np.float32)
    for name in ("SparseEmbedding", "_contrib_SparseEmbedding"):
        out = getattr(tmx.nd, name)(tmx.nd.array(ids, ctx=tmx.cpu()),
                                    tmx.nd.array(w, ctx=tmx.cpu()),
                                    input_dim=5, output_dim=3)
        np.testing.assert_array_equal(out.asnumpy(), w[ids.astype(int)])
    for pkg in (jmx, tmx):
        s = pkg.sym.SparseEmbedding(data=pkg.sym.Variable("ids"),
                                    input_dim=50, output_dim=7, name="e")
        arg_shapes, out_shapes, _ = s.infer_shape(ids=(4, 3))
        assert dict(zip(s.list_arguments(), arg_shapes))["e_weight"] == \
            (50, 7)
        assert tuple(out_shapes[0]) == (4, 3, 7)
    jnode = jmx.sym.SparseEmbedding(data=jmx.sym.Variable("ids"),
                                    input_dim=5, output_dim=3, name="e")
    tsym = tmx.sym.load_json(jnode.tojson())
    assert tsym.list_arguments() == ["ids", "e_weight"]


def test_telemetry_registry_matches_the_jax_package():
    def drive(reg):
        reg.reset()
        c = reg.counter("ptest::c")
        c.inc()
        c.inc(4)
        reg.gauge("ptest::g").set(2.5)
        tm = reg.timer("ptest::t")
        for v in (0.5, 0.25, 1.0):
            tm.record(v)
        h = reg.histogram("ptest::h", window=4)
        for v in (5, 1, 4, 2, 3):
            h.observe(v)
        view = reg.collector_view("ptestsub", lambda r: {"reset": r})
        first = reg.snapshot(prefix="ptest::")
        cleared = reg.snapshot(reset=True, prefix="ptest::")
        after = reg.snapshot(prefix="ptest::")
        with pytest.raises(TypeError):
            reg.gauge("ptest::c")
        reg.remove("ptest::")
        return (first, cleared, after, view(), view(reset=True),
                view.__name__, reg.collect("nosuch"),
                reg.snapshot(prefix="ptest::"))

    assert drive(treg) == drive(jreg)
