"""The port's ``kvstore`` and ``gradient_compression`` against the JAX
package's, on the CPU.

The same numpy values go into both stores. Sums, pulls and compressed
values must agree bit for bit (the same float32 additions in the same
order); an optimizer run in the store over 3 pushes within rtol 2e-6
(the two packages' SGD and Adam kernels round differently); the packed
2-bit buffer bit for bit. A ``Trainer`` that updates on the store over
3 steps is held to the JAX package's with the same tolerance.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 2e-6
SHAPE = (4, 5)


def _nd(pkg, a):
    return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx else pkg.nd.array(a)


def _values(seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(n)]


def test_init_push_pull_and_set():
    vals = _values(0)
    got = {}
    for pkg in (jmx, tmx):
        kv = pkg.kv.create("local")
        kv.init(3, _nd(pkg, vals[0]))
        kv.init([5, 7], [_nd(pkg, vals[1]), _nd(pkg, vals[2])])
        kv.init(3, _nd(pkg, vals[2]))          # a second init is ignored
        outs = {}
        for k in (3, 5, 7):
            o = _nd(pkg, np.zeros(SHAPE, np.float32))
            kv.pull(k, out=o)
            outs[f"init{k}"] = o.asnumpy()
        # a list of copies is summed
        kv.push(5, [_nd(pkg, v) for v in vals])
        o = [_nd(pkg, np.zeros(SHAPE, np.float32)) for _ in range(2)]
        kv.pull(5, out=o)
        outs["sum"] = [x.asnumpy() for x in o]
        kv.set(7, _nd(pkg, 2 * vals[0]))
        o = _nd(pkg, np.zeros(SHAPE, np.float32))
        kv.pull(7, out=o)
        outs["set"] = o.asnumpy()
        got[pkg.__name__] = (outs, kv.rank, kv.num_workers,
                             kv.is_distributed, kv.type)
        kv.barrier()
    j, t = got["mxnet_tpu"], got["mxnet_tpu_torch"]
    assert j[1:] == t[1:] == (0, 1, False, "local")
    for key in ("init3", "init5", "init7", "set"):
        np.testing.assert_array_equal(t[0][key], j[0][key])
    np.testing.assert_array_equal(t[0]["init3"], vals[0])
    for a, b in zip(t[0]["sum"], j[0]["sum"]):
        np.testing.assert_array_equal(a, b)


def test_pull_writes_in_place():
    kv = tmx.kv.create("device")
    v = _values(1)[0]
    kv.init("w", _nd(tmx, v))
    out = _nd(tmx, np.zeros(SHAPE, np.float32))
    before = out._data
    kv.pull("w", out=out)
    assert out._data is before
    np.testing.assert_array_equal(out.asnumpy(), v)
    # the store holds a copy: writing the source does not reach it
    src = _nd(tmx, v)
    kv.init("c", src)
    src[:] = 0
    kv.pull("c", out=out)
    np.testing.assert_array_equal(out.asnumpy(), v)


@pytest.mark.parametrize("opt,kw", [("sgd", {"momentum": 0.9, "wd": 1e-3}),
                                    ("adam", {"wd": 1e-3})])
def test_optimizer_in_the_store(opt, kw):
    w0 = _values(2, 1)[0]
    grads = _values(3)
    got = {}
    for pkg in (jmx, tmx):
        kv = pkg.kv.create("device")
        kv.set_optimizer(pkg.optimizer.create(opt, learning_rate=0.1,
                                              rescale_grad=0.5, **kw))
        kv.init(0, _nd(pkg, w0))
        for g in grads:
            kv.push(0, [_nd(pkg, g), _nd(pkg, 0.5 * g)])
        o = _nd(pkg, np.zeros(SHAPE, np.float32))
        kv.pull(0, out=o)
        got[pkg] = o.asnumpy()
    np.testing.assert_allclose(got[tmx], got[jmx], rtol=RTOL, atol=1e-7)
    assert not np.allclose(got[tmx], w0)


def test_set_updater_runs_on_push():
    seen = {}
    for pkg in (jmx, tmx):
        calls = []

        def upd(key, grad, weight, calls=calls):
            calls.append(key)
            weight[:] = weight - grad

        kv = pkg.kv.create("local")
        kv.set_updater(upd)
        v, g = _values(4, 2)
        kv.init(9, _nd(pkg, v))
        kv.push(9, _nd(pkg, g))
        o = _nd(pkg, np.zeros(SHAPE, np.float32))
        kv.pull(9, out=o)
        seen[pkg] = (calls, o.asnumpy())
    assert seen[tmx][0] == seen[jmx][0] == [9]
    np.testing.assert_array_equal(seen[tmx][1], seen[jmx][1])


def test_row_sparse_pull_into_dense():
    table = np.arange(40, dtype=np.float32).reshape(8, 5)
    ids = np.array([6, 1, 1, 3], np.int64)
    got = {}
    for pkg in (jmx, tmx):
        kv = pkg.kv.create("local")
        kv.init("emb", _nd(pkg, table))
        out = _nd(pkg, np.zeros((4, 5), np.float32))
        kv.row_sparse_pull("emb", out=out, row_ids=_nd(pkg, ids))
        outs = [_nd(pkg, np.zeros((2, 5), np.float32)) for _ in range(2)]
        kv.row_sparse_pull("emb", out=outs, row_ids=np.array([7, 0]))
        got[pkg] = (out.asnumpy(), [o.asnumpy() for o in outs])
    np.testing.assert_array_equal(got[tmx][0], got[jmx][0])
    np.testing.assert_array_equal(got[tmx][0], table[ids])
    for a, b in zip(got[tmx][1], got[jmx][1]):
        np.testing.assert_array_equal(a, b)


def test_optimizer_states_cross_packages(tmp_path):
    """Two pushes in one package's store, its states file into the
    other's, one more push in each: the weights agree."""
    w0 = _values(5, 1)[0]
    grads = _values(6)
    for src, dst in ((tmx, jmx), (jmx, tmx)):
        stores, ws = {}, {}
        for pkg in (src, dst):
            kv = pkg.kv.create("device")
            kv.set_optimizer(pkg.optimizer.create(
                "sgd", learning_rate=0.1, momentum=0.9))
            kv.init(0, _nd(pkg, w0))
            stores[pkg] = kv
        for g in grads[:2]:
            stores[src].push(0, _nd(src, g))
        w = _nd(src, np.zeros(SHAPE, np.float32))
        stores[src].pull(0, out=w)
        fname = str(tmp_path / f"{src.__name__}.states")
        stores[src].save_optimizer_states(fname)
        stores[dst].load_optimizer_states(fname)
        stores[dst].set(0, _nd(dst, w.asnumpy()))
        for pkg in (src, dst):
            stores[pkg].push(0, _nd(pkg, grads[2]))
            o = _nd(pkg, np.zeros(SHAPE, np.float32))
            stores[pkg].pull(0, out=o)
            ws[pkg] = o.asnumpy()
        np.testing.assert_allclose(ws[dst], ws[src], rtol=RTOL, atol=1e-7,
                                   err_msg=f"from {src.__name__}")


def test_two_bit_compression_bit_for_bit():
    rng = np.random.RandomState(7)
    grads = [rng.randn(37).astype(np.float32) * 0.6 for _ in range(3)]
    from mxnet_tpu import gradient_compression as jgc
    from mxnet_tpu_torch import gradient_compression as tgc
    import torch
    res_t = torch.zeros(37)
    res_j = np.zeros(37, np.float32)
    for g in grads:
        pj, res_j, dj = jgc.quantize_2bit(g, res_j, 0.5)
        pt, res_t, dt = tgc.quantize_2bit(torch.from_numpy(g), res_t, 0.5)
        assert np.asarray(pj).view(np.uint32).tolist() == \
            pt.numpy().view(np.uint32).tolist()
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
        np.testing.assert_array_equal(
            tgc.dequantize_2bit(pt, 37, 0.5).numpy(),
            np.asarray(jgc.dequantize_2bit(pj, 37, 0.5)))
    # the store: three pushes with error feedback, then the pulled sums
    got = {}
    for pkg in (jmx, tmx):
        kv = pkg.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(0, _nd(pkg, np.zeros(37, np.float32)))
        pulls = []
        for g in grads:
            kv.push(0, [_nd(pkg, g), _nd(pkg, g)])
            o = _nd(pkg, np.zeros(37, np.float32))
            kv.pull(0, out=o)
            pulls.append(o.asnumpy())
        got[pkg] = pulls
    for a, b in zip(got[tmx], got[jmx]):
        np.testing.assert_array_equal(a, b)
    assert set(np.unique(got[tmx][0])) <= {-0.5, 0.0, 0.5}
    assert tgc.GradientCompression().get_compressed_size(37) == \
        jgc.GradientCompression().get_compressed_size(37) == 12


def test_errors_match_the_jax_package():
    for pkg in (jmx, tmx):
        with pytest.raises(TypeError, match="name must be a string"):
            pkg.kv.create(3)
        with pytest.raises(ValueError, match="unknown kvstore type"):
            pkg.kv.create("bogus")
        with pytest.raises(ValueError, match="not supported for this type"):
            pkg.kv.create("local").set_gradient_compression(
                {"type": "2bit"})
    for name in ("dist_sync", "dist_device_sync", "dist_async", "dist"):
        with pytest.raises(NotImplementedError, match="A11"):
            tmx.kv.create(name)
    for name in ("local", "device", "nccl", "local_allreduce_cpu",
                 "local_allreduce_device"):
        assert tmx.kv.create(name).type == name
    kv = tmx.kv.create("local")

    class _RowSparse:
        stype = "row_sparse"
        shape = SHAPE
    kv.init(0, _nd(tmx, np.zeros(SHAPE, np.float32)))
    with pytest.raises(NotImplementedError, match="A6"):
        kv.pull(0, out=_RowSparse())


def _dense(pkg, gluon, prefix):
    net = gluon.nn.Dense(3, in_units=4, prefix=prefix)
    net.initialize(ctx=tmx.cpu() if pkg is tmx else None)
    return net


@pytest.mark.parametrize("compress", [False, True])
def test_trainer_updates_on_the_store(compress):
    """``Trainer(kvstore=KVStore, update_on_kvstore=True)``, 3 steps.
    With compression the JAX side is its store driven by hand (push the
    gradients, pull the weights): the JAX package's Trainer keeps
    ``compression_params`` without handing them to its store."""
    rng = np.random.RandomState(8)
    w = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    xs = [rng.randn(2, 4).astype(np.float32) for _ in range(3)]
    comp = {"type": "2bit", "threshold": 0.05} if compress else None
    hp = {"learning_rate": 0.1, "momentum": 0.9}
    got = {}
    for pkg, gluon in ((jmx, jgluon), (tmx, tgluon)):
        net = _dense(pkg, gluon, "kvd_")
        net.weight.set_data(_nd(pkg, w))
        net.bias.set_data(_nd(pkg, b))
        params = [net.weight, net.bias]
        kv = pkg.kv.create("device")
        by_hand = compress and pkg is jmx
        if by_hand:
            kv.set_gradient_compression(comp)
            kv.set_optimizer(pkg.optimizer.create("sgd", rescale_grad=0.5,
                                                  **hp))
            for i, p in enumerate(params):
                kv.init(i, p.data())
        else:
            tr = gluon.Trainer(net.collect_params(), "sgd", hp, kvstore=kv,
                               update_on_kvstore=True,
                               compression_params=comp)
        for x in xs:
            with pkg.autograd.record():
                loss = (net(_nd(pkg, x)) ** 2).sum()
            loss.backward()
            if by_hand:
                for i, p in enumerate(params):
                    kv.push(i, p.grad())
                    kv.pull(i, out=p.data())
            else:
                tr.step(2)
                assert tr._update_on_kvstore
        got[pkg] = (net.weight.data().asnumpy(), net.bias.data().asnumpy())
    for a, c in zip(got[tmx], got[jmx]):
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=1e-6)
    assert not np.allclose(got[tmx][0], w)
