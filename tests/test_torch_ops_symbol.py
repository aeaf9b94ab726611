"""The op set through the symbolic and imperative surfaces, against the
JAX package's, on the CPU: the registry (the names still missing equal
the listed 32 exactly; every one of the 206 names, and of the 32 contrib
detection and vision names, runs its case through its own name, resolves
to the JAX package's op and records a gradient where that one does, and
as a one-node symbol has the JAX package's JSON, arguments and inferred
shapes), a symbol over 34 of the new ops
(``tojson()``, ``list_arguments()``, ``infer_shape()`` and
``infer_shape_partial()`` equal, the JAX package's JSON binding in the
port to the same outputs at rtol 1e-4), the padded-sequence symbol of
``chip_smoke.py``'s phase 22b (JSON, shapes, outputs and gradients at
rtol 1e-4), ``Symbol.attr``, ``eval_dict`` and ``debug_str``, the
BatchNorm aliases in a loaded JSON, the ``NDArray`` methods,
``nd.moveaxis`` / ``nd.onehot_encode``, the top-level names, and the
CPU half of C-11: a bound program's draws come from
``random.generator(device)`` and follow the seed."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import sweep
from mxnet_tpu_torch.ops.registry import _OPS as PORT_OPS
from mxnet_tpu_torch.ops.registry import get_op

from torch_ops_parity import check_case

TOL = 1e-4


def _jax():
    import mxnet_tpu as mx
    import mxnet_tpu.ops  # noqa: F401
    return mx


def test_missing_names_are_the_listed_32():
    from mxnet_tpu.ops.registry import _OPS as JAX_OPS
    listed = [n for names in sweep.STAY_MISSING.values() for n in names]
    assert len(listed) == len(set(listed)) == 32
    assert sorted(sweep.STAY_MISSING) == ["A12", "A6", "A9"]
    assert sorted(set(JAX_OPS) - set(PORT_OPS)) == sorted(listed)
    assert not set(PORT_OPS) - set(JAX_OPS)
    assert len(sweep.NEW_NAMES) == len(set(sweep.NEW_NAMES)) == 206
    assert len(sweep.CONTRIB_NAMES) == len(set(sweep.CONTRIB_NAMES)) == 32
    assert not set(sweep.CONTRIB_NAMES) & set(sweep.NEW_NAMES)
    assert len(JAX_OPS) - len(listed) == len(PORT_OPS) == 394


@pytest.mark.parametrize("name", sweep.NEW_NAMES + sweep.CONTRIB_NAMES)
def test_every_name(name):
    """Each name resolves to the JAX package's op (the same canonical
    name, the same ``no_grad``) and runs its first case through itself:
    forward parity at the case's tolerance, or for a sampler, the JAX
    package's shape and dtype."""
    from mxnet_tpu.ops.registry import get_op as jget
    port, ref = get_op(name), jget(name)
    assert port.name == ref.name and port.no_grad == ref.no_grad, name
    if port.name in sweep.SAMPLERS:
        return   # drawn: tests/test_torch_ops_random.py
    cases = sweep.cases_of(name)
    assert cases, f"no case covers {name}"
    base = cases[0]
    check_case(sweep.Case(name, base.family, base.make, base.attrs,
                          base.tol, base.grad, base.check, base.tag),
               backward=False)


def wide_symbol(S):
    """A symbol over 34 of the slice's ops."""
    x, y, ids = S.var("x"), S.var("y"), S.var("ids")
    a = S.arcsinh(x, name="a1")
    b = S.softsign(a, name="a2")
    c = S.erf(b, name="a3")
    d = S.smooth_l1(c, scalar=2.0, name="a4")
    e = S.expm1(d, name="a5")
    f = S.log1p(S.abs(e, name="abs0"), name="a6")
    g = S._Plus(f, y, name="a7")
    h = S._Mul(g, y, name="a8")
    i = S.broadcast_minimum(h, x, name="a9")
    j = S._hypot(i, y, name="a10")
    k = S.arctan(j, name="a11")
    lr = S.rint(S._mul_scalar(k, scalar=4.0, name="m0"), name="a12")
    m = S.round(lr, name="a13")
    n = S._maximum_scalar(m, scalar=-1.0, name="a14")
    o = S.quadratic(n, a=0.5, b=1.0, c=0.25, name="a15")
    p = S.tile(o, reps=(2, 1), name="a16")
    q = S.repeat(p, repeats=2, axis=1, name="a17")
    r = S.flip(q, axis=0, name="a18")
    s = S.slice(r, begin=(1, 2), end=(7, 10), name="a19")
    t = S.take(s, ids, name="a20")
    u = S.topk(t, k=4, ret_typ="value", name="a21")
    v = S.sort(u, is_ascend=False, name="a22")
    w = S.L2Normalization(v, name="a23")
    z = S.SoftmaxActivation(w, name="a24")
    bb = S.BlockGrad(z, name="a25")
    gm = S.linalg_gemm2(bb, z, transpose_b=True, name="a26")
    sy = S.linalg_syrk(gm, name="a27")
    tr = S.linalg_trmm(sy, gm, name="a28")
    pr = S.prod(tr, axis=1, name="a29")
    ns = S.nansum(tr, axis=0, name="a30")
    hs = S.add_n(pr, ns, pr, name="a31")
    return S.Group([S.MakeLoss(hs, name="a32"), S.identity(w, name="a33"),
                    S.argsort(u, name="a34")])


WIDE_SHAPES = {"x": (4, 6), "y": (4, 6), "ids": (3,)}


def _wide_inputs():
    rs = np.random.RandomState(19)
    return {"x": rs.standard_normal((4, 6)).astype(np.float32),
            "y": rs.standard_normal((4, 6)).astype(np.float32),
            "ids": np.asarray([0, 5, 2], np.float32)}


def _both(builder):
    from mxnet_tpu.name import NameManager as JaxNM
    from mxnet_tpu_torch.name import NameManager as TorchNM
    mx = _jax()
    with JaxNM():
        j = builder(mx.sym)
    with TorchNM():
        p = builder(mt.sym)
    return j, p


def test_wide_symbol_json_and_shapes():
    j, p = _both(wide_symbol)
    new = {n.op for n in p._topo_nodes() if n.op in sweep.NEW_NAMES}
    assert len(new) >= 30, sorted(new)
    assert p.tojson() == j.tojson()
    assert p.list_arguments() == j.list_arguments()
    assert p.list_outputs() == j.list_outputs()
    assert p.infer_shape(**WIDE_SHAPES) == j.infer_shape(**WIDE_SHAPES)
    part = {"x": (4, 6)}
    assert p.infer_shape_partial(**part) == j.infer_shape_partial(**part)
    assert p.debug_str() == j.debug_str()


def test_jax_json_computes_in_the_port():
    """The JAX package's JSON, loaded by the port and bound on the CPU,
    gives the JAX package's outputs."""
    mx = _jax()
    j, _ = _both(wide_symbol)
    vals = _wide_inputs()
    jexe = j.bind(args={k: mx.nd.array(v) for k, v in vals.items()},
                  grad_req="null")
    want = [o.asnumpy() for o in jexe.forward()]
    loaded = mt.sym.load_json(j.tojson())
    pexe = loaded.bind(ctx="cpu", args={k: mt.nd.array(v, ctx="cpu")
                                        for k, v in vals.items()},
                       grad_req="null")
    got = [o.asnumpy() for o in pexe.forward()]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def _seq_inputs(t=12, n=4, vocab=50):
    rs = np.random.RandomState(23)
    return {"data": rs.randint(0, vocab, (t, n)).astype(np.float32),
            "seq_len": np.asarray([12, 5, 1, 8], np.float32)[:n],
            "softmax_label": rs.randint(0, 10, (n,)).astype(np.float32)}


def test_padded_sequence_symbol_against_jax():
    """Phase 22b's symbol: JSON and shapes equal, and one training
    forward and backward on the CPU gives the JAX package's outputs and
    gradients (rtol 1e-4)."""
    mx = _jax()
    j, p = _both(sweep.padded_sequence_symbol)
    assert p.tojson() == j.tojson()
    vals = _seq_inputs()
    shapes = {k: v.shape for k, v in vals.items()}
    assert p.infer_shape(**shapes) == j.infer_shape(**shapes)
    arg_shapes, _, _ = p.infer_shape(**shapes)
    rs = np.random.RandomState(29)
    for name, shp in zip(p.list_arguments(), arg_shapes):
        if name not in vals:
            vals[name] = (0.3 * rs.standard_normal(shp)).astype(np.float32)
    reqs = {n: ("write" if n.endswith(("weight", "bias")) else "null")
            for n in p.list_arguments()}
    jexe = j.bind(args={k: mx.nd.array(v) for k, v in vals.items()},
                  args_grad={k: mx.nd.zeros(vals[k].shape)
                             for k, r in reqs.items() if r == "write"},
                  grad_req=reqs)
    pexe = p.bind(ctx="cpu", args={k: mt.nd.array(v, ctx="cpu")
                                   for k, v in vals.items()},
                  args_grad={k: mt.nd.zeros(vals[k].shape, ctx="cpu")
                             for k, r in reqs.items() if r == "write"},
                  grad_req=reqs)
    jouts = [o.asnumpy() for o in jexe.forward(is_train=True)]
    pouts = [o.asnumpy() for o in pexe.forward(is_train=True)]
    for g, w in zip(pouts, jouts):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    jexe.backward()
    pexe.backward()
    for name, r in reqs.items():
        if r == "write":
            np.testing.assert_allclose(
                pexe.grad_dict[name].asnumpy(),
                jexe.grad_dict[name].asnumpy(), rtol=TOL, atol=TOL,
                err_msg=name)
            assert np.abs(pexe.grad_dict[name].asnumpy()).sum() > 0, name


def test_symbol_attr_and_grad():
    mx = _jax()
    jv = mx.sym.var("x", attr={"mood": "calm", "__lr_mult__": "2"})
    pv = mt.sym.var("x", attr={"mood": "calm", "__lr_mult__": "2"})
    for key in ("mood", "__lr_mult__", "absent"):
        assert pv.attr(key) == jv.attr(key)
    assert pv.attr_dict() == jv.attr_dict()
    with pytest.raises(NotImplementedError):
        pv.grad(["x"])


def _nd_pair(a):
    mx = _jax()
    return mx.nd.array(a), mt.nd.array(a, ctx="cpu")


@pytest.mark.parametrize("method,args,kwargs", [
    ("argsort", (), {"is_ascend": False}),
    ("flip", (1,), {}),
    ("pad", (), {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                 "constant_value": 0.5}),
    ("prod", (), {"axis": 1}),
    ("repeat", (2,), {"axis": 2}),
    ("slice", ((0, 1), (2, None)), {}),
    ("sort", (), {"axis": 1}),
    ("take", (np.asarray([2, 0, 5], np.float32),), {"mode": "wrap"}),
    ("tile", ((1, 2, 1, 1),), {}),
    ("topk", (), {"k": 2, "ret_typ": "value"}),
])
def test_ndarray_methods(method, args, kwargs):
    x = np.random.RandomState(3).randint(0, 4, (2, 3, 4, 3)) \
        .astype(np.float32)
    jx, px = _nd_pair(x)
    jargs = [_nd_pair(a)[0] if isinstance(a, np.ndarray) else a
             for a in args]
    pargs = [_nd_pair(a)[1] if isinstance(a, np.ndarray) else a
             for a in args]
    want = getattr(jx, method)(*jargs, **kwargs).asnumpy()
    got = getattr(px, method)(*pargs, **kwargs).asnumpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_moveaxis_and_onehot_encode():
    mx = _jax()
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    jx, px = _nd_pair(x)
    np.testing.assert_array_equal(mt.nd.moveaxis(px, 0, 2).asnumpy(),
                                  mx.nd.moveaxis(jx, 0, 2).asnumpy())
    idx = np.asarray([2, 0, 3], np.float32)
    jo, po = mx.nd.zeros((3, 5)), mt.nd.zeros((3, 5), ctx="cpu")
    jr = mx.nd.onehot_encode(mx.nd.array(idx), jo)
    pr = mt.nd.onehot_encode(mt.nd.array(idx, ctx="cpu"), po)
    assert pr is po
    np.testing.assert_array_equal(pr.asnumpy(), jr.asnumpy())


def test_no_grad_ops_record_nothing():
    """``no_grad`` ops give results outside autograd's graph; the others
    are recorded, and BlockGrad's gradient is zero."""
    x = mt.nd.array(np.random.RandomState(0).standard_normal((3, 5))
                    .astype(np.float32), ctx="cpu")
    x.attach_grad()
    with mt.autograd.record():
        idx = mt.nd.topk(x, k=2)
        order = mt.nd.argsort(x)
        srt = mt.nd.sort(x)
        blocked = mt.nd.BlockGrad(x)
        loss = mt.nd.sum(srt * 2.0) + mt.nd.sum(blocked * 5.0)
    assert not idx._data.requires_grad and not order._data.requires_grad
    assert srt._data.requires_grad
    loss.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), np.full((3, 5), 2.0))


def test_top_level_names():
    import mxnet_tpu as mx
    expect = {"AttrScope": mt.attribute.AttrScope,
              "Symbol": mt.symbol.Symbol,
              "Executor": mt.executor.Executor,
              "DataBatch": mt.io.DataBatch, "DataIter": mt.io.DataIter}
    for name, obj in expect.items():
        assert getattr(mt, name) is obj, name
        assert obj.__module__.startswith("mxnet_tpu_torch."), name
        assert getattr(mt, name) is not getattr(mx, name), name
    assert mt.attribute.__name__ == "mxnet_tpu_torch.attribute"


def _draw_symbol():
    from mxnet_tpu_torch.name import NameManager
    with NameManager():
        data = mt.sym.var("data")
        return mt.sym._random_uniform(shape=(4, 5), name="u") \
            + mt.sym.Dropout(data, p=0.5, name="drop")


def test_bound_draws_follow_the_seed():
    """C-11, its CPU half: a bound program draws from
    ``random.generator(device)`` (``use_generator``'s inside it), each
    run anew, and ``random.seed`` repeats the draws."""
    exe = _draw_symbol().simple_bind(ctx="cpu", grad_req="null",
                                     data=(4, 5))
    exe.arg_dict["data"][:] = mt.nd.ones((4, 5), ctx="cpu")

    def run():
        return exe.forward(is_train=True)[0].asnumpy()

    mt.random.seed(5)
    first, second = run(), run()
    assert not np.array_equal(first, second)
    mt.random.seed(5)
    np.testing.assert_array_equal(run(), first)
    # the same draws taken from a generator seeded alike, in the walk's
    # order: the uniform node, then Dropout's mask
    g = torch.Generator().manual_seed(5)
    u = torch.empty(4, 5).uniform_(0.0, 1.0, generator=g)
    keep = (torch.rand((4, 5), generator=g) < 0.5).float() / 0.5
    np.testing.assert_allclose(first, (u + keep).numpy(), rtol=0, atol=0)
    own = torch.Generator().manual_seed(77)
    with mt.random.use_generator(own):
        inside = run()
    g = torch.Generator().manual_seed(77)
    u = torch.empty(4, 5).uniform_(0.0, 1.0, generator=g)
    keep = (torch.rand((4, 5), generator=g) < 0.5).float() / 0.5
    np.testing.assert_array_equal(inside, (u + keep).numpy())


def test_eval_dict():
    """``Symbol.eval_dict`` gives the JAX package's outputs, and under
    autograd records the walk as one computation."""
    mx = _jax()
    j, p = _both(wide_symbol)
    vals = _wide_inputs()
    want = [o.asnumpy() for o in
            j.eval_dict({k: mx.nd.array(v) for k, v in vals.items()})]
    args = {k: mt.nd.array(v, ctx="cpu") for k, v in vals.items()}
    got = [o.asnumpy() for o in p.eval_dict(args)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    x = args["x"]
    x.attach_grad()
    with mt.autograd.record():
        out = p.eval_dict(args)[1]
        loss = mt.nd.sum(out * out)
    loss.backward()
    assert np.isfinite(x.grad.asnumpy()).all()


@pytest.mark.parametrize("op", ["BatchNorm_v1", "CuDNNBatchNorm"])
def test_batchnorm_names_in_a_training_bind(op):
    """A symbol JSON whose node names a BatchNorm alias (the symbol
    functions write the canonical ``BatchNorm``), loaded by each package
    and bound for training, has the JAX package's arguments and gives its
    outputs and running statistics: ``BatchNorm_v1`` takes the batch
    statistics and folds them into its aux states; ``CuDNNBatchNorm``,
    which neither the JAX package's op table nor its walk knows, takes
    the moving statistics as arguments and normalizes by them in training
    too (ROADMAP C-ref-10)."""
    mx = _jax()
    from mxnet_tpu.name import NameManager as JaxNM
    rs = np.random.RandomState(31)
    vals = {"data": rs.standard_normal((4, 3, 2, 2)).astype(np.float32),
            "bn_gamma": rs.uniform(0.5, 1.5, 3).astype(np.float32),
            "bn_beta": rs.standard_normal(3).astype(np.float32)}
    stats = {"bn_moving_mean": rs.standard_normal(3).astype(np.float32),
             "bn_moving_var": rs.uniform(0.5, 1.5, 3).astype(np.float32)}
    with JaxNM():
        js = mx.sym.BatchNorm(mx.sym.var("data"), fix_gamma=False, name="bn")
    text = js.tojson().replace('"op": "BatchNorm"', f'"op": "{op}"')
    assert f'"op": "{op}"' in text
    as_aux = op == "BatchNorm_v1"
    outs = []
    for pkg, ctx in ((mx, None), (mt, "cpu")):
        s = pkg.sym.load_json(text)
        outs.append(s.list_arguments())
        kw = {} if ctx is None else {"ctx": ctx}
        args = dict(vals) if as_aux else dict(vals, **stats)
        exe = s.bind(args={k: pkg.nd.array(v, **kw) for k, v in args.items()},
                     aux_states={k: pkg.nd.array(v, **kw)
                                 for k, v in stats.items()} if as_aux else {},
                     grad_req="null", **kw)
        outs.append(exe.forward(is_train=True)[0].asnumpy())
        outs.append({k: exe.aux_dict[k].asnumpy() for k in stats}
                    if as_aux else {})
    (jargs, jo, ja), (pargs, po, pa) = outs[:3], outs[3:]
    assert pargs == jargs
    np.testing.assert_allclose(po, jo, rtol=1e-5, atol=1e-5)
    for k in ja:
        np.testing.assert_allclose(pa[k], ja[k], rtol=1e-5, atol=1e-6)
    x = vals["data"]
    if as_aux:
        mean = x.mean(axis=(0, 2, 3))
        assert not np.allclose(ja["bn_moving_mean"], stats["bn_moving_mean"])
    else:
        mean = stats["bn_moving_mean"]
    var = x.var(axis=(0, 2, 3)) if as_aux else stats["bn_moving_var"]
    want = (x - mean[None, :, None, None]) / np.sqrt(
        var[None, :, None, None] + 1e-3) * vals["bn_gamma"][None, :, None,
                                                             None] \
        + vals["bn_beta"][None, :, None, None]
    np.testing.assert_allclose(jo, want, rtol=1e-4, atol=1e-4)


def _one_op_symbol(S, name):
    """A one-node symbol of op ``name`` over variables ``in0``, ``in1``,
    ... shaped as its first case's (or sampler's) inputs."""
    canon = get_op(name).name
    if canon in sweep.SAMPLERS:
        attrs = dict(sweep.SAMPLERS[canon][0])
        if canon == "_sample_multinomial":
            shapes = [(2, 4)]
        elif canon == "_shuffle":
            shapes = [(6, 2)]
        elif canon.startswith("_sample_") and \
                canon != "_sample_unique_zipfian":
            shapes = [(2,)] * (1 if canon in ("_sample_exponential",
                                               "_sample_poisson") else 2)
            attrs = {"shape": (3,)}
        else:
            shapes = []
            attrs = dict(attrs, shape=(5,))
    else:
        case = sweep.cases_of(name)[0]
        shapes = [tuple(a.shape) for a in case.inputs()]
        attrs = dict(case.attrs)
        attrs.pop("training", None)
    ins = [S.var(f"in{i}") for i in range(len(shapes))]
    return getattr(S, name)(*ins, name="op", **attrs), \
        {f"in{i}": s for i, s in enumerate(shapes)}


@pytest.mark.parametrize("name", sweep.NEW_NAMES + sweep.CONTRIB_NAMES)
def test_every_name_as_a_symbol(name):
    """Each new name as a one-node symbol: ``tojson()``,
    ``list_arguments()`` and ``infer_shape()`` equal the JAX package's
    (shape inference runs the port's op on meta tensors)."""
    from mxnet_tpu.name import NameManager as JaxNM
    from mxnet_tpu_torch.name import NameManager as TorchNM
    mx = _jax()
    with JaxNM():
        j, shapes = _one_op_symbol(mx.sym, name)
    with TorchNM():
        p, _ = _one_op_symbol(mt.sym, name)
    assert p.tojson() == j.tojson()
    assert p.list_arguments() == j.list_arguments()
    assert p.list_auxiliary_states() == j.list_auxiliary_states()
    assert p.infer_shape(**shapes) == j.infer_shape(**shapes)


def test_reference_top_level_names():
    """C-14: ``sparse_report``, ``model.BatchEndParam`` (the JAX
    package's typename, the one the Module's callbacks receive) and
    ``config.show()`` / ``config.variables()`` in the JAX package's
    shape."""
    import mxnet_tpu as mx
    assert mt.sparse_report is mt.sparse.sparse_report
    assert "sparse_report" in mt.__all__
    assert isinstance(mt.sparse_report(), dict) \
        and isinstance(mx.sparse_report(), dict)
    bep = mt.model.BatchEndParam
    assert bep.__name__ == mx.model.BatchEndParam.__name__
    assert bep._fields == mx.model.BatchEndParam._fields
    assert mt.module.base_module.BatchEndParam is bep
    vs = mt.config.variables()
    assert vs and all(isinstance(v, tuple) and len(v) == 3
                      for v in vs.values())
    assert list(vs) == sorted(vs)
    assert all(vs[n][1] == mt.config.get(n) for n in vs)
    head = mx.config.show().splitlines()[0]
    table = mt.config.show().splitlines()
    assert table[0] == head and len(table) == len(vs) + 1
    name = "MXTPU_SERVING_MAX_QUEUE"
    with mt.config.override(name, 7):
        assert mt.config.variables()[name][1] == 7
