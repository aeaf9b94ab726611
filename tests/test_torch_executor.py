"""The port's bound Executor (``Symbol.simple_bind`` / ``bind``,
``mxnet_tpu_torch.executor``) against the JAX package's, on the CPU.

The same numpy arrays go into both packages' executors:

- an MLP with BatchNorm: forward (train and eval), backward for grad_req
  write / add / null (``add`` over two backward calls equals twice one),
  the aux after forward(train) + backward (folded twice, as the
  reference does), ``bind`` with lists and dicts;
- a narrow ResNet (``stem="s2d"``) with the fusion passes on, so the
  plain versions of K1, K2, B1 and B2 run in the port (the JAX package
  runs its Pallas kernels in interpret mode);
- explicit ``out_grads`` on heads without an implicit loss, and the six
  implicit-loss heads (SoftmaxOutput, Softmax, LinearRegressionOutput,
  MAERegressionOutput, LogisticRegressionOutput, SVMOutput);
- ``reshape``, ``copy_params_from``, ``eval``, ``get_internals``,
  ``infer_type``, the symbol arithmetic helpers, the Monitor callback,
  and program sharing between equal binds.

Tolerances: the MLP and the heads rtol 1e-5, atol 1e-6 (fp32 sums in
another order); the ResNet rtol 1e-4, atol 1e-5 on outputs and aux and
on each gradient relative to its own scale (the same graph through a
different convolution and fused-kernel arithmetic, 20 layers deep).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JaxNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.model_zoo.symbols import resnet as torch_resnet
from mxnet_tpu_torch.name import NameManager as TorchNameManager
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(data, num_hidden=12, name="x1", no_bias=True)
    h = pkg.sym.BatchNorm(h, name="xbn", fix_gamma=False)
    h = pkg.sym.Activation(h, act_type="relu", name="xrelu")
    h = pkg.sym.FullyConnected(h, num_hidden=5, name="x2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _values(sym, shapes, seed=0):
    a, _, x = sym.infer_shape(**shapes)
    rng = np.random.default_rng(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), a):
        if n.endswith("label"):
            args[n] = rng.integers(0, 5, s).astype(np.float32)
        else:
            args[n] = (rng.standard_normal(s) * 0.5).astype(np.float32)
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("var")
               else 0.1 * rng.standard_normal(s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), x)}
    return args, aux


def _bind(pkg, sym, args, aux, grad_req="write"):
    ctx = "cpu" if pkg is tmx else jmx.cpu()
    exe = sym.simple_bind(ctx=ctx, grad_req=grad_req,
                          **{n: v.shape for n, v in args.items()
                             if n in ("data", "softmax_label")})
    for n, v in args.items():
        exe.arg_dict[n][:] = torch.from_numpy(v) if pkg is tmx \
            else jmx.nd.array(v)
    for n, v in aux.items():
        exe.aux_dict[n][:] = torch.from_numpy(v) if pkg is tmx \
            else jmx.nd.array(v)
    return exe


def _np(a):
    return np.asarray(a.asnumpy())


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_mlp_forward_backward_matches_jax(req):
    args, aux = _values(_mlp(tmx), {"data": (6, 7)})
    res = {}
    for pkg in (tmx, jmx):
        exe = _bind(pkg, _mlp(pkg), args, aux, grad_req=req)
        ev = _np(exe.forward(is_train=False)[0])
        out = _np(exe.forward(is_train=True)[0])
        exe.backward()
        once = {n: _np(g) for n, g in exe.grad_dict.items()
                if g is not None}
        if req == "add":
            exe.backward()
        res[pkg] = (ev, out, once,
                    {n: _np(g) for n, g in exe.grad_dict.items()
                     if g is not None},
                    {n: _np(a) for n, a in exe.aux_dict.items()})
    t, j = res[tmx], res[jmx]
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t[1], j[1], rtol=RTOL, atol=ATOL)
    if req == "null":
        assert t[2] == {}
    assert set(t[3]) == {n for n, g in j[3].items()} or req == "null"
    for n in t[3]:
        np.testing.assert_allclose(t[3][n], j[3][n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
        if req == "add":
            # grad_req add: two backward calls add up to twice one
            np.testing.assert_allclose(t[3][n], 2 * t[2][n], rtol=1e-6,
                                       atol=1e-7, err_msg=n)
    for n in t[4]:
        np.testing.assert_allclose(t[4][n], j[4][n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_bind_lists_and_dicts():
    args, aux = _values(_mlp(tmx), {"data": (4, 7)}, seed=1)
    res = {}
    for pkg in (tmx, jmx):
        sym = _mlp(pkg)
        ctx = "cpu" if pkg is tmx else jmx.cpu()
        arr = (lambda v: tmx.nd.array(v, ctx="cpu")) if pkg is tmx \
            else jmx.nd.array
        names = sym.list_arguments()
        exe = sym.bind(ctx, args=[arr(args[n]) for n in names],
                       args_grad={"x1_weight": arr(np.zeros_like(
                           args["x1_weight"]))},
                       grad_req={"x1_weight": "write"},
                       aux_states=[arr(aux[n]) for n in
                                   sym.list_auxiliary_states()])
        exe.forward(is_train=True)
        exe.backward()
        res[pkg] = (_np(exe.outputs[0]), _np(exe.grad_dict["x1_weight"]))
    for a, b in zip(res[tmx], res[jmx]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _narrow_resnet(pkg):
    cfg = dict(units=[1, 1, 1, 1], num_stages=4,
               filter_list=[8, 16, 32, 32, 64], num_classes=10,
               image_shape=[3, 64, 64], bottle_neck=True, stem="s2d")
    if pkg is tmx:
        with TorchNameManager():
            return torch_resnet.resnet(**cfg)
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "_jax_resnet_exec", os.path.join(root, "examples",
                                         "image_classification", "symbols",
                                         "resnet.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    with JaxNameManager():
        return m.resnet(**cfg)


def test_narrow_resnet_with_fusion_passes_matches_jax():
    """Train-mode bind with both rewrite passes on: the port's K1/K2 sites
    (their plain versions here) and B1/B2 under their backward."""
    res = {}
    for pkg in (tmx, jmx):
        with pkg.config.override("MXTPU_PALLAS_FUSION", "1"), \
                pkg.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
            sym = _narrow_resnet(pkg)
            args, aux = _values(sym, {"data": (2, 3, 64, 64)}, seed=2)
            for n in args:
                if n.endswith("gamma"):
                    args[n] = 1.0 + 0.1 * args[n]
            exe = _bind(pkg, sym, args, aux)
            out = _np(exe.forward(is_train=True)[0])
            exe.backward()
            rep = exe.pass_report if pkg is tmx else exe._pass_report
        res[pkg] = (out, {n: _np(g) for n, g in exe.grad_dict.items()},
                    {n: _np(a) for n, a in exe.aux_dict.items()}, rep)
    t, j = res[tmx], res[jmx]
    ported = ("pallas_fusion", "residual_fusion")
    sites = {e["pass"]: len(e["sites"]) for e in t[3]["passes"]
             if e["pass"] in ported}
    jsites = {e["pass"]: len(e["sites"]) for e in j[3]["passes"]
              if e["pass"] in ported}
    assert t[3]["tag"] == "executor" and t[3]["mode"] == "train"
    assert sites["pallas_fusion"] > 0 and sites == jsites, (sites, jsites)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4, atol=1e-5)
    for n, g in j[1].items():
        if n in ("data", "softmax_label"):
            continue
        scale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(t[1][n] / scale, g / scale, rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    for n in j[2]:
        np.testing.assert_allclose(t[2][n], j[2][n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_out_grads_on_explicit_heads():
    res = {}
    rng = np.random.default_rng(3)
    hg = [rng.standard_normal((4, 3)).astype(np.float32),
          rng.standard_normal((4, 2)).astype(np.float32)]
    for pkg in (tmx, jmx):
        data = pkg.sym.Variable("data")
        a = pkg.sym.FullyConnected(data, num_hidden=3, name="ha")
        b = pkg.sym.FullyConnected(pkg.sym.Activation(
            a, act_type="tanh", name="hact"), num_hidden=2, name="hb")
        sym = pkg.sym.Group([a, b])
        args, _ = _values(sym, {"data": (4, 6)}, seed=4)
        exe = _bind(pkg, sym, args, {})
        exe.forward(is_train=True)
        arr = (lambda v: tmx.nd.array(v, ctx="cpu")) if pkg is tmx \
            else jmx.nd.array
        exe.backward(out_grads=[arr(h) for h in hg])
        res[pkg] = {n: _np(g) for n, g in exe.grad_dict.items()}
    for n in res[jmx]:
        np.testing.assert_allclose(res[tmx][n], res[jmx][n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


HEADS = [
    ("SoftmaxOutput", {}), ("Softmax", {}),
    ("LinearRegressionOutput", {"grad_scale": 0.5}),
    ("MAERegressionOutput", {}), ("LogisticRegressionOutput", {}),
    ("SVMOutput", {"margin": 0.5}),
    ("SVMOutput", {"use_linear": True, "regularization_coefficient": 0.3}),
]


@pytest.mark.parametrize("head,attrs", HEADS,
                         ids=[f"{h}-{i}" for i, (h, _) in enumerate(HEADS)])
def test_implicit_heads_match_jax(head, attrs):
    res = {}
    classes = head in ("SoftmaxOutput", "Softmax", "SVMOutput")
    for pkg in (tmx, jmx):
        data = pkg.sym.Variable("data")
        fc = pkg.sym.FullyConnected(data, num_hidden=4, name="hfc")
        sym = getattr(pkg.sym, head)(fc, name="head", **attrs)
        assert sym.list_arguments()[-1] == "head_label"
        shapes = {"data": (5, 3)}
        a, _, _ = sym.infer_shape(**shapes)
        assert tuple(a[-1]) == ((5,) if classes else (5, 4))
        rng = np.random.default_rng(5)
        args = {"data": rng.standard_normal((5, 3)).astype(np.float32),
                "hfc_weight": rng.standard_normal((4, 3))
                .astype(np.float32),
                "hfc_bias": rng.standard_normal(4).astype(np.float32),
                "head_label": (rng.integers(0, 4, 5) if classes
                               else rng.random((5, 4))).astype(np.float32)}
        ctx = "cpu" if pkg is tmx else jmx.cpu()
        exe = sym.simple_bind(ctx=ctx, data=(5, 3))
        for n, v in args.items():
            exe.arg_dict[n][:] = torch.from_numpy(v) if pkg is tmx \
                else jmx.nd.array(v)
        out = _np(exe.forward(is_train=True)[0])
        exe.backward()
        res[pkg] = (out, _np(exe.grad_dict["hfc_weight"]),
                    _np(exe.grad_dict["data"]))
    for a, b in zip(res[tmx], res[jmx]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=head)


def test_reshape_copy_params_and_sharing():
    args, aux = _values(_mlp(tmx), {"data": (6, 7)}, seed=6)
    res = {}
    for pkg in (tmx, jmx):
        exe = _bind(pkg, _mlp(pkg), args, aux)
        exe.forward(is_train=True)
        small = exe.reshape(data=(3, 7), softmax_label=(3,))
        assert small.arg_dict["x1_weight"] is exe.arg_dict["x1_weight"]
        arr = (lambda v: tmx.nd.array(v, ctx="cpu")) if pkg is tmx \
            else jmx.nd.array
        new_w = args["x2_weight"] * 2
        mean = arr(aux["xbn_moving_mean"])
        small.copy_params_from({"x2_weight": arr(new_w)},
                               {"xbn_moving_mean": mean})
        small.arg_dict["data"][:] = arr(args["data"][:3])
        res[pkg] = _np(small.forward(is_train=False)[0])
        with pytest.raises(ValueError):
            small.copy_params_from({"nope": arr(new_w)})
    np.testing.assert_allclose(res[tmx], res[jmx], rtol=RTOL, atol=ATOL)
    assert res[tmx].shape == (3, 5)
    # equal binds share their programs; another shape does not
    s = _mlp(tmx)
    e1 = s.simple_bind(ctx="cpu", data=(6, 7))
    e2 = s.simple_bind(ctx="cpu", data=(6, 7))
    e3 = s.simple_bind(ctx="cpu", data=(2, 7))
    assert e2.shared and e1._progs is e2._progs
    assert e3._progs is not e1._progs


def test_eval_internals_infer_type_and_arithmetic():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3)).astype(np.float32)
    y = rng.standard_normal((2, 3)).astype(np.float32)
    got = {}
    for pkg in (tmx, jmx):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        expr = (2 * a + b / 4 - 1) * (a - 3) + (-b) ** 2 + 1 / (b * b + 1)
        arr = (lambda v: tmx.nd.array(v, ctx="cpu")) if pkg is tmx \
            else jmx.nd.array
        ctx = "cpu" if pkg is tmx else jmx.cpu()
        got[pkg] = _np(expr.eval(ctx=ctx, a=arr(x), b=arr(y))[0])
        mlp = _mlp(pkg)
        got[(pkg, "internals")] = mlp.get_internals().list_outputs()
        got[(pkg, "type")] = [len(t) for t in mlp.infer_type(
            data=np.float32)]
        got[(pkg, "item")] = mlp.get_internals()["xrelu_output"] \
            .list_outputs()
    np.testing.assert_allclose(got[tmx], got[jmx], rtol=RTOL, atol=ATOL)
    for k in ("internals", "type", "item"):
        assert got[(tmx, k)] == got[(jmx, k)], k
    g = tmx.sym.Group([tmx.sym.var("p"), tmx.sym.var("q")])
    assert len(g) == 2 and [s.name for s in g] == ["p", "q"]


def test_monitor_callback_all_op_outputs_match_jax():
    args, aux = _values(_mlp(tmx), {"data": (6, 7)}, seed=8)
    seen = {}
    for pkg in (tmx, jmx):
        exe = _bind(pkg, _mlp(pkg), args, aux)
        got = []
        exe.set_monitor_callback(lambda n, v: got.append((n, _np(v))),
                                 monitor_all=True)
        exe.forward(is_train=True)
        seen[pkg] = got
    assert [n for n, _ in seen[tmx]] == [n for n, _ in seen[jmx]]
    for (n, a), (_, b) in zip(seen[tmx], seen[jmx]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=n)
