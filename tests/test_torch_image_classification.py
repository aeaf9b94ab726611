"""The port's image-classification examples
(``mxnet_tpu_torch.examples.image_classification``) against the JAX
package's (``examples/image_classification``), on the CPU.

The JAX example modules are loaded by file path under private names:
never as the top-level ``common`` / ``symbols`` that the JAX tests put
on ``sys.path`` (the test files share worker processes).

- Every ``symbols/`` network: the same symbol JSON, arguments and
  inferred shapes under fresh name scopes.
- CPU forwards in float32 of lenet, mlp, alexnet (99x99 images),
  mobilenet (multiplier 0.25, 64x64) and the CIFAR ResNet-20 at batch 2
  from the same parameters: within 2e-5 of the largest output (summation
  order). The same forwards of a bf16 batch (what ``benchmark_score``
  feeds): both packages compute in the same mixed dtypes, so the outputs
  agree within 2e-2 (bf16's 8 bits, a few roundings apart), and each
  must stay near the float32 forward of the rounded batch (0.1).
- ``LRN``: forward within 1e-6 and its gradient within 1e-5 of the JAX
  op's and ``jax.vjp``'s.
- ``fit.fit`` of train_mnist's mlp and lenet in both packages from the
  same ``arg_params`` (passed through ``fit``'s kwargs), one epoch of 8
  batches of 16 on the synthetic sets: parameters within 2e-4 of their
  largest entry (+1e-5), the validation accuracy equal; each package
  loads the other's checkpoint, and ``--load-epoch`` resumes it bit for
  bit.
- ``_benchmark`` on a CIFAR ResNet-20 at batch 4 prints the JAX line's
  keys; ``get_fine_tune_model`` cuts the same graph and keeps the same
  params; ``get_rec_iter`` without ``--benchmark`` raises naming A9.
"""
import argparse
import ast
import contextlib
import importlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu.ops import nn as jnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples.image_classification import (
    benchmark_score, fine_tune, train_imagenet, train_mnist)
from mxnet_tpu_torch.examples.image_classification.common import data as tdata
from mxnet_tpu_torch.examples.image_classification.common import fit as tfit
from mxnet_tpu_torch.name import NameManager as TorchNameManager
from mxnet_tpu_torch.ops import nn as tnn
from torch_threads import one_torch_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_EXAMPLE = os.path.join(_ROOT, "examples", "image_classification")
_PORT = "mxnet_tpu_torch.examples.image_classification"

FWD_TOL = 2e-5
BF16_PKG_TOL = 2e-2
BF16_VS_FP32 = 0.1
LRN_FWD_TOL = 1e-6
LRN_GRAD_TOL = 1e-5
FIT_TOL = 2e-4


def _jax_example(rel):
    """A JAX example file as a module under a private name."""
    path = os.path.join(_JAX_EXAMPLE, rel)
    name = "_jax_ic_" + rel.replace("/", "_").replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_symbols(name):
    return importlib.import_module(f"{_PORT}.symbols.{name}")


def _pair(name, **kw):
    with JaxNameManager():
        js = _jax_example(f"symbols/{name}.py").get_symbol(**kw)
    with TorchNameManager():
        ts = _port_symbols(name).get_symbol(**kw)
    return js, ts


SYMBOLS = [
    ("alexnet", {"num_classes": 1000}, (3, 224, 224)),
    ("googlenet", {"num_classes": 1000}, (3, 224, 224)),
    ("inception_bn", {"num_classes": 1000}, (3, 224, 224)),
    ("inception_v3", {"num_classes": 1000}, (3, 299, 299)),
    ("lenet", {"num_classes": 10}, (1, 28, 28)),
    ("mlp", {"num_classes": 10}, (1, 28, 28)),
    ("mobilenet", {"num_classes": 1000}, (3, 224, 224)),
    ("resnext", {"num_classes": 1000, "num_layers": 50}, (3, 224, 224)),
    ("vgg", {"num_classes": 1000, "num_layers": 16}, (3, 224, 224)),
    ("vgg", {"num_classes": 1000, "num_layers": 11, "batch_norm": True},
     (3, 224, 224)),
    ("resnet", {"num_classes": 1000, "num_layers": 50,
                "image_shape": "3,224,224"}, (3, 224, 224)),
    ("resnet", {"num_classes": 10, "num_layers": 110,
                "image_shape": "3,32,32"}, (3, 32, 32)),
]


@pytest.mark.parametrize("name,kw,shape", SYMBOLS,
                         ids=[f"{n}-{k.get('num_layers', '')}"
                              f"{'-bn' if k.get('batch_norm') else ''}"
                              for n, k, _ in SYMBOLS])
def test_symbol_json_arguments_and_shapes(name, kw, shape):
    js, ts = _pair(name, **kw)
    assert json.loads(ts.tojson()) == json.loads(js.tojson())
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    ja = js.infer_shape(data=(2,) + shape)
    ta = ts.infer_shape(data=(2,) + shape)
    assert [[tuple(s) for s in group] for group in ta] == \
        [[tuple(s) for s in group] for group in ja]


def test_symbol_modules_stay_in_their_package():
    import sys
    importlib.import_module(f"{_PORT}.benchmark_score")
    for top in ("common", "symbols"):
        mod = sys.modules.get(top)
        assert mod is None or "mxnet_tpu_torch" not in \
            (getattr(mod, "__file__", "") or "")
    assert _port_symbols("resnet").get_symbol is \
        importlib.import_module(
            "mxnet_tpu_torch.model_zoo.symbols.resnet").get_symbol


def _draw_params(sym, data_shape, seed):
    """Float32 params and aux of ``sym``: He-scaled weights, BatchNorm
    statistics that keep activations near unit scale."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    rng = np.random.RandomState(seed)
    args, aux = {}, {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        s = tuple(s)
        if n.endswith("weight"):
            fan_in = int(np.prod(s[1:]))
            args[n] = (rng.randn(*s) * np.sqrt(2.0 / fan_in)) \
                .astype(np.float32)
        elif n.endswith("gamma"):
            args[n] = (1 + 0.1 * rng.randn(*s)).astype(np.float32)
        else:
            args[n] = (0.1 * rng.randn(*s)).astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        s = tuple(s)
        aux[n] = (0.1 * rng.randn(*s)).astype(np.float32) \
            if n.endswith("mean") else \
            rng.uniform(0.5, 1.5, s).astype(np.float32)
    return args, aux


def _forward(pkg, sym, args, aux, x):
    kw = {"context": tmx.cpu()} if pkg is tmx else {}
    m = pkg.mod.Module(sym, **kw)
    m.bind([("data", x.shape)], [("softmax_label", (x.shape[0],))],
           for_training=False)

    def nd(v):
        return pkg.nd.array(v, ctx=tmx.cpu()) if pkg is tmx \
            else pkg.nd.array(v)
    m.set_params({k: nd(v) for k, v in args.items()},
                 {k: nd(v) for k, v in aux.items()})
    if pkg is tmx:
        xb = tmx.nd.array(torch.from_numpy(x.astype(np.float32)).to(
            torch.bfloat16) if x.dtype.name == "bfloat16"
            else torch.from_numpy(x), ctx=tmx.cpu())
    else:
        xb = jmx.nd.array(x)
    m.forward(pkg.io.DataBatch([xb], []), is_train=False)
    return np.asarray(m.get_outputs()[0].asnumpy(), np.float32)


FORWARDS = [
    ("lenet", {"num_classes": 10}, (1, 28, 28)),
    ("mlp", {"num_classes": 10}, (1, 28, 28)),
    ("alexnet", {"num_classes": 10}, (3, 99, 99)),
    ("mobilenet", {"num_classes": 10, "multiplier": 0.25}, (3, 64, 64)),
    ("resnet", {"num_classes": 10, "num_layers": 20,
                "image_shape": "3,32,32"}, (3, 32, 32)),
]


@pytest.mark.parametrize("name,kw,shape", FORWARDS,
                         ids=[n for n, _, _ in FORWARDS])
def test_cpu_forward_fp32_and_bf16_batch(name, kw, shape):
    js, ts = _pair(name, **kw)
    args, aux = _draw_params(js, (2,) + shape, seed=3)
    x = np.random.RandomState(4).rand(2, *shape).astype(np.float32)
    want = _forward(jmx, js, args, aux, x)
    got = _forward(tmx, ts, args, aux, x)
    assert got.shape == want.shape == (2, kw["num_classes"])
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL * scale)
    # a bf16 batch (benchmark_score's): the same mixed-dtype computation
    import ml_dtypes
    xb = x.astype(ml_dtypes.bfloat16)
    want16 = _forward(jmx, js, args, aux, xb)
    got16 = _forward(tmx, ts, args, aux, xb)
    np.testing.assert_allclose(got16, want16, rtol=0, atol=BF16_PKG_TOL)
    ref = _forward(tmx, ts, args, aux, xb.astype(np.float32))
    np.testing.assert_allclose(got16, ref, rtol=0, atol=BF16_VS_FP32)


def test_lrn_forward_and_gradient():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, 3, 4).astype(np.float32)
    g = rng.randn(2, 7, 3, 4).astype(np.float32)
    kw = {"alpha": 1e-2, "beta": 0.75, "knorm": 2.0, "nsize": 5}
    want, vjp = jax.vjp(lambda d: jnn.lrn(d, **kw), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tnn.lrn(xt, **kw)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=LRN_FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=0, atol=LRN_GRAD_TOL)
    # nd and sym with AlexNet's attributes
    a = tmx.nd.LRN(tmx.nd.array(x, ctx=tmx.cpu()), alpha=1e-4, beta=0.75,
                   knorm=2, nsize=5)
    b = jmx.nd.LRN(jmx.nd.array(x), alpha=1e-4, beta=0.75, knorm=2,
                   nsize=5)
    np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=0,
                               atol=LRN_FWD_TOL)
    for pkg, nm in ((jmx, JaxNameManager), (tmx, TorchNameManager)):
        with nm():
            s = pkg.sym.LRN(pkg.sym.Variable("data"), nsize=3)
        assert s.infer_shape(data=(2, 7, 3, 4))[1] == [(2, 7, 3, 4)]


def _fit_args(pkg_fit, argv):
    parser = argparse.ArgumentParser()
    pkg_fit.add_fit_args(parser)
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--num-examples", type=int, default=128)
    return parser.parse_args(argv)


def _loader(data_mod):
    def load(args, kv):
        shape = (args.batch_size, 1, 28, 28)
        train = data_mod.SyntheticDataIter(10, shape, num_batches=8,
                                           learnable=True, noise=0.5,
                                           seed=0)
        val = data_mod.SyntheticDataIter(10, shape, num_batches=2,
                                         learnable=True, noise=0.5, seed=1)
        return train, val
    return load


@pytest.mark.parametrize("network,lr", [("mlp", 0.05), ("lenet", 0.02)])
def test_train_mnist_fit_matches_jax(network, lr, tmp_path):
    jfit = _jax_example("common/fit.py")
    jdata = _jax_example("common/data.py")
    js, ts = _pair(network, num_classes=10)
    args0, _ = _draw_params(js, (16, 1, 28, 28), seed=6)
    argv = ["--network", network, "--num-epochs", "1", "--batch-size",
            "16", "--lr", str(lr), "--disp-batches", "4"]
    res = {}
    for pkg, fmod, dmod, sym, extra in (
            (jmx, jfit, jdata, js, []),
            (tmx, tfit, tdata, ts, ["--device", "cpu"])):
        prefix = str(tmp_path / f"{pkg.__name__}_{network}")
        a = _fit_args(fmod, argv + extra + ["--model-prefix", prefix])

        def nd(v, pkg=pkg):
            return pkg.nd.array(v, ctx=tmx.cpu()) if pkg is tmx \
                else pkg.nd.array(v)
        # the data loader runs in the fit's device context
        model = fmod.fit(a, sym, _loader(dmod),
                         arg_params={k: nd(v) for k, v in args0.items()},
                         aux_params={})
        params = {k: np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                                else v.numpy())
                  for k, v in model.get_params()[0].items()}
        with tmx.cpu() if pkg is tmx else contextlib.nullcontext():
            _, val = _loader(dmod)(a, None)
        acc = model.score(val, "acc")[0][1]
        res[pkg] = (params, acc, prefix)
    (tp, tacc, tprefix), (jp, jacc, jprefix) = res[tmx], res[jmx]
    assert tacc == jacc
    for k in jp:
        scale = np.abs(jp[k] - args0[k]).max()
        np.testing.assert_allclose(tp[k], jp[k], rtol=0,
                                   atol=FIT_TOL * scale + 1e-5,
                                   err_msg=k)
    # each package loads the other's checkpoint, bit for bit
    for loader, prefix, want in ((jmx.model.load_checkpoint, tprefix, tp),
                                 (tmx.model.load_checkpoint, jprefix, jp)):
        sym, arg, aux = loader(prefix, 1)
        assert sorted(arg) == sorted(want)
        for k, v in arg.items():
            np.testing.assert_array_equal(v.asnumpy(), want[k])
    # --load-epoch: the port resumes the JAX checkpoint with no epoch left
    a = _fit_args(tfit, argv + ["--device", "cpu", "--model-prefix",
                                jprefix, "--load-epoch", "1"])
    resumed = tfit.fit(a, ts, _loader(tdata))
    for k, v in resumed.get_params()[0].items():
        np.testing.assert_array_equal(v.numpy(), jp[k])


def test_train_mnist_script_runs_on_the_cpu():
    model = train_mnist.main(["--device", "cpu", "--num-epochs", "1",
                              "--disp-batches", "20"])
    with tmx.cpu():
        _, val = tdata.get_mnist_iter(
            argparse.Namespace(batch_size=64, data_dir="data/mnist"))
    assert model.score(val, "acc")[0][1] > 0.95
    assert len(model._kvstore._data) == len(model._param_names)


def _jax_benchmark_keys():
    """The keys of the JAX example's ``_benchmark`` line, from its
    source (its ``print(json.dumps({...}))``)."""
    tree = ast.parse(open(os.path.join(_JAX_EXAMPLE, "common",
                                       "fit.py")).read())
    bench = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "_benchmark")
    for node in ast.walk(bench):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return [k.value for k in node.keys]
    raise AssertionError("no JSON line in the JAX _benchmark")


def test_benchmark_prints_the_jax_line():
    out = io.StringIO()
    argv = ["--benchmark", "1", "--device", "cpu", "--network", "resnet",
            "--num-layers", "20", "--image-shape", "3,32,32",
            "--num-classes", "10", "--batch-size", "4"]
    with contextlib.redirect_stdout(out):
        args = train_imagenet.parse_args(argv)
        args.benchmark_steps = 2
        net = _port_symbols("resnet").get_symbol(
            num_classes=10, num_layers=20, image_shape="3,32,32")
        model = tfit.fit(args, net, tdata.get_rec_iter)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == _jax_benchmark_keys()
    assert line["vs_baseline"] is None and line["steps"] == 2
    assert line["batch"] == 4 and line["value"] > 0
    assert model._fused is not None
    assert model.benchmark_result["device"] == "cpu"
    # the script's own entry point takes the same arguments
    with contextlib.redirect_stdout(io.StringIO()):
        m2 = train_imagenet.main(argv[:-2] + ["--num-epochs", "1",
                                              "--batch-size", "2"])
    assert m2._fused.num_update > 0


def test_get_rec_iter_needs_image_record_iter():
    args = argparse.Namespace(image_shape="3,32,32", benchmark=0,
                              batch_size=2, num_classes=10,
                              data_train="x.rec")
    with pytest.raises(NotImplementedError, match="A9"):
        tdata.get_rec_iter(args)
    from mxnet_tpu_torch.examples.image_classification import score
    with pytest.raises(NotImplementedError, match="A9"):
        score.score("prefix", 0, "val.rec")


def _jax_get_fine_tune_model():
    """The JAX example's ``get_fine_tune_model``, taken from its source:
    importing ``fine_tune.py`` would register the top-level ``common``."""
    src = open(os.path.join(_JAX_EXAMPLE, "fine_tune.py")).read()
    tree = ast.parse(src)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "get_fine_tune_model")
    ns = {"mx": jmx}
    exec(compile(ast.Module([fn], []), "fine_tune.py", "exec"), ns)
    return ns["get_fine_tune_model"]


def test_get_fine_tune_model_matches_jax():
    js, ts = _pair("lenet", num_classes=10)
    args, _ = _draw_params(js, (2, 1, 28, 28), seed=7)
    with JaxNameManager():
        jnet, jargs = _jax_get_fine_tune_model()(
            js, {k: jmx.nd.array(v) for k, v in args.items()}, 4)
    with TorchNameManager():
        tnet, targs = fine_tune.get_fine_tune_model(
            ts, {k: tmx.nd.array(v, ctx=tmx.cpu())
                 for k, v in args.items()}, 4)
    assert json.loads(tnet.tojson()) == json.loads(jnet.tojson())
    assert sorted(targs) == sorted(jargs)
    assert tnet.infer_shape(data=(2, 1, 28, 28))[1] == [(2, 4)]
    with pytest.raises(ValueError, match="no checkpoint params"):
        fine_tune.get_fine_tune_model(ts, {"x": None}, 4)


def test_benchmark_score_networks_bind_on_the_cpu():
    sym, shape = benchmark_score.get_network("resnet-50")
    assert shape == (3, 224, 224) and "fc1_weight" in sym.list_arguments()
    assert benchmark_score.get_network("inception-v3")[1] == (3, 299, 299)
    with pytest.raises(ValueError):
        benchmark_score.get_network("vgg-x")
    mod, batches = benchmark_score.bind_scoring("alexnet", 1, "bfloat16",
                                                "cpu")
    assert batches[0].data[0].dtype == np.dtype("float32") or \
        batches[0].data[0]._data.dtype == torch.bfloat16
    mod.forward(batches[0], is_train=False)
    out = mod.get_outputs()[0]
    assert out.shape == (1, 1000)
    assert out._data.dtype == torch.float32      # FC promotes, as in JAX
    np.testing.assert_allclose(out.asnumpy().sum(), 1.0, rtol=1e-3)
