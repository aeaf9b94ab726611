"""``export``, ``SymbolBlock`` and the parameter files of the port's Gluon
against the JAX package's, on the CPU.

- ``HybridBlock.export`` of the same nets with the same parameters in
  both packages: the ``-symbol.json`` text is equal and the ``.params``
  file is equal byte for byte (an MLP, a conv + BatchNorm net, a narrow
  ResNet v1 and a small dcgan generator on ``Conv2DTranspose``).
- ``SymbolBlock`` over the exported graph and parameters (the port's
  files and the JAX package's) gives the net's forward within 1e-5, and
  so does a ``serving.Predictor`` built from the exported files.
- ``save_parameters`` / ``load_parameters``, ``save_params`` /
  ``load_params`` and ``ParameterDict.save`` / ``load`` (with
  ``strip_prefix`` / ``restore_prefix``) write files the JAX package
  reads and read the files it writes, values bit for bit.
- ``summary``, ``apply`` and ``infer_type``.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.name import NameManager as JaxNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.name import NameManager as TorchNameManager
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_scope():
    with tmx.cpu():
        yield


def _mlp(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"), nn.Dropout(0.2),
                nn.Dense(5))
    return net


def _conv_bn(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="cbn_")
    with net.name_scope():
        net.add(nn.Conv2D(6, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.AvgPool2D(), nn.Flatten(),
                nn.Dense(5))
    return net


def _resnet(pkg):
    v = pkg.gluon.model_zoo.vision
    return v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1], [16, 32, 48, 64, 80],
                      classes=10, thumbnail=True)


def _generator(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="gen_")
    with net.name_scope():
        net.add(nn.Conv2DTranspose(8, 4, 1, 0, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(3, 4, 2, 1, use_bias=False),
                nn.Activation("tanh"))
    return net


NETS = {"mlp": (_mlp, (3, 12)), "conv_bn": (_conv_bn, (2, 3, 8, 8)),
        "resnet_v1_narrow": (_resnet, (2, 3, 32, 32)),
        "generator": (_generator, (2, 6, 1, 1))}


def _params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _pair(name, seed=0):
    build, shape = NETS[name]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    with JaxNameManager():
        jnet = build(jmx)
    with TorchNameManager():
        tnet = build(tmx)
    jmx.random.seed(seed)
    jnet.initialize(jmx.init.Xavier())
    jnet(jnd.array(x))
    rng = np.random.default_rng(seed + 1)
    for n, p in jnet.collect_params().items():
        if "running_var" in n:       # running statistics away from 0 / 1
            p.set_data(jnd.array(rng.uniform(0.5, 1.5, p.shape).astype(
                np.float32)))
        elif "running_mean" in n:
            p.set_data(jnd.array(0.1 * rng.standard_normal(p.shape).astype(
                np.float32)))
    tmx.interop.gluon_params_from_jax(_params(jnet), tnet, "cpu")
    jnet.hybridize()
    tnet.hybridize()
    return jnet, tnet, x


@pytest.mark.parametrize("name", sorted(NETS))
def test_export_matches_jax_json_and_params_bytes(name, tmp_path):
    jnet, tnet, x = _pair(name)
    with JaxNameManager():
        jnet.export(str(tmp_path / "j"), epoch=3)
    with TorchNameManager():
        tsym = tnet.export(str(tmp_path / "t"), epoch=3)
    assert (tmp_path / "t-symbol.json").read_text() == \
        (tmp_path / "j-symbol.json").read_text()
    assert (tmp_path / "t-0003.params").read_bytes() == \
        (tmp_path / "j-0003.params").read_bytes()
    assert tsym.list_outputs() == [tsym.list_outputs()[0]]


@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("name", ["conv_bn", "resnet_v1_narrow", "generator"])
def test_symbol_block_runs_the_exported_graph(name, source, tmp_path):
    jnet, tnet, x = _pair(name)
    with JaxNameManager(), TorchNameManager():
        (jnet if source == "jax" else tnet).export(str(tmp_path / "m"))
    want = tnet(tnd.array(x)).asnumpy()
    block = tgluon.SymbolBlock(tmx.sym.load(str(tmp_path / "m-symbol.json")),
                               tmx.sym.var("data"))
    block.collect_params().load(str(tmp_path / "m-0000.params"),
                                ctx=tmx.cpu())
    np.testing.assert_allclose(block(tnd.array(x)).asnumpy(), want,
                               atol=ATOL)
    block.hybridize()
    np.testing.assert_allclose(block(tnd.array(x)).asnumpy(), want,
                               atol=ATOL)
    imported = tgluon.SymbolBlock.imports(
        str(tmp_path / "m-symbol.json"), "data",
        str(tmp_path / "m-0000.params"), ctx=tmx.cpu())
    np.testing.assert_allclose(imported(tnd.array(x)).asnumpy(), want,
                               atol=ATOL)


def test_predictor_serves_the_exported_files(tmp_path):
    _, tnet, x = _pair("resnet_v1_narrow")
    with TorchNameManager():
        tnet.export(str(tmp_path / "m"))
    sym = tmx.sym.load(str(tmp_path / "m-symbol.json"))
    loaded = tnd.load(str(tmp_path / "m-0000.params"))
    args = {k[4:]: v.asnumpy() for k, v in loaded.items()
            if k.startswith("arg:")}
    aux = {k[4:]: v.asnumpy() for k, v in loaded.items()
           if k.startswith("aux:")}
    pred = tmx.serving.Predictor(sym, args, aux,
                                 data_shapes={"data": x.shape[1:]},
                                 buckets=(2,), device="cpu")
    np.testing.assert_allclose(pred.predict(x), tnet(tnd.array(x)).asnumpy(),
                               atol=ATOL)


def test_symbol_block_in_training_folds_running_statistics():
    _, tnet, x = _pair("conv_bn")
    sym = tnet._trace_symbol()
    block = tgluon.SymbolBlock(sym, tmx.sym.var("data"))
    for n, p in tnet.collect_params().items():
        block.params.get(n).set_data(p.data().copy())
    tnet.hybridize(False)
    with tmx.autograd.train_mode():
        block(tnd.array(x))
        tnet(tnd.array(x))
    for n, p in tnet.collect_params().items():
        np.testing.assert_allclose(block.params.get(n).data().asnumpy(),
                                   p.data().asnumpy(), atol=ATOL)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_and_load_parameters_across_packages(writer, tmp_path):
    jnet, tnet, x = _pair("conv_bn")
    f = str(tmp_path / "p.params")
    with JaxNameManager():
        jfresh = _conv_bn(jmx)
    with TorchNameManager():
        tfresh = _conv_bn(tmx)
    jfresh.initialize(jmx.init.Zero())
    jfresh(jnd.array(x))
    tfresh.initialize(tmx.init.Zero(), ctx=tmx.cpu())
    tfresh.hybridize()
    tfresh(tnd.array(x))
    (tnet if writer == "port" else jnet).save_parameters(f)
    jfresh.load_parameters(f)
    tfresh.load_parameters(f)
    want = _params(jnet)
    # the structural names are the same in both packages
    assert sorted(tnd.load(f)) == sorted(jnd.load(f))
    for got in (_params(jfresh), _params(tfresh)):
        assert [got[k].tobytes() for k in want] == \
            [want[k].tobytes() for k in want]
    # the captured block reads the loaded values
    np.testing.assert_allclose(tfresh(tnd.array(x)).asnumpy(),
                               jnet(jnd.array(x)).asnumpy(), atol=ATOL)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_params_and_parameter_dict_files_across_packages(writer,
                                                              tmp_path):
    jnet, tnet, _ = _pair("mlp")
    src = tnet if writer == "port" else jnet
    f1, f2 = str(tmp_path / "a.params"), str(tmp_path / "b.params")
    src.save_params(f1)
    src.collect_params().save(f2, strip_prefix="mlp_")
    assert open(f1, "rb").read() == open(f2, "rb").read()
    want = _params(jnet)
    for f in (f1, f2):
        with TorchNameManager():
            t2 = _mlp(tmx)
        t2.load_params(f, ctx=tmx.cpu())
        with JaxNameManager():
            j2 = _mlp(jmx)
        j2.collect_params().load(f, restore_prefix="mlp_")
        for got in (_params(t2), _params(j2)):
            assert all(np.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError):
        tnet.collect_params().save(f1, strip_prefix="other_")
    with pytest.raises(IOError):
        tnet.collect_params().load(f1)          # names lack the prefix
    tnet.collect_params().load(f1, ignore_extra=True, allow_missing=True)


def test_summary_apply_and_infer_type(capsys):
    _, tnet, x = _pair("conv_bn")
    tnet.summary(tnd.array(x))
    out = capsys.readouterr().out
    assert "HybridSequential(cbn)" in out and "Conv2D(cbn_conv0)" in out
    seen = []
    assert tnet.apply(lambda b: seen.append(b.name)) is tnet
    assert seen[-1] == "cbn" and len(seen) == 7
    dense = tgluon.nn.Dense(3, in_units=2)
    dense.infer_type(tnd.array(np.ones((1, 2)), dtype="float64"))
    assert all(p.dtype == np.float64 for p in dense.params.values())
