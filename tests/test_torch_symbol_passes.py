"""The port's symbol layer and rewrite passes
(``mxnet_tpu_torch/symbol``) against the JAX package's.

- The port's ResNet-50 symbol serializes to the same JSON as the JAX
  package's, string for string, and each package loads the other's.
- Shape inference agrees.
- On the full ResNet-50 graph (built, never run) the serving pipeline
  reports the same sites and bail-outs in both packages: pallas_fusion
  28 sites / 5 bail-outs, residual_fusion 17 / 8.
"""
import importlib.util
import os

import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu.symbol import passes as jax_passes

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.model_zoo.symbols import resnet as torch_resnet
from mxnet_tpu_torch.name import NameManager as TorchNameManager
from mxnet_tpu_torch.symbol import passes as torch_passes
from torch_threads import one_torch_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_resnet_module():
    path = os.path.join(_ROOT, "examples", "image_classification",
                        "symbols", "resnet.py")
    spec = importlib.util.spec_from_file_location("_jax_resnet_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(model_args, **kw):
    """(jax symbol, port symbol) built by the same constructor call, each
    under a fresh name scope so automatic names start from 0."""
    with JaxNameManager():
        js = _jax_resnet_module().get_symbol(*model_args, **kw)
    with TorchNameManager():
        ts = torch_resnet.get_symbol(*model_args, **kw)
    return js, ts


RESNET50 = (1000, 50, "3,224,224")


def test_resnet50_json_identical_and_cross_loads():
    js, ts = _both(RESNET50)
    assert ts.tojson() == js.tojson()
    # each package loads the other's JSON and writes it back unchanged
    assert tmx.sym.load_json(js.tojson()).tojson() == js.tojson()
    assert jmx.sym.load_json(ts.tojson()).tojson() == ts.tojson()
    loaded = tmx.sym.load_json(js.tojson())
    assert loaded.list_arguments() == js.list_arguments()
    assert loaded.list_auxiliary_states() == js.list_auxiliary_states()
    assert loaded.list_outputs() == js.list_outputs() == ["softmax_output"]


@pytest.mark.parametrize("args", [(10, 20, "3,32,32"), (100, 164, "3,28,28"),
                                  (10, 18, "3,64,64"), (10, 101, "3,96,96")])
def test_other_resnets_json_identical(args):
    js, ts = _both(args)
    assert ts.tojson() == js.tojson()


def test_resnet50_infer_shape_matches():
    js, ts = _both(RESNET50)
    jshapes = js.infer_shape(data=(2, 3, 224, 224))
    tshapes = ts.infer_shape(data=(2, 3, 224, 224))
    assert [list(map(tuple, s)) for s in tshapes] == \
        [list(map(tuple, s)) for s in jshapes]
    n_params = sum(int(torch.tensor(s).prod())
                   for n, s in zip(ts.list_arguments(), tshapes[0])
                   if n not in ("data", "softmax_label"))
    assert 25_000_000 < n_params < 26_000_000


def _bound_shapes(sym, batch):
    a, _, x = sym.infer_shape(data=(batch, 3, 224, 224))
    shapes = dict(zip(sym.list_arguments(), a))
    shapes.update(zip(sym.list_auxiliary_states(), x))
    return {n: tuple(s) for n, s in shapes.items()}


def _entries(report):
    return {e["pass"]: e for e in report["passes"]}


def test_resnet50_serving_pass_reports_match():
    """The serving pipeline over the full ResNet-50 graph at batch 64,
    both flags forced on: identical site and bail-out lists."""
    js, ts = _both(RESNET50)
    shapes = _bound_shapes(ts, 64)
    assert shapes == _bound_shapes(js, 64)
    with jmx.config.override("MXTPU_PALLAS_FUSION", "1"), \
            jmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        jfused, jrep = jax_passes.apply_pipeline(
            js, shapes, tag="predictor", mode="serving",
            data_names={"data", "softmax_label"})
    with tmx.config.override("MXTPU_PALLAS_FUSION", "1"), \
            tmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        tfused, trep = torch_passes.apply_pipeline(
            ts, shapes, tag="predictor", mode="serving",
            device=torch.device("cpu"),
            data_names={"data", "softmax_label"})
    je, te = _entries(jrep), _entries(trep)
    for name, n_sites, n_bail in (("pallas_fusion", 28, 5),
                                  ("residual_fusion", 17, 8)):
        assert te[name]["status"] == je[name]["status"] == "applied"
        assert len(te[name]["sites"]) == n_sites
        assert len(te[name]["bailouts"]) == n_bail
        assert te[name]["sites"] == je[name]["sites"]
        assert te[name]["bailouts"] == je[name]["bailouts"]
    for name in ("bn_fold", "hoist", "int8_ptq", "bf16_cast"):
        assert te[name]["status"] == "disabled"
        assert "not ported" in te[name]["reason"]
    assert trep.keys() == jrep.keys() - {"_seen"}
    assert te["pallas_fusion"].keys() == je["pallas_fusion"].keys()
    # the rewritten graphs hold the same ops
    ops = sorted(n.op for n in tfused._topo_nodes() if n.op)
    assert ops == sorted(n.op for n in jfused._topo_nodes() if n.op)
    assert ops.count("_FusedBNReLUConv") == 28
    assert ops.count("_FusedBNReLUConvK") == 17
    assert tfused.list_arguments() == ts.list_arguments()
    assert tfused.list_auxiliary_states() == ts.list_auxiliary_states()


def _tail_net(mod, num_filter):
    """BN -> ReLU -> 1x1 conv over a (2, 8, 40, 40) input, in either
    package's ``sym`` namespace."""
    s = mod.sym
    data = s.Variable("data")
    bn = s.BatchNorm(data=data, fix_gamma=False, name="bn")
    act = s.Activation(data=bn, act_type="relu", name="relu")
    conv = s.Convolution(data=act, num_filter=num_filter, kernel=(1, 1),
                         no_bias=True, name="conv")
    return s.Flatten(data=conv)


@pytest.mark.parametrize("num_filter", [16, 12])
def test_tile_bailout_reason_matches(num_filter):
    """A conv whose num_filter no multiple of 8 divides bails with the
    same reason in both packages (then residual_fusion takes it)."""
    with JaxNameManager():
        js = _tail_net(jmx, num_filter)
    with TorchNameManager():
        ts = _tail_net(tmx, num_filter)
    a, _, x = ts.infer_shape(data=(2, 8, 40, 40))
    shapes = dict(zip(ts.list_arguments(), a))
    shapes.update(zip(ts.list_auxiliary_states(), x))
    with jmx.config.override("MXTPU_PALLAS_FUSION", "1"), \
            jmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        _, jrep = jax_passes.apply_pipeline(js, shapes, tag="t",
                                            mode="serving")
    with tmx.config.override("MXTPU_PALLAS_FUSION", "1"), \
            tmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        _, trep = torch_passes.apply_pipeline(ts, shapes, tag="t",
                                              device=torch.device("cpu"))
    je, te = _entries(jrep), _entries(trep)
    for name in ("pallas_fusion", "residual_fusion"):
        assert (te[name]["status"], te[name]["sites"],
                te[name]["bailouts"]) == (je[name]["status"],
                                          je[name]["sites"],
                                          je[name]["bailouts"])


@pytest.mark.parametrize("device,flag,active", [
    ("cpu", "auto", False), ("cuda", "auto", True), ("cpu", "1", True),
    ("cuda", "0", False)])
def test_auto_flag_means_on_for_cuda(device, flag, active):
    """``auto`` resolves against the program's device (the JAX package
    resolved it against a TPU backend); no kernel runs here."""
    ts = _tail_net(tmx, 16)
    a, _, x = ts.infer_shape(data=(2, 8, 4, 4))
    shapes = dict(zip(ts.list_arguments(), a))
    shapes.update(zip(ts.list_auxiliary_states(), x))
    with tmx.config.override("MXTPU_PALLAS_FUSION", flag), \
            tmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", flag):
        fused, rep = torch_passes.apply_pipeline(
            ts, shapes, tag="t", device=torch.device(device))
    entries = _entries(rep)
    assert entries["pallas_fusion"]["status"] == \
        ("applied" if active else "disabled")
    assert entries["residual_fusion"]["status"] == \
        ("no_match" if active else "disabled")
    assert (fused is not None) == active


class _BrokenPass(torch_passes.GraphPass):
    """A pass that raises, or whose rewrite drops an argument."""

    name = "broken"

    def __init__(self, how):
        self.how = how

    def apply(self, sym, shapes, ctx):
        if self.how == "raise":
            raise ValueError("planted failure")
        return tmx.sym.Flatten(data=tmx.sym.var("data")), {"sites": [{}]}


@pytest.mark.parametrize("how,status", [("raise", "error"),
                                        ("reject", "rejected")])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_failed_pass_raises_for_cuda(how, status, device):
    """Off CUDA a failed pass is reported and the graph kept; for a CUDA
    program the kept graph would run library ops in place of the
    kernels, so the manager raises (no kernel runs here)."""
    ts = _tail_net(tmx, 16)
    a, _, x = ts.infer_shape(data=(2, 8, 4, 4))
    shapes = dict(zip(ts.list_arguments(), a))
    shapes.update(zip(ts.list_auxiliary_states(), x))
    mgr = torch_passes.PassManager([_BrokenPass(how)])
    if device == "cuda":
        with pytest.raises(tmx.MXNetError, match="rewrite pass broken"):
            mgr.run(ts, shapes, tag="t", device=torch.device(device))
        return
    fused, rep = mgr.run(ts, shapes, tag="t", device=torch.device(device))
    assert fused is None
    assert _entries(rep)["broken"]["status"] == status
