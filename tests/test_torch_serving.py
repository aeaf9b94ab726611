"""The port's serving slice end to end (``mxnet_tpu_torch/serving``)
against the JAX package's ``mxnet_tpu.serving.Predictor``.

A narrow ResNet (pre-activation bottleneck units, the repo's own
constructor) with the same seeded params goes through both packages'
Predictors, with both rewrite passes forced on, so the port runs its
fused ops (kernels' plain versions on the CPU) and the JAX package its
Pallas ops in interpret mode. Requests of 3 and 8 rows test the bucket
padding. Tolerances: fp32 ``rtol 1e-4, atol 1e-5`` on the softmax
outputs; bf16 the same argmax and ``atol 2e-2``.

Also: ``DynamicBatcher`` answers concurrent requests with the results
``predict`` gives, sheds load and expires deadlines; the port and
``chip_smoke.py`` import nothing of JAX or of the JAX package.
"""
import ast
import importlib.util
import os
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serving as jax_serving
from mxnet_tpu.name import NameManager as JaxNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.model_zoo.symbols import resnet as torch_resnet
from mxnet_tpu_torch.name import NameManager as TorchNameManager
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.serving

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(units=[2, 1, 1, 1], num_stages=4,
              filter_list=[8, 32, 64, 128, 256], num_classes=10,
              image_shape=[3, 64, 64], bottle_neck=True)
FEAT = (3, 64, 64)
BUCKETS = (1, 8)


def _jax_resnet_module():
    path = os.path.join(_ROOT, "examples", "image_classification",
                        "symbols", "resnet.py")
    spec = importlib.util.spec_from_file_location("_jax_resnet_example2",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch_net():
    with TorchNameManager():
        return torch_resnet.resnet(**NARROW)


@pytest.fixture(scope="module")
def params():
    return tmx.interop.init_params(_torch_net(), {"data": (8,) + FEAT},
                                   seed=0)


@pytest.fixture(scope="module")
def requests_np():
    rng = np.random.default_rng(11)
    return {r: rng.standard_normal((r,) + FEAT).astype(np.float32)
            for r in (3, 8)}


def _port_predictor(params, compute_dtype=None, **kw):
    args, aux = params
    with tmx.config.override("MXTPU_PALLAS_FUSION", "1"), \
            tmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        return serving.Predictor(_torch_net(), args, aux,
                                 data_shapes={"data": FEAT},
                                 buckets=kw.pop("buckets", BUCKETS),
                                 compute_dtype=compute_dtype,
                                 device="cpu", **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_resnet_predictor_matches_jax(params, requests_np, dtype):
    args, aux = params
    cdt = None if dtype == "float32" else dtype
    with JaxNameManager():
        jsym = _jax_resnet_module().resnet(**NARROW)
    with jmx.config.override("MXTPU_PALLAS_FUSION", "1"), \
            jmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        jpred = jax_serving.Predictor(jsym, args, aux,
                                      data_shapes={"data": FEAT},
                                      buckets=BUCKETS, compute_dtype=cdt)
    tpred = _port_predictor(params, cdt)
    assert tpred.report()["pass_sites"] == \
        jpred.report()["pass_sites"] == \
        {"pallas_fusion": 6, "residual_fusion": 6}
    for rows, x in requests_np.items():
        want = np.asarray(jpred.predict(x))
        got = tpred.predict(x)
        assert got.shape == want.shape == (rows, 10)
        assert got.dtype == np.float32
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    # both requests ran the 8 bucket; the 3-row one padded 5 rows
    assert tpred.report()["per_bucket"][8] == {"calls": 2, "rows": 11,
                                              "pad_rows": 5}


def test_fusion_changes_nothing_in_fp32(params, requests_np):
    """The rewritten predict graph equals the plain graph (fp32)."""
    args, aux = params
    x = requests_np[8]
    fused = _port_predictor(params).predict(x)
    with tmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "0"):
        plain = serving.Predictor(_torch_net(), args, aux,
                                  data_shapes={"data": FEAT},
                                  buckets=BUCKETS, apply_fusion=False,
                                  device="cpu")
    assert plain.report()["pass_sites"] == {}
    np.testing.assert_allclose(fused, plain.predict(x), rtol=1e-5,
                               atol=1e-6)


def test_predict_chunks_oversized_requests(params):
    pred = _port_predictor(params)
    x = np.random.default_rng(2).standard_normal((19,) + FEAT) \
        .astype(np.float32)
    whole = pred.predict(x)
    parts = np.concatenate([pred.predict(x[:8]), pred.predict(x[8:16]),
                            pred.predict(x[16:])])
    np.testing.assert_allclose(whole, parts, rtol=1e-6, atol=1e-7)
    assert pred.bucket_for(1) == 1 and pred.bucket_for(5) == 8
    assert pred.bucket_for(100) == pred.max_batch == 8


def test_dynamic_batcher_matches_predict(params):
    pred = _port_predictor(params)
    rng = np.random.default_rng(4)
    reqs = [rng.standard_normal((r,) + FEAT).astype(np.float32)
            for r in (1, 2, 3, 1, 5, 2)]
    want = [pred.predict(x) for x in reqs]
    results = [None] * len(reqs)
    batcher = serving.DynamicBatcher(pred, max_wait_us=200000)
    with batcher:
        gate = threading.Barrier(len(reqs))

        def client(i):
            gate.wait()
            results[i] = batcher.submit(reqs[i]).result(timeout=60)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        rep = batcher.report()
    for got, w in zip(results, want):
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
    assert rep["served_requests"] == len(reqs)
    # coalesced: fewer micro-batches than requests
    assert sum(v["batches"] for v in rep["per_bucket"].values()) \
        < len(reqs)


def test_dynamic_batcher_sheds_and_expires(params):
    pred = _port_predictor(params)
    x2 = np.zeros((2,) + FEAT, np.float32)
    batcher = serving.DynamicBatcher(pred, max_wait_us=0, max_queue=3)
    batcher.start()
    try:
        with pred._lock:          # stall the loop inside its first batch
            first = batcher.submit(x2)
            deadline = time.monotonic() + 30
            while batcher.queue_depth and time.monotonic() < deadline:
                time.sleep(0.005)
            assert batcher.queue_depth == 0
            late = batcher.submit(x2, deadline_ms=1)
            with pytest.raises(serving.Overloaded):
                batcher.submit(x2)
            time.sleep(0.05)
        assert first.result(timeout=30).shape == (2, 10)
        with pytest.raises(serving.DeadlineExceeded):
            late.result(timeout=30)
        rep = batcher.report()
        assert rep["shed_requests"] == 1 and rep["deadline_missed"] == 1
    finally:
        batcher.stop()
    with pytest.raises(tmx.MXNetError, match="not started"):
        batcher.submit(x2)


def test_no_device_means_cuda_or_raise(params):
    """Entry points run on cuda:0 unless given a device; without CUDA
    they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args, aux = params
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        serving.Predictor(_torch_net(), args, aux,
                          data_shapes={"data": FEAT}, buckets=BUCKETS)


def test_params_from_jax_carries_names_dtypes_and_shapes(params):
    args, aux = params
    jargs = {n: jmx.nd.array(v) for n, v in args.items()}
    targs, taux = tmx.interop.params_from_jax(jargs, aux, "cpu",
                                              dtype="bfloat16")
    assert targs.keys() == args.keys() and taux.keys() == aux.keys()
    for n, v in args.items():
        assert targs[n].dtype == torch.bfloat16
        np.testing.assert_allclose(targs[n].float().numpy(), v,
                                   rtol=1e-2, atol=1e-6)
    assert all((t > 0).all() for n, t in taux.items()
               if n.endswith("moving_var"))
    with pytest.raises(tmx.MXNetError, match="has shape"):
        tmx.interop.params_from_jax(
            {"fc1_weight": np.zeros((3, 3), np.float32)}, {}, "cpu",
            shapes={"fc1_weight": (10, 256)})


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    """No file of the port, and not chip_smoke.py, imports jax or the
    JAX package."""
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(_ROOT, "mxnet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, _ROOT), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
    assert not bad, bad
