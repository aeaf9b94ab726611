"""The port's ``compile`` package (program keys, registry, retrace guard)
and what routes through it, against the JAX package's, on the CPU.

On the CPU the fused step and the Predictor run eagerly, but they key
their programs and note them with the retrace guard as on the card, so
the guard's events compare with the JAX package's.

- ``symbol_digest`` equals the JAX package's for ResNet-50 (``std`` and
  ``s2d`` stems) and a small MLP: the two packages' ``tojson()`` are
  byte-equal.
- ``program_key`` is canonical and selective (as
  ``tests/test_compile_cache.py`` pins the JAX package's): optimizer
  type, momentum, fusion flag, shapes and device each change the digest,
  lr and the step counter do not, and ``diff`` names the material.
- ``optimizer_fingerprint`` equals the JAX package's on the attributes
  both optimizers have; ``pipeline_key_material`` equals the JAX
  package's for the passes both run.
- The retrace guard: the same Predictor request sequence in both
  packages (float32, float64 cast to float32: no new program, float16: a
  new one) gives the same ``retraces`` count and the same ``changed``
  lists and signatures; a new feed signature of the fused step is a
  retrace of ``inputs``.
- The SGD rule with lr as a device scalar against the float-lr rule,
  over lr_mult groups: bit-identical where lr * lr_mult is exact in
  float32 (lr_mult 1 and 0.5), else within one float32 rounding of the
  result plus two of the lr product times |gradient| and of the
  momentum (the two forms round lr * lr_mult once each, in float32 and
  in float64).
- A narrow Module trained 3 steps at lr 0.1, 0.05, 0.025 (a
  MultiFactorScheduler) against the JAX package's ``Module(fused=True)``,
  each port step from the JAX package's state before it, with the
  tolerances of ``tests/test_torch_training.py`` (fp32): each param and
  momentum within 1e-4 of its update's largest entry + 1e-6, aux within
  1e-5, the loss within 1e-5 relative.
- ``set_params`` after the step has started keeps each master tensor's
  storage (a captured graph holds its address) and takes the values.
- ``compile_report()``: its sections, totals and the cache as not
  applicable with its reason.
- The launch counters during a capture: launches onto the capturing
  stream, from any thread, go to the capture's tally; launches onto
  other streams count at once.
- ``Module._update(eager=True)``, the profilers' eager arm, is
  ``update``: the same schedule, lr writes and step counters.
- A ``FusedSymbolStep`` built without a device takes the current
  context's.
"""
import importlib.util
import os
import pickle
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import compile as jcompile
from mxnet_tpu import serving as jax_serving
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu.symbol import passes as jax_passes

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import compile as tcompile
from mxnet_tpu_torch.module.fused import FusedSymbolStep
from mxnet_tpu_torch.ops import fused_bn_conv as tfb
from mxnet_tpu_torch.model_zoo.symbols import resnet as torch_resnet
from mxnet_tpu_torch.name import NameManager as TorchNameManager
from mxnet_tpu_torch.parallel import functional_opt as tfo
from mxnet_tpu_torch.symbol import passes as torch_passes
from torch_threads import one_torch_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(units=[2, 1, 1, 1], num_stages=4,
              filter_list=[8, 32, 64, 128, 256], num_classes=10,
              image_shape=[3, 64, 64], bottle_neck=True, stem="s2d")
BATCH = 4
LRS = (0.1, 0.05, 0.025)


def _jax_resnet_module():
    path = os.path.join(_ROOT, "examples", "image_classification",
                        "symbols", "resnet.py")
    spec = importlib.util.spec_from_file_location("_jax_resnet_compile",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mlp(pkg, hidden=16, classes=8):
    """The same small MLP in either package, every node named."""
    data = pkg.sym.Variable("data")
    h = pkg.sym.Flatten(data, name="flat")
    h = pkg.sym.FullyConnected(h, num_hidden=hidden, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu", name="relu1")
    h = pkg.sym.FullyConnected(h, num_hidden=classes, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _mlp_params(feat=4, hidden=16, classes=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"fc1_weight": rng.standard_normal((hidden, feat)) * 0.5,
            "fc1_bias": rng.standard_normal(hidden) * 0.1,
            "fc2_weight": rng.standard_normal((classes, hidden)) * 0.5,
            "fc2_bias": rng.standard_normal(classes) * 0.1}


@pytest.fixture(autouse=True)
def _fresh_registries():
    jcompile.reset()
    tcompile.reset()
    yield


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["resnet50_std", "resnet50_s2d", "mlp"])
def test_symbol_digest_matches_jax(which):
    if which == "mlp":
        js, ts = _mlp(jmx), _mlp(tmx)
    else:
        stem = which.split("_")[1]
        with JaxNameManager():
            js = _jax_resnet_module().get_symbol(1000, 50, "3,224,224",
                                                 stem=stem)
        with TorchNameManager():
            ts = torch_resnet.get_symbol(1000, 50, "3,224,224", stem=stem)
    assert ts.tojson() == js.tojson()
    assert tcompile.symbol_digest(ts) == jcompile.symbol_digest(js)


def _key(**over):
    sym = over.pop("symbol", None) or _mlp(tmx)
    base = dict(symbol=sym, input_sigs=(((8, 4), "float32"),),
                optimizer=tmx.optimizer.create("sgd", learning_rate=0.1),
                fusion={"flag": "auto", "sites": 0}, device="cpu")
    base.update(over)
    return tcompile.program_key("fused_step", "t", **base)


def test_program_key_canonical_and_selective():
    k1, k2 = _key(), _key()
    assert k1.digest == k2.digest
    variants = {
        "optimizer_type": _key(optimizer=tmx.optimizer.Optimizer(
            learning_rate=0.1)),
        "momentum": _key(optimizer=tmx.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9)),
        "fusion": _key(fusion={"flag": "1", "sites": 3}),
        "shape": _key(input_sigs=(((16, 4), "float32"),)),
        "dtype": _key(input_sigs=(((8, 4), "float16"),)),
        "extra": _key(extra={"compute_dtype": "bfloat16"}),
    }
    digests = [k1.digest] + [k.digest for k in variants.values()]
    assert len(set(digests)) == len(digests)
    # lr and the step counter are run-time values of the captured step
    stepped = tmx.optimizer.create("sgd", learning_rate=0.007)
    stepped.num_update = 1000
    assert _key(optimizer=stepped).digest == k1.digest
    assert variants["optimizer_type"].diff(k1) == ["optimizer"]
    assert variants["momentum"].diff(k1) == ["optimizer"]
    assert variants["fusion"].diff(k1) == ["fusion"]
    assert variants["shape"].diff(k1) == ["inputs"]
    assert k1.diff(None) == []
    assert repr(k1) == f"ProgramKey(fused_step:t@{k1.digest[:10]})"


def test_program_key_backend_identity_and_mesh():
    cpu = _key()
    assert cpu.materials["backend"] == {"platform": "cpu",
                                        "device_kind": "cpu", "ndev": 1}
    # one device: the key carries no mesh material
    assert "mesh" not in cpu.materials
    with pytest.raises(TypeError):
        _key(mesh=None)


def test_arg_signature_spells_dtypes_as_the_jax_package():
    a = np.zeros((3, 4), np.float32)
    t = torch.zeros(2, dtype=torch.float16)
    assert tcompile.arg_signature([a, {"x": t}]) == \
        (((3, 4), "float32"), ((2,), "float16"))
    assert tcompile.arg_signature((a,)) == jcompile.arg_signature((a,))


@pytest.mark.parametrize("kw", [
    {"learning_rate": 0.1},
    {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
     "rescale_grad": 0.25, "clip_gradient": 5.0}])
def test_optimizer_fingerprint_matches_jax(kw):
    idx2name = {0: "fc1_weight", 1: "fc1_bias", 2: "bn_gamma"}
    jo = jmx.optimizer.create("sgd", param_idx2name=idx2name, **kw)
    to = tmx.optimizer.create("sgd", param_idx2name=idx2name, **kw)
    jo.set_lr_mult({"fc1_weight": 0.5})
    to.set_lr_mult({"fc1_weight": 0.5})
    jf = jcompile.optimizer_fingerprint(jo)
    tf = tcompile.optimizer_fingerprint(to)
    common = set(jf) & set(tf)
    assert {"type", "momentum", "wd", "rescale_grad", "lr_mult", "wd_mult",
            "idx2name"} <= common
    assert {k: tf[k] for k in common} == {k: jf[k] for k in common}
    assert "lr" not in tf and "num_update" not in tf


def test_pipeline_key_material_matches_jax():
    with JaxNameManager():
        js = _jax_resnet_module().resnet(**NARROW)
    with TorchNameManager():
        ts = torch_resnet.resnet(**NARROW)
    a, _, x = ts.infer_shape(data=(BATCH, 3, 64, 64))
    shapes = dict(zip(ts.list_arguments(), map(tuple, a)))
    shapes.update(zip(ts.list_auxiliary_states(), map(tuple, x)))
    with jmx.config.override("MXTPU_PALLAS_FUSION", "1"), \
            jmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        _, jrep = jax_passes.apply_pipeline(
            js, shapes, tag="fused_step", mode="train",
            batch_names={"data", "softmax_label"})
    with tmx.config.override("MXTPU_PALLAS_FUSION", "1"), \
            tmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        _, trep = torch_passes.apply_pipeline(
            ts, shapes, tag="fused_step", mode="train",
            device=torch.device("cpu"),
            data_names={"data", "softmax_label"})
    jm = {e[0]: tuple(e) for e in
          jax_passes.pipeline_key_material(jrep)}
    tm = {e[0]: tuple(e) for e in
          torch_passes.pipeline_key_material(trep)}
    both = ("pallas_fusion", "residual_fusion")
    assert {n: tm[n] for n in both} == {n: jm[n] for n in both}
    assert tm["pallas_fusion"] == ("pallas_fusion", "on", "applied", 6)
    assert torch_passes.pipeline_key_material(None) is None


# ---------------------------------------------------------------------------
# the retrace guard
# ---------------------------------------------------------------------------
def _retrace_run(pkg, serving_mod, compile_mod):
    sym = _mlp(pkg)
    args = {k: v.astype(np.float32) for k, v in _mlp_params().items()}
    kw = {} if pkg is jmx else {"device": "cpu"}
    pred = serving_mod.Predictor(sym, args, {}, data_shapes={"data": (4,)},
                                 buckets=(8,), **kw)
    x = np.random.default_rng(1).standard_normal((3, 4))
    outs = [np.asarray(pred.predict(x.astype(dt)), np.float32)
            for dt in ("float32", "float64", "float16")]
    rep = compile_mod.compile_report()
    return pred.retraces, rep["retraces"], outs


def test_predictor_retrace_guard_matches_jax():
    jn, jr, jouts = _retrace_run(jmx, jax_serving, jmx)
    tn, tr, touts = _retrace_run(tmx, tmx.serving, tmx)
    assert tn == jn == 2          # float64 ran as float32; float16 is new
    assert set(tr) == set(jr) == {"predictor:softmax:b8"}
    t_ev, j_ev = tr["predictor:softmax:b8"], jr["predictor:softmax:b8"]
    assert t_ev["count"] == j_ev["count"] == 1
    assert [e["changed"] for e in t_ev["events"]] == \
        [e["changed"] for e in j_ev["events"]] == [["inputs"]]
    assert t_ev["events"] == j_ev["events"]
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def _cpu_module(sym=None, batch=8, feat=4, **opt):
    m = tmx.mod.Module(sym or _mlp(tmx), context="cpu")
    m.bind([("data", (batch, feat))], [("softmax_label", (batch,))])
    m.init_params(arg_params={k: v.astype(np.float32)
                              for k, v in _mlp_params(feat).items()})
    m.init_optimizer(optimizer="sgd",
                     optimizer_params=dict({"learning_rate": 0.1}, **opt))
    return m


def _feed(batch, feat=4, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"data": torch.from_numpy(
                rng.standard_normal((batch, feat)).astype(dtype)),
            "softmax_label": torch.from_numpy(
                rng.integers(0, 8, batch).astype(np.float32))}


def test_fused_step_new_feed_signature_is_a_retrace_of_inputs():
    f = _cpu_module()._fused
    for _ in range(2):
        f.step(_feed(8))
    rep = tcompile.compile_report()
    assert rep["retraces"] == {}
    f.step(_feed(4))
    ev = tcompile.compile_report()["retraces"]["fused_step:softmax"]
    assert ev["count"] == 1
    assert ev["events"][0]["changed"] == ["inputs"]
    assert ev["events"][0]["from_sig"] == ["(8, 4):float32", "(8,):float32"]
    assert ev["events"][0]["to_sig"] == ["(4, 4):float32", "(4,):float32"]
    assert f.num_update == 3


# ---------------------------------------------------------------------------
# lr as a run-time device scalar
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lr_mult", [1.0, 0.5, 0.3])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_tensor_lr_rule_matches_float_lr_rule(lr_mult, momentum):
    """The fused step's update (lr scalar times each group's lr_mult, on
    the device) against the float-lr form of the same rule."""
    m = _cpu_module(momentum=momentum, wd=1e-4)
    f = m._fused
    m._optimizer.set_lr_mult({"fc1_weight": lr_mult, "fc2_weight": lr_mult})
    f._lr_mults = {n: m._optimizer.lr_mult.get(n, 1.0)
                   for n in f.param_names}
    groups = {}
    for n in f.param_names:
        groups.setdefault((f._lr_mults[n], f._wd_eff[n]), []).append(n)
    f._groups = sorted(groups.items())
    rng = np.random.default_rng(9)
    grads = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                 .astype(np.float32))
             for n, p in f._p.items()}
    p0 = {n: p.detach().clone() for n, p in f._p.items()}
    for (s,) in (v for v in f._state.values() if v):
        s.copy_(torch.from_numpy(rng.standard_normal(tuple(s.shape))
                                 .astype(np.float32)))
    s0 = {n: tuple(t.clone() for t in v) for n, v in f._state.items()}
    f.set_lr(0.05)
    f._update({n: g.clone() for n, g in grads.items()}, {})
    rule = tfo.from_optimizer(m._optimizer)
    for (mult, wd), ns in f._groups:
        ps = [p0[n] for n in ns]
        rule.update_(ps, [grads[n].clone() for n in ns],
                     [s0[n] for n in ns], 0.05 * mult, wd)
        exact = mult in (1.0, 0.5)
        for n in ns:
            got, want = f._p[n].detach(), p0[n]
            # inexact: the two lr products differ by one float32
            # rounding; the results by that times |g|, one rounding of
            # the result and, with momentum, one of the new momentum
            tol = 2 ** -23 * float((0.05 * mult * grads[n]).abs().max())
            if momentum:
                tol += 2 ** -23 * float(s0[n][0].abs().max())
            rtol, atol = (0, 0) if exact else (2 ** -23, 2 * tol)
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            if momentum:
                torch.testing.assert_close(f._state[n][0], s0[n][0],
                                           rtol=rtol, atol=atol)


def _initial_state(js):
    rng = np.random.default_rng(0)
    a, _, x = js.infer_shape(data=(BATCH, 3, 64, 64))
    args, aux = {}, {}
    for n, s in zip(js.list_arguments(), a):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("weight"):
            v = rng.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("gamma"):
            v = 1.0 + 0.1 * rng.standard_normal(s)
        else:
            v = 0.1 * rng.standard_normal(s)
        args[n] = v.astype(np.float32)
    for n, s in zip(js.list_auxiliary_states(), x):
        v = rng.uniform(0.5, 1.5, s) if n.endswith("var") \
            else 0.1 * rng.standard_normal(s)
        aux[n] = v.astype(np.float32)
    return args, aux


def _opt(pkg):
    return {"learning_rate": LRS[0], "momentum": 0.9, "wd": 1e-4,
            "lr_scheduler": pkg.lr_scheduler.MultiFactorScheduler(
                step=[1, 2], factor=0.5)}


def _passes_on(pkg):
    return (pkg.config.override("MXTPU_PALLAS_FUSION", "1"),
            pkg.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"))


def test_scheduled_lr_steps_match_jax():
    with JaxNameManager():
        js = _jax_resnet_module().resnet(**NARROW)
    with TorchNameManager():
        ts = torch_resnet.resnet(**NARROW)
    rng = np.random.RandomState(0)
    batches = [(rng.rand(BATCH, 3, 64, 64).astype(np.float32),
                rng.randint(0, 10, (BATCH,)).astype(np.float32))
               for _ in LRS]
    args, aux = _initial_state(js)
    a, b = _passes_on(jmx)
    with a, b:
        jm = jmx.mod.Module(context=jmx.cpu(), symbol=js, fused=True)
        jm.bind(data_shapes=[("data", (BATCH, 3, 64, 64))],
                label_shapes=[("softmax_label", (BATCH,))])
        jm.init_params(arg_params={k: jmx.nd.array(v)
                                   for k, v in args.items()},
                       aux_params={k: jmx.nd.array(v)
                                   for k, v in aux.items()})
        jm.init_optimizer(kvstore=None, optimizer="sgd",
                          optimizer_params=_opt(jmx))
        states = [(args, aux, {k: np.zeros_like(v)
                               for k, v in args.items()})]
        jouts = []
        for d, lab in batches:
            jm.forward(jmx.io.DataBatch([jmx.nd.array(d)],
                                        [jmx.nd.array(lab)]), is_train=True)
            jm.backward()
            jm.update()
            jouts.append(np.asarray(jm.get_outputs()[0].asnumpy(),
                                    np.float32))
            pa, px = jm.get_params()
            mom = {n: np.asarray(s[0], np.float32) for n, s in
                   pickle.loads(jm._fused.get_states())["state"].items()}
            states.append(({k: v.asnumpy() for k, v in pa.items()},
                           {k: v.asnumpy() for k, v in px.items()}, mom))
    a, b = _passes_on(tmx)
    with a, b:
        tm = tmx.mod.Module(ts, context="cpu")
        tm.bind(data_shapes=[("data", (BATCH, 3, 64, 64))],
                label_shapes=[("softmax_label", (BATCH,))])
        tm.init_params(arg_params=args, aux_params=aux)
        tm.init_optimizer(kvstore=None, optimizer="sgd",
                          optimizer_params=_opt(tmx))
        f = tm._fused
        ptrs = {n: p.data_ptr() for n, p in f._p.items()}
        for i, ((d, lab), (a0, x0, m0)) in enumerate(zip(batches, states)):
            tm.init_params(arg_params=a0, aux_params=x0, force_init=True)
            for n, (mom,) in f._state.items():
                mom.copy_(torch.from_numpy(m0[n]))
            tm.forward(tmx.io.DataBatch([torch.from_numpy(d)],
                                        [torch.from_numpy(lab)]),
                       is_train=True)
            tm.backward()
            tm.update()
            assert float(f._lr) == np.float32(LRS[i])
            pa, px = tm.get_params()
            want_a, want_x, want_m = states[i + 1]
            for n in want_a:
                upd = np.abs(want_a[n] - a0[n]).max()
                np.testing.assert_allclose(pa[n].numpy(), want_a[n], rtol=0,
                                           atol=1e-4 * upd + 1e-6,
                                           err_msg=f"step {i} param {n}")
                np.testing.assert_allclose(f._state[n][0].numpy(),
                                           want_m[n], rtol=0,
                                           atol=1e-4 * upd + 1e-6,
                                           err_msg=f"step {i} momentum {n}")
            for n in want_x:
                np.testing.assert_allclose(px[n].numpy(), want_x[n], rtol=0,
                                           atol=1e-5)
            p = jouts[i]
            loss = -np.log(p[np.arange(BATCH), lab.astype(int)]).sum()
            np.testing.assert_allclose(float(f.last_loss), loss, rtol=1e-5)
        assert {n: p.data_ptr() for n, p in f._p.items()} == ptrs


def test_set_params_after_start_keeps_master_storage():
    m = _cpu_module(momentum=0.9)
    f = m._fused
    m.forward(tmx.io.DataBatch([_feed(8)["data"]],
                               [_feed(8)["softmax_label"]]), is_train=True)
    m.update()
    ptrs = {n: p.data_ptr() for n, p in f._p.items()}
    moms = {n: s[0].data_ptr() for n, s in f._state.items()}
    lr_ptr = f._lr.data_ptr()
    new = {k: (v * 0 + i).astype(np.float32)
           for i, (k, v) in enumerate(_mlp_params(seed=3).items())}
    m.set_params(new, {})
    assert {n: p.data_ptr() for n, p in f._p.items()} == ptrs
    assert {n: s[0].data_ptr() for n, s in f._state.items()} == moms
    assert f._lr.data_ptr() == lr_ptr
    for n, v in new.items():
        np.testing.assert_array_equal(f._p[n].numpy(), v)
    args, _ = m.get_params()
    for n, v in new.items():
        np.testing.assert_array_equal(args[n].numpy(), v)


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
def test_compile_report_sections_and_cache_not_applicable():
    m = _cpu_module()
    m._fused.step(_feed(8))
    rep = tmx.compile_report()
    assert set(rep) == {"programs", "retraces", "totals", "cache"}
    (prog,) = rep["programs"]
    assert prog["name"] == "fused_step:softmax"
    assert prog["kind"] == "fused_step"
    assert (prog["captures"], prog["replays"]) == (0, 0)   # the CPU
    assert rep["totals"] == {"programs": 1, "fresh_compiles": 0,
                             "replays": 0, "capture_s": 0.0,
                             "retraces": 0}
    assert rep["cache"]["enabled"] is False
    assert rep["cache"]["reason"].startswith(
        "a CUDA graph cannot be serialized")
    assert tmx.compile_report(reset=True)["totals"]["programs"] == 1
    assert tmx.compile_report()["totals"]["programs"] == 0


def test_capture_tally_takes_the_capturing_streams_launches(monkeypatch):
    """Launches onto the stream being captured count into its tally,
    also from another thread (the autograd engine's); launches onto
    other streams during the capture count at once."""
    stream = threading.local()
    monkeypatch.setattr(tfb, "_stream_handle",
                        lambda device: getattr(stream, "handle", 0))
    tfb.reset_launch_counts()
    dev = torch.device("cpu")

    def on(handle, name, route=None):
        def run():
            stream.handle = handle
            tfb._count(name, dev, route)
        t = threading.Thread(target=run)
        t.start()
        t.join()

    stream.handle = 7
    with tfb.capture_tally(SimpleNamespace(cuda_stream=7)) as tally:
        tfb._count("bn_relu_conv_nchw", dev, "wgmma_tma")
        on(7, "bn_backward_dx")               # the engine's thread
        on(3, "bn_act_prologue")              # another caller
        tfb._count("bn_relu_conv_nchw", dev, "wgmma_tma")
    assert tally == {"bn_relu_conv_nchw": 2,
                     "bn_relu_conv_nchw/wgmma_tma": 2, "bn_backward_dx": 1}
    assert tfb.launch_counts() == {
        "bn_relu_conv_nchw": 0, "bn_act_prologue": 1,
        "bn_relu_matmul_fwd": 0, "bn_backward_reduce": 0,
        "bn_backward_dx": 0}
    tfb._count("bn_backward_dx", dev)         # the tally is gone
    tfb.add_counts(tally, 3)                    # three replays
    assert tfb.launch_counts()["bn_relu_conv_nchw"] == 6
    assert tfb.route_counts()["bn_relu_conv_nchw"]["wgmma_tma"] == 6
    assert tfb.launch_counts()["bn_backward_dx"] == 4
    tfb.reset_launch_counts()


def test_eager_update_is_update():
    """The profilers' eager arm runs ``update``'s schedule, lr writes and
    step counters."""
    a, b = (_cpu_module(momentum=0.9,
                        lr_scheduler=tmx.lr_scheduler.FactorScheduler(
                            step=1, factor=0.5)) for _ in range(2))
    for i in range(3):
        for m, eager in ((a, False), (b, True)):
            f = _feed(8, seed=i)
            m.forward(tmx.io.DataBatch([f["data"]], [f["softmax_label"]]),
                      is_train=True)
            m._update(eager)
        assert float(a._fused._lr) == float(b._fused._lr)
        assert a._optimizer.num_update == b._optimizer.num_update == i + 1
        assert torch.equal(a._fused.last_loss, b._fused.last_loss)
    assert float(b._fused._lr) == np.float32(0.1 * 0.5 ** 2)
    for n, p in a._fused._p.items():
        assert torch.equal(p, b._fused._p[n])


def test_fused_step_device_defaults_to_the_current_context():
    f = _cpu_module()._fused
    args = (f.symbol, f.data_names, f.label_names, f.param_names,
            f.aux_names, f.trainable, f.optimizer)
    with tmx.cpu():
        assert FusedSymbolStep(*args).device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError):
            FusedSymbolStep(*args)
