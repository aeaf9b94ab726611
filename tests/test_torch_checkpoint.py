"""The port's ``CheckpointManager``, ``Module`` checkpoints and
``fit(auto_resume=True)`` (``mxnet_tpu_torch.checkpoint``,
``module/``), on the CPU, driven by the deterministic fault-injection
harness (``mxnet_tpu_torch.faultinject``).

- The 13 cases of ``tests/test_checkpoint_manager.py`` on the port:
  atomic writes, CRC fallback, retention, async save and its errors,
  resume equal to an uninterrupted run (bit for bit: the CPU step is
  deterministic), the RNG snapshot, stale payloads, the harness itself.
- Across the packages, both ways: ``save_checkpoint(...,
  save_optimizer_states=True)`` + ``Module.load``, and
  ``CheckpointManager.save_module`` + ``restore``, each followed by one
  more step in both packages; params within 1e-6 + 1e-5 relative (fp32
  sums in another order).
- ``fit(auto_resume=True)`` after an injected ``ckpt_write`` failure
  at the third epoch's save matches an uninterrupted run, bit for bit.
"""
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.checkpoint import CheckpointManager as JaxManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import faultinject, nd
from mxnet_tpu_torch.checkpoint import CheckpointManager

pytestmark = pytest.mark.chaos

OPT = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.fixture(autouse=True)
def _reset_faults():
    faultinject.reset()
    yield
    faultinject.reset()


def _mlp(pkg=tmx, tag=""):
    data = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(pkg.sym.Flatten(data), num_hidden=16,
                               name=f"fc1{tag}")
    h = pkg.sym.Activation(h, act_type="relu")
    h = pkg.sym.FullyConnected(h, num_hidden=4, name=f"fc2{tag}")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _data(n_batches=4, batch=16):
    rng = np.random.RandomState(42)
    x = rng.rand(n_batches * batch, 1, 6, 6).astype(np.float32)
    w = rng.rand(36, 4).astype(np.float32)
    y = np.argmax(x.reshape(len(x), -1) @ w, axis=1).astype(np.float32)
    return x, y


def _iter(pkg=tmx):
    x, y = _data()
    return pkg.io.NDArrayIter(x, y, batch_size=16,
                              label_name="softmax_label")


def _module(tag=""):
    return tmx.mod.Module(symbol=_mlp(tmx, tag), context="cpu")


def _fit(mod, mgr=None, num_epoch=2, auto_resume=False):
    mod.fit(_iter(), num_epoch=num_epoch, optimizer="sgd",
            optimizer_params=dict(OPT), initializer=tmx.init.Xavier(),
            checkpoint_manager=mgr, auto_resume=auto_resume)


def _bound(tag=""):
    mod = _module(tag)
    mod.bind(data_shapes=[("data", (16, 1, 6, 6))],
             label_shapes=[("softmax_label", (16,))])
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    return mod


def _args(mod):
    return {k: v.numpy().copy() for k, v in mod.get_params()[0].items()}


# -- atomic writes -----------------------------------------------------------

def test_injected_write_failure_leaves_previous_file(tmp_path):
    """A failure at byte N of ``nd.save`` leaves the old file intact and
    no temp file: the rename is the commit point."""
    p = str(tmp_path / "w.params")
    nd.save(p, {"w": torch.ones(4, 4)})
    before = open(p, "rb").read()
    with faultinject.inject("ckpt_write:byte=16"):
        with pytest.raises(faultinject.FaultInjected):
            nd.save(p, {"w": torch.zeros(4, 4)})
    assert open(p, "rb").read() == before
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_atomic_write_covers_every_checkpoint_surface(tmp_path):
    """``Symbol.save``, the npz ``nd.save`` and
    ``save_optimizer_states`` all take the temp + fsync + rename path."""
    sp = str(tmp_path / "m-symbol.json")
    _mlp(tmx, "a").save(sp)
    before = open(sp).read()
    with faultinject.inject("ckpt_write:byte=4"):
        with pytest.raises(faultinject.FaultInjected):
            _mlp(tmx, "a").save(sp)
    assert open(sp).read() == before

    npz = str(tmp_path / "x.nd")
    nd.save(npz, [torch.ones(2)])
    before = open(npz, "rb").read()
    with faultinject.inject("ckpt_write:byte=4"):
        with pytest.raises(faultinject.FaultInjected):
            nd.save(npz, [torch.zeros(2)])
    assert open(npz, "rb").read() == before

    mod = _bound("a")
    st = str(tmp_path / "m.states")
    mod.save_optimizer_states(st)
    before = open(st, "rb").read()
    with faultinject.inject("ckpt_write:byte=4"):
        with pytest.raises(faultinject.FaultInjected):
            mod.save_optimizer_states(st)
    assert open(st, "rb").read() == before


# -- manifest validation / fallback ------------------------------------------

def test_corrupt_newest_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    _fit(_module("b"), mgr, num_epoch=3)
    assert mgr.load_latest().epoch == 3
    tmx.fault_report(reset=True)
    # truncate the newest params payload: CRC mismatch -> fall back
    with open(os.path.join(mgr._dir_for(3), "params.params"), "rb+") as f:
        f.truncate(20)
    st = mgr.load_latest()
    assert st is not None and st.epoch == 2
    assert tmx.fault_report()["checkpoint"]["corrupt_detected"] >= 1
    assert mgr.load(2).epoch == 2
    with pytest.raises(tmx.MXNetError, match="missing or corrupt"):
        mgr.load(3)
    # one byte flipped mid-file (same size): the CRC still catches it
    p2 = os.path.join(mgr._dir_for(2), "params.params")
    blob = bytearray(open(p2, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(p2, "wb") as f:
        f.write(bytes(blob))
    st = mgr.load_latest()
    assert st is not None and st.epoch == 1


def test_missing_manifest_means_invalid(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    _fit(_module("c"), mgr, num_epoch=2)
    os.unlink(os.path.join(mgr._dir_for(2), "MANIFEST.json"))
    st = mgr.load_latest()
    assert st is not None and st.epoch == 1


def test_truncate_site_is_caught_by_crc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mod = _module("d")
    _fit(mod, mgr, num_epoch=1)
    with faultinject.inject("ckpt_truncate:bytes=64:match=params.params"):
        mgr.save_module(mod, 2)
    assert not mgr.validate(mgr._dir_for(2))
    assert mgr.load_latest().epoch == 1


# -- retention / async -------------------------------------------------------

def test_retention_keeps_newest_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    _fit(_module("e"), mgr, num_epoch=5)
    assert mgr._tags() == [5, 4]


def test_async_save_and_error_surfacing(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mod = _bound("f")
    mgr.save_module(mod, 1)
    mgr.wait()
    assert mgr.load_latest().epoch == 1
    with faultinject.inject("ckpt_write:byte=8:match=params.params"):
        mgr.save_module(mod, 2)
        with pytest.raises(faultinject.FaultInjected):
            mgr.wait()
    assert mgr.load_latest().epoch == 1   # the torn save never became valid


# -- full state round trip ----------------------------------------------------

def test_auto_resume_matches_uninterrupted_run(tmp_path):
    """Resuming after epoch 2 lands on the params of a run that never
    stopped: params, momenta and the data cursor round trip."""
    torch.manual_seed(7)
    ref = _module("g")
    _fit(ref, None, num_epoch=4)
    torch.manual_seed(7)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    _fit(_module("g"), mgr, num_epoch=2)       # "stops" after epoch 2
    m2 = _module("g")
    _fit(m2, mgr, num_epoch=4, auto_resume=True)
    want, got = _args(ref), _args(m2)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    assert m2._fused.num_update == ref._fused.num_update == 16


def test_resume_skips_completed_epochs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    m1 = _module("h")
    _fit(m1, mgr, num_epoch=3)
    m2 = _module("h")
    _fit(m2, mgr, num_epoch=3, auto_resume=True)   # no epoch retrained
    a1, a2 = _args(m1), _args(m2)
    for k in a1:
        np.testing.assert_array_equal(a1[k], a2[k])
    assert m2._fused.num_update == 12


def test_rng_state_round_trips():
    tmx.random.seed(123)
    g = tmx.random.generator("cpu")
    torch.rand(3, generator=g)
    snap = tmx.random.get_state()
    assert all(isinstance(v, np.ndarray)
               for v in snap["generators"].values())
    expect = torch.rand(4, generator=g)
    tmx.random.set_state(snap)
    np.testing.assert_array_equal(torch.rand(4, generator=g).numpy(),
                                  expect.numpy())


def test_tag_resave_drops_stale_payload_files(tmp_path):
    """Re-saving a tag with fewer payload files removes the earlier
    save's leftovers, and the loader reads only the listed files."""
    mod = _bound("i")
    CheckpointManager(str(tmp_path)).save_module(mod, 1)
    opt_path = os.path.join(str(tmp_path), "ckpt-000001",
                            "optimizer.states")
    assert os.path.exists(opt_path)
    mgr2 = CheckpointManager(str(tmp_path), save_optimizer_states=False)
    mgr2.save_module(mod, 1)
    assert not os.path.exists(opt_path)
    assert mgr2.load_latest().opt_states is None


# -- harness unit -------------------------------------------------------------

def test_spec_parsing_and_ordinals():
    spec = faultinject.parse_spec(
        "ckpt_write:byte=100:action=kill:match=params.params;"
        "nan_grad:step=3;data_iter:call=2:times=1")
    assert spec["ckpt_write"] == {"byte": 100, "action": "kill",
                                  "match": "params.params"}
    assert spec["nan_grad"] == {"step": 3}
    with faultinject.inject("data_iter:call=2:times=1"):
        assert not faultinject.fire("data_iter")   # call 1
        assert faultinject.fire("data_iter")       # call 2 -> fires
        assert not faultinject.fire("data_iter")   # times exhausted
    assert faultinject.active("data_iter") is None  # scope popped


def test_data_iter_site():
    it = _iter()
    with faultinject.inject("data_iter:batch=2"):
        batches = []
        with pytest.raises(faultinject.FaultInjected):
            for b in it:
                batches.append(b)
        assert len(batches) == 1


# -- across the packages -------------------------------------------------------

def _jax_bound(tag):
    mod = jmx.mod.Module(symbol=_mlp(jmx, tag), context=jmx.cpu())
    mod.bind(data_shapes=[("data", (16, 1, 6, 6))],
             label_shapes=[("softmax_label", (16,))])
    return mod


def _batches():
    x, y = _data()
    return [(x[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16])
            for i in range(4)]


def _step_both(tmod, jmod, x, y):
    tmod.forward(tmx.io.DataBatch([torch.from_numpy(x)],
                                  [torch.from_numpy(y)]), is_train=True)
    tmod.backward()
    tmod.update()
    jmod.forward(jmx.io.DataBatch([jmx.nd.array(x)], [jmx.nd.array(y)]),
                 is_train=True)
    jmod.backward()
    jmod.update()


def _close(tmod, jmod):
    want = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    got = _args(tmod)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _train(mod, batches, pkg):
    for x, y in batches:
        arr = torch.from_numpy if pkg is tmx else jmx.nd.array
        mod.forward(pkg.io.DataBatch([arr(x)], [arr(y)]), is_train=True)
        mod.backward()
        mod.update()


def test_module_checkpoint_port_to_jax(tmp_path):
    b = _batches()
    tmod = _bound("x")
    _train(tmod, b[:2], tmx)
    prefix = str(tmp_path / "t")
    tmod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    jmod = jmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                               context=jmx.cpu())
    jmod.bind(data_shapes=[("data", (16, 1, 6, 6))],
              label_shapes=[("softmax_label", (16,))])
    jmod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    assert jmod._fused.num_update == 2
    _step_both(tmod, jmod, *b[2])
    _close(tmod, jmod)


def test_module_checkpoint_jax_to_port(tmp_path):
    b = _batches()
    jmod = _jax_bound("y")
    jmod.init_params(jmx.init.Xavier())
    jmod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    _train(jmod, b[:2], jmx)
    prefix = str(tmp_path / "j")
    jmod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    tmod = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                               context="cpu")
    tmod.bind(data_shapes=[("data", (16, 1, 6, 6))],
              label_shapes=[("softmax_label", (16,))])
    tmod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    assert tmod._fused.num_update == 2
    _step_both(tmod, jmod, *b[2])
    _close(tmod, jmod)


def test_checkpoint_manager_port_to_jax(tmp_path):
    b = _batches()
    tmod = _bound("z")
    _train(tmod, b[:3], tmx)
    CheckpointManager(str(tmp_path)).save_module(tmod, 1, nbatch=3)
    jmod = _jax_bound("z")
    jmod.init_params(jmx.init.Xavier())
    jmod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    st = JaxManager(str(tmp_path)).restore(jmod)
    assert (st.epoch, st.nbatch, st.num_update) == (1, 3, 3)
    _step_both(tmod, jmod, *b[3])
    _close(tmod, jmod)


def test_checkpoint_manager_jax_to_port(tmp_path, caplog):
    b = _batches()
    jmod = _jax_bound("w")
    jmod.init_params(jmx.init.Xavier())
    jmod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    _train(jmod, b[:3], jmx)
    JaxManager(str(tmp_path)).save_module(jmod, 1, nbatch=3)
    tmod = _bound("w")
    with caplog.at_level(logging.WARNING):
        st = CheckpointManager(str(tmp_path)).restore(tmod)
    assert (st.epoch, st.nbatch) == (1, 3)
    assert tmod._fused.num_update == 3
    assert sum("RNG stream was not restored" in r.getMessage()
               for r in caplog.records) == 1
    _step_both(tmod, jmod, *b[3])
    _close(tmod, jmod)


def test_fit_auto_resume_after_injected_write_failure(tmp_path):
    """The third epoch's checkpoint dies at byte 64 of its params file
    (``fit`` raises there, as a crashed job stops); ``fit(auto_resume=
    True)`` falls back to epoch 2 and ends on the uninterrupted run's
    params."""
    torch.manual_seed(11)
    ref = _module("r")
    _fit(ref, None, num_epoch=4)
    torch.manual_seed(11)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    with faultinject.inject(
            "ckpt_write:byte=64:match=params.params:call=3"):
        with pytest.raises(faultinject.FaultInjected):
            _fit(_module("r"), mgr, num_epoch=4)
    assert mgr.load_latest().epoch == 2
    m2 = _module("r")
    _fit(m2, mgr, num_epoch=4, auto_resume=True)
    want, got = _args(ref), _args(m2)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    assert mgr._tags()[0] == 4


def test_epoch_end_callbacks_write_loadable_checkpoints(tmp_path, caplog):
    """``do_checkpoint`` and ``module_checkpoint`` write files the JAX
    package loads; ``log_train_metric``, ``ProgressBar`` and
    ``LogValidationMetricsCallback`` read the metric."""
    mod = _module("k")
    dp, mp = str(tmp_path / "do"), str(tmp_path / "mod")
    with caplog.at_level(logging.INFO):
        mod.fit(_iter(), eval_data=_iter(), num_epoch=2, optimizer="sgd",
                optimizer_params=dict(OPT), initializer=tmx.init.Xavier(),
                epoch_end_callback=[
                    tmx.callback.do_checkpoint(dp, period=2),
                    tmx.callback.module_checkpoint(
                        mod, mp, save_optimizer_states=True)],
                batch_end_callback=[tmx.callback.log_train_metric(2),
                                    tmx.callback.ProgressBar(4)],
                eval_end_callback=tmx.callback.LogValidationMetricsCallback())
    messages = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Iter[1] Batch[2] Train-accuracy=")
               for m in messages)
    assert any(m.startswith("Epoch[1] Validation-accuracy=")
               for m in messages)
    assert not os.path.exists(f"{dp}-0001.params")       # period 2
    want = _args(mod)
    for prefix, epoch in ((dp, 2), (mp, 1), (mp, 2)):
        _, args, _ = jmx.model.load_checkpoint(prefix, epoch)
        if epoch == 2:
            for k, v in want.items():
                np.testing.assert_array_equal(args[k].asnumpy(), v)
    assert os.path.exists(f"{mp}-0002.states")
