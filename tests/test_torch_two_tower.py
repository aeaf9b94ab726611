"""The port's two-tower recommender (``examples/sparse/two_tower.py``) on
the CPU.

- ``--mini --device cpu`` end to end: ``fit`` over a ``DataPipeline``
  with a ``CheckpointManager`` (both towers routed row-sparse),
  ``sparse_report()``, and ``Predictor`` / ``DynamicBatcher`` on int32
  ids (the example holds the two against each other within 1e-5).
- ``Predictor`` on int32 ids against the JAX package's ``Predictor``
  with the same weights: probabilities within 1e-6 (float32 MLP sums in
  another order; measured ~1e-8).
- The ``sparse_update`` fault with a raise in epoch 2, then
  ``fit(auto_resume=True)``: the final tables, the other weights and
  the lazy Adam moments are bit for bit those of an uninterrupted run.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples.sparse import two_tower as tt
from torch_threads import one_torch_thread  # noqa: F401

MINI = dict(n_users=40, n_items=24, embed_dim=4, hidden=8, num_rows=256,
            batch_size=32, pipeline_workers=1, quiet=True, device="cpu")
PROB_TOL = 1e-6


def test_mini_example_end_to_end(tmp_path):
    tmx.sparse.sparse_report(reset=True)
    res = tt.main(["--mini", "--device", "cpu", "--workdir", str(tmp_path)])
    assert 0.0 <= res["acc"] <= 1.0
    assert res["scores"].shape == (16, 2)
    np.testing.assert_allclose(res["scores"].sum(axis=1), 1.0, atol=1e-5)
    rep = res["sparse"]
    assert rep["sites"] == 2 and rep["steps"] == 8
    assert rep["ids_total"] == 8 * 64
    assert 0 < rep["dedup_ratio"] <= 1
    f = res["module"]._fused
    assert sorted(f._routed) == ["item_emb_weight", "user_emb_weight"]


def test_predictor_on_int_ids_matches_the_jax_package(tmp_path):
    mod, _ = tt.train(str(tmp_path), num_epoch=1, **MINI)
    args, aux = mod.get_params()
    sym_json = mod.symbol.tojson()
    rng = np.random.RandomState(3)
    req = {"user": rng.randint(0, 40, size=(13, 1)).astype(np.int32),
           "item": rng.randint(0, 24, size=(13, 1)).astype(np.int32)}
    tpred = tmx.serving.Predictor(
        mod.symbol, args, aux, data_names=("user", "item"),
        data_shapes={"user": (1,), "item": (1,)}, buckets=(8, 32),
        device="cpu")
    jpred = jmx.serving.Predictor(
        jmx.sym.load_json(sym_json),
        {n: jmx.nd.array(v.numpy()) for n, v in args.items()}, {},
        data_names=("user", "item"),
        data_shapes={"user": (1,), "item": (1,)}, buckets=(8, 32))
    got, want = tpred.predict(req), jpred.predict(req)
    assert got.shape == want.shape == (13, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
    # the module's own eval forward on the same ids
    mod.forward(tmx.io.DataBatch(data=[torch.from_numpy(req["user"]),
                                       torch.from_numpy(req["item"])]),
                is_train=False)
    np.testing.assert_allclose(got, mod.get_outputs()[0].asnumpy(), rtol=0,
                               atol=PROB_TOL)


def _state(mod):
    f = mod._fused
    args, _ = mod.get_params()
    out = {n: v.numpy().copy() for n, v in args.items()}
    for n, leaves in f.states_snapshot()["state"].items():
        for i, x in enumerate(leaves):
            out[f"{n}/state{i}"] = np.array(x)
    out["t"] = np.array(int(f._t))
    return out


def test_sparse_update_raise_then_resume_is_bit_for_bit(tmp_path):
    # Xavier draws from torch's global generator: both runs start alike
    torch.manual_seed(0)
    ref, _ = tt.train(str(tmp_path / "ref"), num_epoch=3, **MINI)
    want = _state(ref)
    run = str(tmp_path / "run")
    torch.manual_seed(0)
    # 8 steps an epoch: step 12 is in the middle of the second epoch
    with tmx.faultinject.inject("sparse_update:step=12"):
        with pytest.raises(tmx.faultinject.FaultInjected,
                           match="sparse_update"):
            tt.train(run, num_epoch=3, **MINI)
    torch.manual_seed(1)     # the resumed run's init is overwritten
    resumed, _ = tt.train(run, num_epoch=3, **MINI)
    got = _state(resumed)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert int(got["t"]) == 24
