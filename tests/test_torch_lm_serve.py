"""Serving what the port trained: ``DecodePredictor.from_module``,
``distill_draft`` and the ``tiny_lm`` example, on the CPU.

- A ``DecodePredictor`` stages its own copy of every parameter: writing
  into each tensor of the dict it was built from changes none of its
  streams (before, it aliased the caller's fp32 tensors).
- ``from_module`` on a Module trained by the JAX package's fit (its
  weights carried over with ``interop.params_from_jax``) streams the
  JAX package's ``DecodePredictor.from_module`` token for token; it runs
  on the Module's device, and more training of the Module leaves its
  streams unchanged.
- ``distill_draft``: the rollout windows it trains on equal the JAX
  package's, array for array, on the same target weights. The draft's
  Xavier draw differs by design, so its training is held to next-token
  accuracy on those windows well above chance (at least 0.3 against
  chance 1/64; measured 0.65).
- ``python -m mxnet_tpu_torch.examples.transformer.tiny_lm --mini
  --device cpu``, as ``tests/test_decode.py`` runs the JAX package's:
  accuracy above 0.2, 8 characters a prompt, three programs (two
  prefill buckets and the decode step), and a second run on the same
  workdir resumes from the checkpoint (no new one written) and streams
  the same text.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.serving.decode import model as jmodel
from mxnet_tpu.serving.decode import DecodePredictor as JaxDecodePredictor
from mxnet_tpu.serving.decode import spec as jspec_mod

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.serving.decode import (
    DecodePredictor, distill_draft, make_draft_spec)
from mxnet_tpu_torch.serving.decode import model as tmodel

from torch_decode_helpers import SMALL, make_prompts, small_spec

pytestmark = pytest.mark.serving

SEQ = 16
DRAFT_ACC_MIN = 0.3


def _streams(pred, prompts, n=10):
    return [list(pred.generate(p, max_new_tokens=n)) for p in prompts]


def test_predictor_owns_its_parameters():
    spec = small_spec("owned")
    params = {k: torch.from_numpy(v.copy())
              for k, v in tmodel.init_params(spec, seed=0).items()}
    pred = DecodePredictor(spec, params, slots=2, seq_buckets=(8, 16),
                           device="cpu")
    prompts = make_prompts(3)
    first = _streams(pred, prompts)
    with torch.no_grad():
        for i, v in enumerate(params.values()):
            v.mul_(-1.5).add_(0.01 * (i + 1))
    assert _streams(pred, prompts) == first
    rebuilt = DecodePredictor(spec, params, slots=2, seq_buckets=(8, 16),
                              device="cpu")
    assert _streams(rebuilt, prompts) != first


def _windows(n_rows, vocab):
    rng = np.random.RandomState(3)
    ids = rng.randint(0, vocab, 4 * n_rows + SEQ + 1)
    ids[::3] = ids[1::3][:len(ids[::3])]       # some structure to learn
    data = np.stack([ids[i:i + SEQ] for i in range(n_rows)])
    label = np.stack([ids[i + 1:i + SEQ + 1] for i in range(n_rows)])
    return data.astype(np.float32), label.astype(np.float32)


def test_from_module_streams_match_the_jax_package():
    kw = dict(SMALL, max_seq=32)
    jspec = jmodel.TransformerLMSpec(**kw, name="fm")
    tspec = tmodel.TransformerLMSpec(**kw, name="fm")
    data, label = _windows(64, kw["vocab_size"])
    jm = jmx.mod.Module(jmodel.build_symbol(jspec, SEQ),
                        data_names=("data",),
                        label_names=("softmax_label",), context=jmx.cpu())
    jm.fit(jmx.io.NDArrayIter(data, label, 16), num_epoch=1,
           optimizer="adam", optimizer_params={"learning_rate": 3e-3},
           initializer=jmx.init.Xavier(),
           eval_metric=jmx.metric.Accuracy(axis=2))
    trained = {k: v.asnumpy() for k, v in jm.get_params()[0].items()}

    tm = tmx.mod.Module(tmodel.build_symbol(tspec, SEQ),
                        data_names=("data",),
                        label_names=("softmax_label",), context="cpu")
    it = tmx.io.NDArrayIter(data, label, 16)
    tm.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    arg, aux = tmx.interop.params_from_jax(trained, {}, "cpu")
    tm.init_params(arg_params=arg, aux_params=aux)

    jp = JaxDecodePredictor.from_module(jm, jspec, slots=4,
                                        seq_buckets=(16, 32))
    tp = DecodePredictor.from_module(tm, tspec, slots=4,
                                     seq_buckets=(16, 32))
    assert tp.device == torch.device("cpu")
    prompts = make_prompts(5, vocab=kw["vocab_size"])
    want = _streams(jp, prompts, 12)
    assert _streams(tp, prompts, 12) == want

    # train on: the predictor keeps the weights it was built from
    tm.init_optimizer(optimizer="adam",
                      optimizer_params={"learning_rate": 3e-2})
    it.reset()
    for batch in it:
        tm.forward_backward(batch)
        tm.update()
    moved = DecodePredictor.from_module(tm, tspec, slots=4,
                                        seq_buckets=(16, 32))
    assert _streams(tp, prompts, 12) == want
    assert _streams(moved, prompts, 12) != want


class _Recorder:
    """Wraps an NDArrayIter class and keeps each call's data and label."""

    def __init__(self, cls):
        self.cls, self.calls = cls, []

    def __call__(self, data, label=None, *a, **k):
        self.calls.append((np.array(data), np.array(label)))
        return self.cls(data, label, *a, **k)


def test_distill_draft_windows_match_and_the_draft_learns(monkeypatch):
    jspec = jmodel.TransformerLMSpec(**SMALL, name="dt")
    tspec = small_spec("dt")
    weights = jmodel.init_params(jspec, seed=0)
    jt = JaxDecodePredictor(jspec, weights, slots=2, seq_buckets=(16, 64))
    tt = DecodePredictor(tspec, tmx.interop.decode_params_from_jax(
        weights, tspec, "cpu"), slots=2, seq_buckets=(16, 64),
        device="cpu")
    jrec = _Recorder(jmx.io.NDArrayIter)
    trec = _Recorder(tmx.io.NDArrayIter)
    monkeypatch.setattr(jmx.io, "NDArrayIter", jrec)
    monkeypatch.setattr(tmx.io, "NDArrayIter", trec)
    jspec_mod.distill_draft(jt, jspec_mod.make_draft_spec(jspec, 1, 2),
                            num_epoch=1)
    dspec = make_draft_spec(tspec, 1, 2)
    dparams = distill_draft(tt, dspec)
    assert len(jrec.calls) == len(trec.calls) == 1
    (jd, jl), (td, tl) = jrec.calls[0], trec.calls[0]
    assert td.dtype == jd.dtype and tl.dtype == jl.dtype
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tl, jl)

    assert sorted(dparams) == sorted(dspec.param_shapes())
    assert all(v.device == tt.device for v in dparams.values())
    mod = tmx.mod.Module(tmodel.build_symbol(dspec, td.shape[1]),
                         data_names=("data",),
                         label_names=("softmax_label",), context="cpu")
    it = trec.cls(td, tl, 16)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False)
    mod.init_params(arg_params=dparams, aux_params={})
    acc = mod.score(it, tmx.metric.Accuracy(axis=2))[0][1]
    assert acc >= DRAFT_ACC_MIN > 1.0 / SMALL["vocab_size"]


def _ckpt_files(workdir):
    root = os.path.join(workdir, "ckpt")
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, fs in os.walk(root) for f in fs}


def test_tiny_lm_example_mini(tmp_path):
    from mxnet_tpu_torch.examples.transformer import tiny_lm
    argv = ["--mini", "--device", "cpu", "--workdir", str(tmp_path)]
    out = tiny_lm.main(argv)
    assert out["acc"] > 0.2
    assert all(len(t) == 8 for t in out["texts"].values())
    assert out["report"]["retraces"] == 3
    saved = _ckpt_files(str(tmp_path))
    assert saved
    out2 = tiny_lm.main(argv)
    assert _ckpt_files(str(tmp_path)) == saved
    assert out2["texts"] == out["texts"]
