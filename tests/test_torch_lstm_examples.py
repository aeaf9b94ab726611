"""The port's LSTM language-model examples on the CPU.

- ``examples/word_language_model/train.py`` (the eager Gluon loop:
  ``autograd.record``, detached hidden state, ``clip_global_norm``,
  ``Trainer``) for a few batches at a tiny size: finite perplexities and
  the per-epoch statistics; ``model.RNNModel`` in every mode, tied
  weights included.
- ``examples/rnn/lstm_bucketing.py`` with the JAX test's arguments
  (``tests/test_bucketing_lm.py``: 2 epochs, batch 16, 64 / 64) lowers
  the Train-perplexity under the JAX test's bar: the last below 170 and
  at most the first (the synthetic corpus has 201 tokens: chance is
  about 201).
- ``examples/word_language_model/bench_lstm.py``'s model and TrainStep
  at a tiny size: the loss falls over a few steps.

Run as a script, ``PYTHONPATH=. JAX_PLATFORMS=cpu
python tests/test_torch_lstm_examples.py`` runs the JAX package's own
``examples/word_language_model/train.py --epochs 1`` at its defaults and
prints one JSON line with the validation perplexity it reports and the
seconds it took: ``chip_smoke.py``'s ``WLM_JAX_VAL_PPL``.
"""
import contextlib
import io
import json
import logging
import math
import os
import random
import re
import runpy
import sys
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples.rnn import lstm_bucketing
from mxnet_tpu_torch.examples.word_language_model import bench_lstm, train
from mxnet_tpu_torch.examples.word_language_model.model import RNNModel
from torch_threads import one_torch_thread  # noqa: F401


def test_word_lm_train_runs_a_few_batches():
    mt.random.seed(0)
    stats = train.main(["--device", "cpu", "--epochs", "2",
                        "--max-batches", "3", "--corpus", "4000",
                        "--vocab", "40", "--emsize", "16", "--nhid", "16",
                        "--bptt", "10", "--batch_size", "8"])
    assert stats["batches"] == [3, 3]
    assert all(math.isfinite(v) and 1 < v < 60 for v in stats["val_ppl"])
    assert all(v > 0 for v in stats["tokens_per_s"])


@pytest.mark.parametrize("mode,tied", [("lstm", False), ("gru", False),
                                       ("rnn_tanh", False),
                                       ("rnn_relu", False), ("lstm", True)])
def test_rnn_model_modes(mode, tied):
    with mt.cpu():
        model = RNNModel(mode, 20, 8, 8, 2, dropout=0.1, tie_weights=tied)
        model.initialize(mt.init.Xavier())
        hidden = model.begin_state(batch_size=3)
        x = mt.nd.array(np.random.RandomState(0).randint(0, 20, (5, 3)))
        with mt.autograd.record():
            out, hidden = model(x, hidden)
        assert out.shape == (15, 20)
        assert len(hidden) == (2 if mode == "lstm" else 1)
    names = model.collect_params().keys()
    assert any(n.endswith("l1_h2h_weight") for n in names)


def test_lstm_bucketing_converges():
    class Capture(logging.Handler):
        def __init__(self):
            super().__init__()
            self.ppl = []

        def emit(self, record):
            msg = record.getMessage()
            if "Train-perplexity" in msg:
                self.ppl.append(float(msg.split("=")[-1]))

    cap = Capture()
    root = logging.getLogger()
    prev = root.level
    root.addHandler(cap)
    root.setLevel(logging.INFO)
    # the example draws its init and shuffles from the ambient RNGs: pin
    # them, as the JAX test does
    mt.random.seed(0)
    np.random.seed(0)
    random.seed(0)
    try:
        lstm_bucketing.main(["--num-epochs", "2", "--batch-size", "16",
                             "--num-hidden", "64", "--num-embed", "64",
                             "--device", "cpu"])
    finally:
        root.removeHandler(cap)
        root.setLevel(prev)
    assert cap.ppl, "no perplexity logged"
    assert cap.ppl[-1] < 170, cap.ppl
    assert cap.ppl[-1] <= cap.ppl[0], cap.ppl


def test_bench_lstm_model_trains_at_tiny_size():
    net, step = bench_lstm.build("cpu", vocab=40, emsize=8, nhid=8)
    xs, ys = bench_lstm.batches(4, 6, n=2, vocab=40)
    losses = [float(step(xs[i % 2], ys[i % 2]).asnumpy()) for i in range(6)]
    assert all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    assert step.compute_dtype is not None and step.num_update == 6


def jax_word_lm_reference():
    """The JAX package's ``train.py --epochs 1``: (val ppl, seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    example = os.path.join(here, "..", "examples", "word_language_model")
    sys.path.insert(0, os.path.abspath(os.path.join(here, "..")))
    sys.path.insert(0, os.path.abspath(example))
    argv, sys.argv = sys.argv, ["train.py", "--epochs", "1"]
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(example, "train.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    val = re.findall(r"val ppl ([0-9.]+)", out.getvalue())
    return float(val[-1]), time.perf_counter() - t0


if __name__ == "__main__":
    ppl, secs = jax_word_lm_reference()
    print(json.dumps({"val_ppl": ppl, "seconds": secs}))
