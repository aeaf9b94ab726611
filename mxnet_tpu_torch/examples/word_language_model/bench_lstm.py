"""Gluon LSTM language-model training throughput (tokens/s) through the
port's ``TrainStep`` (the counterpart of
``examples/word_language_model/bench_lstm.py``).

Model: the medium LM (wikitext-2's vocabulary of 33,278, a 650-wide
embedding, a 2 x 650 LSTM and a decoder to the vocabulary), truncated
BPTT with a zero initial state each step. The whole step (embedding,
the LSTM on the L1 kernel, decoder, softmax cross entropy, backward, SGD
with momentum) is one captured CUDA graph, bf16 compute over fp32
master weights.

Usage: python -m mxnet_tpu_torch.examples.word_language_model.bench_lstm
       [batch] [bptt] [--device cpu]
Prints one JSON line: {"metric": "lstm_lm_train_tokens_per_sec", ...}
"""
import argparse
import json
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import HybridBlock, nn, rnn
from mxnet_tpu_torch.parallel import TrainStep

VOCAB = 33278      # wikitext-2
EMSIZE = 650
NHID = 650
NLAYERS = 2


class LMModel(HybridBlock):
    def __init__(self, vocab=VOCAB, emsize=EMSIZE, nhid=NHID,
                 nlayers=NLAYERS, **kwargs):
        super().__init__(**kwargs)
        self._vocab = vocab
        with self.name_scope():
            self.embed = nn.Embedding(vocab, emsize)
            self.lstm = rnn.LSTM(nhid, num_layers=nlayers, layout="NTC")
            self.decoder = nn.Dense(vocab, flatten=False)

    def hybrid_forward(self, F, x):
        h = self.lstm(self.embed(x))
        out = self.decoder(h)                     # (B, T, V)
        return out.reshape((-1, self._vocab))     # (B*T, V)


def build(device, seed=0, **widths):
    """The model (Xavier init from ``seed``) and its TrainStep: SGD
    momentum 0.9, lr 0.1, bf16 over fp32 masters."""
    mx.random.seed(seed)
    net = LMModel(**widths)
    net.initialize(mx.init.Xavier(), ctx=mx.context.as_context(device))
    step = TrainStep(net, loss="softmax_ce", optimizer="sgd",
                     optimizer_params={"momentum": 0.9}, lr=0.1,
                     compute_dtype="bfloat16")
    return net, step


def batches(batch, bptt, n=4, vocab=VOCAB, seed=0):
    rng = np.random.RandomState(seed)
    xs = [mx.nd.array(rng.randint(0, vocab, (batch, bptt)), ctx=mx.cpu(),
                      dtype="int32") for _ in range(n)]
    ys = [mx.nd.array(rng.randint(0, vocab, (batch * bptt,)), ctx=mx.cpu(),
                      dtype="int32") for _ in range(n)]
    return xs, ys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", type=int, nargs="?", default=512)
    ap.add_argument("bptt", type=int, nargs="?", default=35)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", type=str, default="cuda:0")
    args = ap.parse_args(argv)
    _, step = build(args.device)
    xs, ys = batches(args.batch, args.bptt)
    loss = None
    for i in range(3):                     # eager, capture, replay
        loss = step(xs[i % 4], ys[i % 4])
    float(loss.asnumpy())
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(args.steps):
            loss = step(xs[i % 4], ys[i % 4])
        loss.wait_to_read()
        best = min(best, time.perf_counter() - t0)
    out = {"metric": "lstm_lm_train_tokens_per_sec",
           "value": args.batch * args.bptt * args.steps / best,
           "unit": "tokens/sec", "batch": args.batch, "bptt": args.bptt,
           "vocab": VOCAB, "emsize": EMSIZE, "nhid": NHID,
           "nlayers": NLAYERS, "step_time_s": best / args.steps,
           "device": str(loss.data.device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
