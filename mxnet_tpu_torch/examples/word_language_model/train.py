"""Train an RNN language model with the eager Gluon loop (the port's
counterpart of ``examples/word_language_model/train.py``; reference:
example/gluon/word_language_model/train.py).

Each batch runs ``model(data, hidden)`` under ``autograd.record()``
with the hidden state detached from the previous batch, the softmax
cross entropy, ``backward``, ``clip_global_norm`` over every gradient
and ``Trainer.step`` (SGD). The LSTM's steps run L1 on the card.

With no dataset (``--data``) a Markov-chain corpus is generated, the
JAX example's for the same arguments. Everything runs on ``--device``
(``cuda:0`` by default, ``cpu`` for a run without a card).

Run: python -m mxnet_tpu_torch.examples.word_language_model.train
     python -m mxnet_tpu_torch.examples.word_language_model.train \\
         --device cpu --epochs 1 --max-batches 5
"""
import argparse
import math
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon

from mxnet_tpu_torch.examples.word_language_model.model import RNNModel


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Gluon word language model")
    parser.add_argument("--data", type=str, default=None,
                        help="path to a whitespace-tokenized text file")
    parser.add_argument("--model", type=str, default="lstm")
    parser.add_argument("--emsize", type=int, default=200)
    parser.add_argument("--nhid", type=int, default=200)
    parser.add_argument("--nlayers", type=int, default=2)
    parser.add_argument("--lr", type=float, default=1.0)
    parser.add_argument("--clip", type=float, default=0.2)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--bptt", type=int, default=35)
    parser.add_argument("--dropout", type=float, default=0.2)
    parser.add_argument("--tied", action="store_true")
    parser.add_argument("--vocab", type=int, default=500)
    parser.add_argument("--corpus", type=int, default=120000,
                        help="tokens of the synthetic corpus")
    parser.add_argument("--max-batches", type=int, default=0,
                        help="stop each epoch after this many batches "
                             "(0: the whole epoch)")
    parser.add_argument("--device", type=str, default="cuda:0")
    return parser.parse_args(argv)


def make_corpus(args):
    if args.data:
        with open(args.data) as f:
            tokens = f.read().split()
        vocab = {w: i for i, w in enumerate(sorted(set(tokens)))}
        return np.array([vocab[w] for w in tokens], np.int32), len(vocab)
    rng = np.random.RandomState(0)
    trans = rng.dirichlet(np.ones(args.vocab) * 0.05, size=args.vocab)
    corpus = np.zeros(args.corpus, np.int32)
    state = 0
    for i in range(len(corpus)):
        state = rng.choice(args.vocab, p=trans[state])
        corpus[i] = state
    return corpus, args.vocab


def batchify(data, batch_size):
    nbatch = len(data) // batch_size
    return data[:nbatch * batch_size].reshape(batch_size, nbatch).T


def get_batch(source, i, bptt, ctx):
    seq_len = min(bptt, source.shape[0] - 1 - i)
    data = source[i:i + seq_len]
    target = source[i + 1:i + 1 + seq_len]
    return (mx.nd.array(data, ctx=ctx),
            mx.nd.array(target.reshape(-1), ctx=ctx))


def detach(hidden):
    return [h.detach() for h in hidden] if isinstance(hidden, list) \
        else hidden.detach()


def evaluate(model, source, loss_fn, args, ctx):
    total_loss, ntotal = 0.0, 0
    hidden = model.begin_state(batch_size=args.batch_size, ctx=ctx)
    for i in range(0, source.shape[0] - 1, args.bptt):
        data, target = get_batch(source, i, args.bptt, ctx)
        output, hidden = model(data, hidden)
        loss = loss_fn(output, target)
        total_loss += float(loss.mean().asscalar()) * len(target)
        ntotal += len(target)
    return total_loss / ntotal


def main(argv=None):
    """Train; returns ``{"val_ppl": [...], "tokens_per_s": [...],
    "train_s": [...], "batches": [...]}``, one entry per epoch."""
    args = parse_args(argv)
    ctx = mx.context.as_context(args.device)
    corpus, vocab_size = make_corpus(args)
    n = len(corpus)
    train_data = batchify(corpus[:int(n * 0.9)], args.batch_size)
    val_data = batchify(corpus[int(n * 0.9):], args.batch_size)

    model = RNNModel(args.model, vocab_size, args.emsize, args.nhid,
                     args.nlayers, args.dropout, args.tied)
    model.initialize(mx.init.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": args.lr, "momentum": 0,
                             "wd": 0})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    stats = {"val_ppl": [], "tokens_per_s": [], "train_s": [],
             "batches": []}
    for epoch in range(args.epochs):
        total_loss, ntokens, nbatch = 0.0, 0, 0
        hidden = model.begin_state(batch_size=args.batch_size, ctx=ctx)
        start = time.time()
        for ibatch, i in enumerate(range(0, train_data.shape[0] - 1,
                                         args.bptt)):
            if args.max_batches and ibatch >= args.max_batches:
                break
            data, target = get_batch(train_data, i, args.bptt, ctx)
            hidden = detach(hidden)
            with mx.autograd.record():
                output, hidden = model(data, hidden)
                loss = loss_fn(output, target)
            loss.backward()
            grads = [p.grad() for p in model.collect_params().values()
                     if p.grad_req != "null"]
            gluon.utils.clip_global_norm(grads, args.clip * len(target))
            trainer.step(len(target))
            total_loss += float(loss.mean().asscalar()) * len(target)
            ntokens += len(target)
            nbatch += 1
            if ibatch % 20 == 0 and ibatch > 0:
                cur = total_loss / (ibatch + 1) / len(target)
                print(f"epoch {epoch} batch {ibatch} ppl "
                      f"{math.exp(min(cur, 20)):.2f} "
                      f"{ntokens / (time.time() - start):.0f} tok/s")
        train_s = time.time() - start
        val_loss = evaluate(model, val_data, loss_fn, args, ctx)
        val_ppl = math.exp(min(val_loss, 20))
        print(f"epoch {epoch}: val ppl {val_ppl:.2f}")
        stats["val_ppl"].append(val_ppl)
        stats["tokens_per_s"].append(ntokens / train_s)
        stats["train_s"].append(train_s)
        stats["batches"].append(nbatch)
    return stats


if __name__ == "__main__":
    main()
