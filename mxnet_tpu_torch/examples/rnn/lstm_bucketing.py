"""LSTM language model with bucketing (the port's counterpart of
``examples/rnn/lstm_bucketing.py``; reference:
example/rnn/bucketing/lstm_bucketing.py): variable-length sentences
padded into length buckets, one bound Module per bucket
(``BucketingModule``), trained with ``Module.fit``.

The cell is one ``FusedRNNCell`` shared by every bucket's symbol, so
each bucket's graph holds the same ``lstm_parameters`` vector and one
``RNN`` node, whose lstm steps run the L1 kernel on the card. Each
bucket's programs are captured once and replayed after that.

With no dataset on disk the default synthetic mode generates a
Markov-chain corpus cut into random-length sentences; point --data at a
whitespace-tokenized text file (one sentence per line) for real use.

Run: python -m mxnet_tpu_torch.examples.rnn.lstm_bucketing
     python -m mxnet_tpu_torch.examples.rnn.lstm_bucketing --device cpu
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx


def tokenize(path, vocab=None):
    sentences, vocab = [], dict(vocab or {"<pad>": 0})
    with open(path) as f:
        for line in f:
            words = line.split()
            if not words:
                continue
            for w in words:
                vocab.setdefault(w, len(vocab))
            sentences.append([vocab[w] for w in words])
    return sentences, vocab


def synthetic_corpus(n_sentences=2000, vocab_size=200, seed=0):
    """The JAX package's corpus for the same arguments."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(vocab_size) * 0.05, size=vocab_size)
    sentences = []
    for _ in range(n_sentences):
        length = rng.randint(5, 40)
        s, state = [], rng.randint(vocab_size)
        for _ in range(length):
            state = rng.choice(vocab_size, p=trans[state])
            s.append(state + 1)           # 0 is the pad id
        sentences.append(s)
    return sentences, vocab_size + 1


def sym_gen_factory(vocab_size, num_embed, num_hidden, num_layers,
                    batch_size):
    """One FusedRNNCell shared by every bucket's symbol; forget_bias=0,
    as the JAX example (the corpus is order-1 Markov)."""
    cell = mx.rnn.FusedRNNCell(num_hidden, num_layers=num_layers,
                               mode="lstm", forget_bias=0.0,
                               prefix="lstm_")

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab_size,
                                 output_dim=num_embed, name="embed")
        out, _ = cell.unroll(seq_len, embed, layout="NTC",
                             merge_outputs=True)
        pred = mx.sym.Reshape(out, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(pred, num_hidden=vocab_size,
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=str, default=None)
    ap.add_argument("--buckets", type=str, default="10,20,30,40")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-embed", type=int, default=128)
    ap.add_argument("--num-hidden", type=int, default=128)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--num-epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--device", type=str, default="cuda:0")
    return ap.parse_args(argv)


def main(argv=None, batch_end_callback=None):
    """Train; returns the BucketingModule. ``batch_end_callback`` runs
    after the Speedometer (which resets the metric every 50 batches, so
    an epoch's Train-perplexity covers its last batches)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.data:
        sentences, vocab = tokenize(args.data)
        vocab_size = len(vocab)
    else:
        sentences, vocab_size = synthetic_corpus()
    buckets = [int(b) for b in args.buckets.split(",")]
    # next-token labels come from shifting inside each padded bucket
    train = mx.rnn.BucketSentenceIter(sentences, args.batch_size,
                                      buckets=buckets, invalid_label=0)
    mod = mx.mod.BucketingModule(
        sym_gen_factory(vocab_size, args.num_embed, args.num_hidden,
                        args.num_layers, args.batch_size),
        default_bucket_key=train.default_bucket_key,
        context=mx.context.as_context(args.device))
    mod.fit(train, num_epoch=args.num_epochs,
            eval_metric=mx.metric.Perplexity(ignore_label=0),
            optimizer="adam",
            optimizer_params={"learning_rate": args.lr},
            initializer=mx.init.Xavier(),
            batch_end_callback=[mx.callback.Speedometer(args.batch_size, 50)]
            + ([batch_end_callback] if batch_end_callback else []))
    return mod


if __name__ == "__main__":
    main()
