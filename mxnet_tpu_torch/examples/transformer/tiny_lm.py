"""Tiny character-level transformer LM, trained then served (the port's
counterpart of ``examples/transformer/tiny_lm.py``).

The same ``TransformerLMSpec`` drives both halves. Training builds the
full-sequence symbol (``serving.decode.build_symbol``: Embedding,
learned positions, pre-LN ``CausalSelfAttention`` blocks and the head)
and runs it through ``fit()`` with a ``CheckpointManager`` saving every
epoch (run again with the same workdir and ``auto_resume`` resumes after
the last epoch). Serving freezes the fitted params into a
``DecodePredictor`` (``from_module``) and streams generations through
the continuous batcher (``DecodeBatcher``).

What differs from the JAX package's example: the port has no
``DataPipeline`` yet (``data/pipeline.py``), so ``fit`` reads the
``NDArrayIter`` directly; and everything runs on ``--device``
(``cuda:0`` by default, ``cpu`` for a run without a card).

The corpus is a planted-structure toy (a few sentences repeated): big
enough that next-char accuracy well above chance shows the causal blocks
learn. ``--mini`` is the small run the CPU tests execute.

Run: python -m mxnet_tpu_torch.examples.transformer.tiny_lm
     python -m mxnet_tpu_torch.examples.transformer.tiny_lm --mini --device cpu
"""
import argparse
import os
import tempfile

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.serving.decode import (
    TransformerLMSpec, DecodeBatcher, DecodePredictor, build_symbol)

CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "pack my box with five dozen liquor jugs. "
    "how vexingly quick daft zebras jump! "
) * 12


def make_dataset(text, seq_len):
    """Sliding next-char windows: data[i] = chars [i, i+S), label[i] =
    chars [i+1, i+S+1), the standard LM shift."""
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    ids = np.array([stoi[c] for c in text], dtype=np.int32)
    n = len(ids) - seq_len - 1
    data = np.stack([ids[i:i + seq_len] for i in range(n)])
    label = np.stack([ids[i + 1:i + seq_len + 1] for i in range(n)])
    return data, label.astype(np.float32), chars, stoi


def train(workdir, spec, seq_len, device, batch_size=32, num_epoch=4,
          quiet=False):
    data, label, chars, stoi = make_dataset(CORPUS, seq_len)
    train_iter = mx.io.NDArrayIter(
        data={"data": data.astype(np.float32)},
        label={"softmax_label": label}, batch_size=batch_size,
        shuffle=False)
    mod = mx.mod.Module(symbol=build_symbol(spec, seq_len),
                        data_names=("data",),
                        label_names=("softmax_label",), context=device)
    manager = mx.checkpoint.CheckpointManager(os.path.join(workdir, "ckpt"))
    metric = mx.metric.Accuracy(axis=2, name="next_char_acc")
    mod.fit(train_iter, num_epoch=num_epoch, optimizer="adam",
            optimizer_params={"learning_rate": 0.003},
            initializer=mx.init.Xavier(), eval_metric=metric,
            checkpoint_manager=manager, auto_resume=True,
            batch_end_callback=None if quiet else
            mx.callback.Speedometer(batch_size, 16))
    train_iter.reset()
    acc = mod.score(train_iter, metric)[0][1]
    return mod, acc, chars, stoi


def generate(mod, spec, chars, stoi, prompts, max_new_tokens=24,
             slots=4):
    """Stream continuations for every prompt through the continuous
    batcher; returns ({prompt: generated_text}, the engine's report)."""
    eng = DecodePredictor.from_module(mod, spec, slots=slots)
    out = {}
    with DecodeBatcher(eng, name="tiny_lm") as bat:
        futs = {p: bat.submit(
            np.array([stoi[c] for c in p], dtype=np.int32),
            max_new_tokens=max_new_tokens) for p in prompts}
        for p, f in futs.items():
            out[p] = "".join(chars[t] for t in f.result(timeout=120))
    return out, eng.report()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mini", action="store_true",
                    help="small run (tiny model, 1 epoch)")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint directory (default: temp; pass the "
                         "same dir twice to exercise auto-resume)")
    ap.add_argument("--device", default="cuda:0",
                    help="where the model trains and serves (default "
                         "cuda:0)")
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="tiny_lm_")
    vocab = len(sorted(set(CORPUS)))
    if args.mini:
        spec = TransformerLMSpec(vocab_size=vocab, num_embed=32,
                                 num_heads=2, num_layers=2, max_seq=32,
                                 name="tinylm")
        fit_kw = dict(seq_len=16, batch_size=32, num_epoch=1, quiet=True)
    else:
        spec = TransformerLMSpec(vocab_size=vocab, num_embed=64,
                                 num_heads=4, num_layers=2, max_seq=64,
                                 name="tinylm")
        fit_kw = dict(seq_len=32, batch_size=32, num_epoch=4)
    mod, acc, chars, stoi = train(workdir, spec, device=args.device,
                                  **fit_kw)

    prompts = ["the quick", "pack my"] if args.mini else \
        ["the quick brown ", "pack my box ", "how vexingly "]
    texts, report = generate(mod, spec, chars, stoi, prompts,
                             max_new_tokens=8 if args.mini else 24)
    print(f"next-char acc: {acc:.3f}  (chance: {1 / vocab:.3f})")
    for p, t in texts.items():
        print(f"  {p!r} -> {t!r}")
    print(f"decode report: programs={report['retraces']} "
          f"tokens={report['tokens']} "
          f"kv_cache_bytes={report['kv_cache_bytes']}")
    return {"acc": acc, "texts": texts, "report": report}


if __name__ == "__main__":
    main()
