"""The JAX package's own fit of ``bench.py``'s char-LM pair, on the CPU:
the yardstick of ``chip_smoke.py``'s ``lm_fit`` accuracies.

    JAX_PLATFORMS=cpu python tests/torch_lm_reference.py

It runs ``bench.py:399-440``'s two fits as written there (the corpus,
``np.random.seed(7)``, windows of 16, ``NDArrayIter(..., 32,
shuffle=True, last_batch_handle="discard")``, Adam lr 3e-3, ``Xavier()``,
``Accuracy(axis=2)``): the target ``TransformerLMSpec(vocab, 128, 8, 4,
64)`` for 4 epochs, then the draft ``make_draft_spec(spec, 2, 4)`` for 6,
and prints one JSON line with each model's final training accuracy (the
metric's value over the last epoch) and the seconds each fit took.
"""
import json
import time

import numpy as np

CORPUS = ("the quick brown fox jumps over the lazy dog. "
          "pack my box with five dozen liquor jugs. "
          "how vexingly quick daft zebras jump. "
          "sphinx of black quartz judge my vow. ") * 12
SEQ_LEN = 16


def windows(corpus=CORPUS, seq_len=SEQ_LEN):
    """(chars, ids, data, label) of ``bench.py``'s next-char windows."""
    chars = sorted(set(corpus))
    ids = np.asarray([chars.index(c) for c in corpus], np.int32)
    nw = len(ids) - seq_len - 1
    data = np.stack([ids[i:i + seq_len] for i in range(nw)])
    label = np.stack([ids[i + 1:i + seq_len + 1]
                      for i in range(nw)]).astype(np.float32)
    return chars, ids, data, label


def main():
    import mxnet_tpu as mx
    from mxnet_tpu.serving.decode import TransformerLMSpec, build_symbol
    from mxnet_tpu.serving.decode.spec import make_draft_spec

    np.random.seed(7)
    chars, _, data, label = windows()

    def fit(spec, num_epoch, mname):
        it = mx.io.NDArrayIter(data.astype(np.float32), label, 32,
                               shuffle=True, last_batch_handle="discard")
        mod = mx.mod.Module(symbol=build_symbol(spec, SEQ_LEN),
                            data_names=("data",),
                            label_names=("softmax_label",),
                            context=mx.cpu())
        metric = mx.metric.Accuracy(axis=2, name=mname)
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=num_epoch, optimizer="adam",
                optimizer_params={"learning_rate": 3e-3},
                initializer=mx.init.Xavier(), eval_metric=metric)
        return float(metric.get()[1]), time.perf_counter() - t0

    spec = TransformerLMSpec(vocab_size=len(chars), num_embed=128,
                             num_heads=8, num_layers=4, max_seq=64,
                             name="specbench")
    target_acc, target_s = fit(spec, 4, "next_char_acc")
    dspec = make_draft_spec(spec, num_layers=2, shrink=4)
    draft_acc, draft_s = fit(dspec, 6, "draft_next_char_acc")
    print(json.dumps({"package": "mxnet_tpu", "device": "cpu",
                      "target_acc": target_acc, "draft_acc": draft_acc,
                      "target_fit_s": target_s, "draft_fit_s": draft_s,
                      "windows": int(data.shape[0])}))


if __name__ == "__main__":
    main()
