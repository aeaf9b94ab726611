"""Shared builders for the port's decode-serving tests
(``test_torch_decode*.py``): a small ``TransformerLMSpec``, a CPU
``DecodePredictor`` over ``init_params(seed=0)``, seeded prompts, and the
compile report's decode rows of one engine."""
import numpy as np

from mxnet_tpu_torch.serving.decode import (
    DecodePredictor, TransformerLMSpec, init_params)

SMALL = dict(vocab_size=64, num_embed=32, num_heads=2, num_layers=2,
             max_seq=64)


def small_spec(name, max_seq=64, vocab=64, dim=32, heads=2, layers=2):
    return TransformerLMSpec(vocab_size=vocab, num_embed=dim,
                             num_heads=heads, num_layers=layers,
                             max_seq=max_seq, name=name)


def make_engine(name, slots=4, seq_buckets=(8, 16, 32), kv_dtype=None,
                **spec_kw):
    spec = small_spec(name, **spec_kw)
    return DecodePredictor(spec, init_params(spec, seed=0), slots=slots,
                           seq_buckets=seq_buckets, kv_dtype=kv_dtype,
                           device="cpu")


def make_prompts(n, vocab=64, seed=7, lens=(5, 12, 3, 20, 7, 9, 15, 4)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=lens[i % len(lens)]
                        ).astype(np.int32) for i in range(n)]


def decode_rows(report, engine):
    pre = f"decode:{engine.name}:"
    return [p for p in report["programs"]
            if p["kind"] == "decode" and p["name"].startswith(pre)]
