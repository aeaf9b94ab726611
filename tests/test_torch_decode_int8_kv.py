"""The port's int8 KV-cache on the CPU: the KV cases of
``tests/test_quant.py``.

The int8 cache holds at most 0.55 of the f32 cache's bytes and its
decode step counts fewer bytes; the kv dtype is compile-key material;
greedy tokens equal the f32 engine's; batched decode equals solo; and
``MXTPU_DECODE_KV_DTYPE`` sets the default.
"""
import pytest

from mxnet_tpu_torch import config
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving.decode import (
    DecodePredictor, TransformerLMSpec, init_params)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.serving


@pytest.fixture(scope="module")
def lm_engines():
    spec = TransformerLMSpec(vocab_size=32, num_embed=16, num_heads=2,
                             num_layers=1, max_seq=16, name="tqlm")
    params = init_params(spec, seed=0)
    f32 = DecodePredictor(spec, params, slots=2, seq_buckets=(8,),
                          name="tqlm-f32", kv_dtype="float32",
                          device="cpu")
    i8 = DecodePredictor(spec, params, slots=2, seq_buckets=(8,),
                         name="tqlm-i8", kv_dtype="int8", device="cpu")
    f32.warmup()
    i8.warmup()
    return spec, params, f32, i8


def test_int8_kv_cache_bytes_ratio(lm_engines):
    _, _, f32, i8 = lm_engines
    assert i8.kv_cache_bytes() <= 0.55 * f32.kv_cache_bytes()
    assert i8.report()["kv_dtype"] == "int8"


def test_int8_kv_decode_step_bytes_below_f32(lm_engines):
    _, _, f32, i8 = lm_engines
    bf = f32.program_cost("decode").get("bytes accessed")
    bq = i8.program_cost("decode").get("bytes accessed")
    assert bf and bq and bq < bf


def test_kv_dtype_is_compile_key_material(lm_engines):
    spec, params, _, _ = lm_engines
    a = DecodePredictor(spec, params, slots=2, seq_buckets=(8,),
                        name="tqlm-key", kv_dtype="float32", device="cpu")
    b = DecodePredictor(spec, params, slots=2, seq_buckets=(8,),
                        name="tqlm-key", kv_dtype="int8", device="cpu")
    assert a._program_key("decode").digest != \
        b._program_key("decode").digest
    assert a._program_key("prefill", 8).digest != \
        b._program_key("prefill", 8).digest
    assert b._program_key("decode").materials["extra"]["cache_layout"] \
        == "slot-major:int8+f32scale"


def test_int8_kv_greedy_tokens_match_f32(lm_engines):
    _, _, f32, i8 = lm_engines
    for p in ([1, 2, 3], [4, 5], [6, 7, 8, 9]):
        assert list(f32.generate(p, max_new_tokens=8)) == \
            list(i8.generate(p, max_new_tokens=8))


def test_int8_batched_decode_equals_solo(lm_engines):
    _, _, _, i8 = lm_engines
    prompts = [[1, 2, 3], [4, 5]]
    solo = [list(i8.generate(p, max_new_tokens=8)) for p in prompts]
    slots = [i8.alloc_slot() for _ in prompts]
    cur = {s: i8.prefill(s, p) for s, p in zip(slots, prompts)}
    streams = {s: [cur[s]] for s in slots}
    for _ in range(7):
        cur = i8.decode(cur)
        for s, t in cur.items():
            streams[s].append(t)
    for s in slots:
        i8.release(s)
    assert [streams[s] for s in slots] == solo


def test_kv_dtype_env_default(lm_engines):
    spec, params, _, _ = lm_engines
    with config.override("MXTPU_DECODE_KV_DTYPE", "int8"):
        eng = DecodePredictor(spec, params, slots=2, seq_buckets=(8,),
                              name="tqlm-env", device="cpu")
    assert eng.kv_dtype == "int8"
    with pytest.raises(MXNetError):
        DecodePredictor(spec, params, slots=2, seq_buckets=(8,),
                        name="tqlm-bad", kv_dtype="int4", device="cpu")
