"""The port's ``DecodePredictor`` on the CPU: behaviour pins of
``tests/test_decode.py``.

``interop.decode_params_from_jax`` carries the JAX package's dict and
checks it against the spec; the default device is CUDA or an error.
Batched streams are bit-identical to solo under a join/leave drill; stop
token and capacity; prompt validation; program counts (len(buckets) + 1
after warmup, none while serving); key material (slots, max_seq, cache
layout); counted bytes (decode below the cacheless re-prefill at seq >=
32) and the cache's bytes equal to the live buffers'.
"""
import time

import numpy as np
import pytest
import torch

from mxnet_tpu.serving.decode import model as jmodel

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving.decode import (
    DecodeBatcher, DecodePredictor, init_params)

from torch_decode_helpers import (SMALL, decode_rows, make_engine,
                                  make_prompts, small_spec)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.serving


# ---------------------------------------------------------------------------
# parameters from the JAX package, and the default device
# ---------------------------------------------------------------------------
def test_decode_params_from_jax_checks_the_spec():
    spec = small_spec("interop")
    params = jmodel.init_params(jmodel.TransformerLMSpec(**SMALL), seed=0)
    got = tmx.interop.decode_params_from_jax(params, spec, "cpu")
    assert list(got) == spec.param_names()
    assert all(v.dtype == torch.float32 and np.array_equal(
        v.numpy(), params[n]) for n, v in got.items())
    bad = dict(params, head_weight=params["head_weight"][:, :8])
    with pytest.raises(MXNetError):
        tmx.interop.decode_params_from_jax(bad, spec, "cpu")
    with pytest.raises(MXNetError):
        tmx.interop.decode_params_from_jax(
            {n: v for n, v in params.items() if n != "lnf_beta"}, spec,
            "cpu")


def test_default_device_is_cuda_or_raises():
    spec = small_spec("nodevice")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is cuda:0")
    with pytest.raises(MXNetError):
        DecodePredictor(spec, init_params(spec), slots=2)
    with tmx.cpu():
        assert DecodePredictor(spec, init_params(spec),
                               slots=2).device.type == "cpu"


# ---------------------------------------------------------------------------
# bit-identity: continuous batching must not change a single token
# ---------------------------------------------------------------------------
def test_solo_generate_deterministic():
    eng = make_engine("det")
    p = make_prompts(1)[0]
    a = list(eng.generate(p, max_new_tokens=8))
    b = list(eng.generate(p, max_new_tokens=8))
    assert a == b and len(a) == 8


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_continuous_batching_bit_identical_mixed_join_leave(kv):
    """8 staggered requests of different lengths and budgets through 3
    lanes: every request joins a batch mid-flight or backfills a freed
    lane, and every stream equals solo decode bit for bit."""
    prompts = make_prompts(8)
    budgets = [6, 9, 4, 12, 7, 5, 10, 8]
    solo_eng = make_engine("bitsolo", slots=4, kv_dtype=kv)
    solo = [list(solo_eng.generate(p, max_new_tokens=m))
            for p, m in zip(prompts, budgets)]
    eng = make_engine("bitbatch", slots=3, kv_dtype=kv)
    with DecodeBatcher(eng, max_wait_us=500, name="bit") as bat:
        futs = []
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            futs.append(bat.submit(p, max_new_tokens=m))
            time.sleep(0.003 * (i % 3))     # force mid-flight joins
        streams = [f.result(timeout=120) for f in futs]
    assert streams == solo
    rep = bat.report()
    assert rep["served_generations"] == 8
    assert rep["streamed_tokens"] == sum(budgets)


def test_stream_iteration_and_stop_token():
    eng = make_engine("stops")
    with DecodeBatcher(eng, max_wait_us=100, name="stops") as bat:
        p = make_prompts(1)[0]
        ref = list(eng.generate(p, max_new_tokens=12))
        stop = ref[3]
        toks = list(bat.generate(p, max_new_tokens=12, stop_token=stop))
    assert toks == ref[:ref.index(stop) + 1]
    assert list(eng.generate(p, max_new_tokens=12,
                             stop_token=stop)) == toks


def test_generation_stops_at_cache_capacity():
    eng = make_engine("capfull", max_seq=16, seq_buckets=(8,))
    p = make_prompts(1, lens=(8,))[0]
    solo = list(eng.generate(p, max_new_tokens=1000))
    assert len(solo) == 16 - 8 + 1
    with DecodeBatcher(eng, max_wait_us=0, name="cap") as bat:
        batched = bat.submit(p, max_new_tokens=1000).result(timeout=120)
    assert batched == solo


def test_prompt_validation():
    eng = make_engine("valid", max_seq=16, seq_buckets=(8, 16))
    with pytest.raises(MXNetError):
        eng.check_prompt(np.zeros((2, 3), np.int32))
    with pytest.raises(MXNetError):
        eng.check_prompt(np.zeros(17, np.int32))
    with DecodeBatcher(eng, name="valid") as bat:
        with pytest.raises(MXNetError):
            bat.submit(np.zeros(0, np.int32))


# ---------------------------------------------------------------------------
# programs: per-bucket prefill + one decode, then none while serving
# ---------------------------------------------------------------------------
def test_zero_fresh_programs_beyond_prefill_and_decode():
    # unique dims: registry rows are keyed by program key and named by
    # the first engine to acquire them
    eng = make_engine("progs", slots=2, seq_buckets=(8, 16, 32), vocab=66,
                      dim=40)
    assert eng.warmup() == eng.retraces == len(eng.buckets) + 1
    rows = decode_rows(tmx.compile_report(), eng)
    assert len(rows) == len(eng.buckets) + 1
    names = {r["name"] for r in rows}
    assert names == {f"decode:progs:prefill:s{b}" for b in eng.buckets} \
        | {"decode:progs:decode"}
    before = eng.retraces
    with DecodeBatcher(eng, max_wait_us=200, name="progs") as bat:
        futs = [bat.submit(p, max_new_tokens=5) for p in make_prompts(6)]
        for f in futs:
            f.result(timeout=120)
    assert eng.retraces == before, "live serving must acquire nothing"
    assert len(decode_rows(tmx.compile_report(), eng)) == \
        len(eng.buckets) + 1
    assert not any(n in tmx.compile_report()["retraces"] for n in names)


def test_compile_keys_carry_cache_layout_and_slots():
    k1 = make_engine("keys", slots=2)._program_key("decode")
    k2 = make_engine("keys", slots=4)._program_key("decode")
    k3 = make_engine("keys", slots=2, max_seq=32,
                     seq_buckets=(8, 16, 32))._program_key("decode")
    assert len({k1.digest, k2.digest, k3.digest}) == 3
    extra = k1.materials["extra"]
    assert extra["cache_layout"] == "slot-major:f32"
    assert extra["donate"] is True and extra["slots"] == 2
    eng = make_engine("keys", slots=2)
    assert eng._program_key("reprefill", 8).materials["extra"][
        "cache_layout"] == "none"
    assert eng._program_key("verify", 5).name == "decode:keys:verify:k5"
    assert eng._program_key("prefill", 8).name == "decode:keys:prefill:s8"


# ---------------------------------------------------------------------------
# counted bytes: the KV-cache must pay for itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [32, 64])
def test_decode_bytes_strictly_below_reprefill_baseline(seq):
    eng = make_engine(f"bytes{seq}", slots=4, seq_buckets=(seq,),
                      max_seq=seq)
    assert eng.program_cost("decode") == {}
    eng.warmup()
    per_tok = eng.decode_bytes_per_token()
    baseline = eng.reprefill_bytes_per_token(bucket=seq)
    assert per_tok < baseline, (per_tok, baseline)
    assert eng.retraces == 3                # reprefill acquired lazily
    cost = eng.program_cost("decode")
    s = eng.spec
    cache = s.kv_cache_bytes(eng.slots)
    assert cost["bytes accessed"] > cache   # reads every row + weights
    assert cost["flops"] > 0


def test_kv_cache_memory_accounting():
    for kv in ("float32", "int8"):
        eng = make_engine("hbmacct", slots=4, kv_dtype=kv)
        spec_bytes = eng.spec.kv_cache_bytes(eng.slots, kv)
        assert eng.kv_cache_bytes() == spec_bytes == sum(
            c.numel() * c.element_size() for c in eng._caches)
        rep = eng.report()
        assert rep["kv_cache_bytes"] == rep["kv_cache_accounted_bytes"]
        assert rep["kv_cache_f32_bytes"] == eng.spec.kv_cache_bytes(4)
