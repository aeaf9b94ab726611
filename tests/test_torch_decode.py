"""The port's decode model (``mxnet_tpu_torch/serving/decode``) against
the JAX package's, on the CPU.

Parity, with the same numpy parameters, caches and inputs in both
packages (small spec: vocab 64, embed 32, 2 heads, 2 layers, max_seq
64):

- ``init_params`` equal bit for bit (the same ``RandomState`` draws).
- ``prefill_step``, ``decode_step`` (mixed positions, an inactive lane,
  a lane at the last row), ``verify_step`` (padded and inactive lanes,
  tokens past the end) and ``reprefill_step``: next tokens equal; f32
  caches within 1e-5 abs (f32 products and sums in another order:
  ~1e-7 here); int8 cache values equal except by 1 where ``rows /
  scale`` rounds at a tie (at most 1% of them), scales within 1e-6
  relative.
- ``DecodePredictor.generate`` streams equal to the JAX
  ``DecodePredictor``'s, f32 and int8.

The engine's, the batcher's and the int8 KV-cache's behaviour pins are
in ``test_torch_decode_engine.py``, ``test_torch_decode_batcher.py`` and
``test_torch_decode_int8_kv.py``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.serving.decode import model as jmodel
from mxnet_tpu.serving.decode import DecodePredictor as JaxDecodePredictor

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.serving.decode import (
    DecodePredictor, TransformerLMSpec, init_params)
from mxnet_tpu_torch.serving.decode import model as tmodel

from torch_decode_helpers import SMALL, make_prompts, small_spec
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.serving


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, num_layers=1,
                                            num_embed=16, num_heads=1),
                                dict(vocab_size=50, num_embed=24,
                                     num_heads=3, num_layers=3,
                                     max_seq=40, ffn_hidden=50)])
def test_init_params_bit_identical(kw):
    j = jmodel.init_params(jmodel.TransformerLMSpec(**kw), seed=3)
    t = init_params(TransformerLMSpec(**kw), seed=3)
    assert list(j) == list(t)
    for n in j:
        assert j[n].dtype == t[n].dtype and np.array_equal(j[n], t[n]), n


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@functools.lru_cache(maxsize=None)
def _sequence(kv):
    """prefill (slot 2), prefill (slot 0), decode, verify through both
    packages from the same zero caches; after each step: (JAX tokens,
    port tokens, JAX caches, port caches) as numpy."""
    jspec = jmodel.TransformerLMSpec(**SMALL)
    tspec = TransformerLMSpec(**SMALL)
    pj = jmodel.init_params(jspec, seed=0)
    pt = {n: torch.from_numpy(v) for n, v in init_params(tspec, 0).items()}
    cj = jmodel.init_caches(jspec, 4, kv)
    ct = tmodel.init_caches(tspec, 4, kv)
    rng = np.random.RandomState(1)
    out = {}

    def snap(name, nj, nt):
        out[name] = (_np(nj), _np(nt), [_np(c) for c in cj],
                     [_np(c).copy() for c in ct])

    for slot, plen in ((2, 11), (0, 16)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :plen] = rng.randint(1, 64, plen)
        cj, nj = jmodel.prefill_step(jspec, pj, cj, jnp.asarray(toks),
                                     np.int32(plen), np.int32(slot),
                                     kv_dtype=kv)
        ct, nt = tmodel.prefill_step(tspec, pt, ct, torch.from_numpy(toks),
                                     plen, slot, kv_dtype=kv)
        snap(f"prefill{slot}", nj, nt)
    tokens = np.array([5, 9, 33, 7], np.int32)
    pos = np.array([16, 0, 11, 63], np.int32)       # lane 1 inactive
    act = np.array([True, False, True, True])
    cj, nj = jmodel.decode_step(jspec, pj, cj, jnp.asarray(tokens),
                                jnp.asarray(pos), jnp.asarray(act),
                                kv_dtype=kv)
    ct, nt = tmodel.decode_step(tspec, pt, ct, torch.from_numpy(tokens),
                                torch.from_numpy(pos),
                                torch.from_numpy(act), kv_dtype=kv)
    snap("decode", nj, nt)
    vt = rng.randint(0, 64, (4, 5)).astype(np.int32)
    pos = np.array([17, 30, 12, 61], np.int32)      # lane 3 runs past 63
    ntok = np.array([5, 2, 3, 3], np.int32)
    act = np.array([True, False, True, True])
    cj, nj = jmodel.verify_step(jspec, pj, cj, jnp.asarray(vt),
                                jnp.asarray(pos), jnp.asarray(ntok),
                                jnp.asarray(act), kv_dtype=kv)
    ct, nt = tmodel.verify_step(tspec, pt, ct, torch.from_numpy(vt),
                                torch.from_numpy(pos),
                                torch.from_numpy(ntok),
                                torch.from_numpy(act), kv_dtype=kv)
    snap("verify", nj, nt)
    return out


def _assert_caches_close(cj, ct, kv):
    assert [c.dtype for c in cj] == [c.dtype for c in ct]
    for i, (a, b) in enumerate(zip(cj, ct)):
        if kv == "int8" and a.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, i
        elif kv == "int8":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("step", ["prefill2", "prefill0", "decode",
                                  "verify"])
def test_program_matches_jax(step, kv):
    nj, nt, cj, ct = _sequence(kv)[step]
    np.testing.assert_array_equal(nt, nj)
    assert nt.dtype == np.int32
    _assert_caches_close(cj, ct, kv)


def test_reprefill_matches_jax():
    jspec = jmodel.TransformerLMSpec(**SMALL)
    tspec = TransformerLMSpec(**SMALL)
    pj = jmodel.init_params(jspec, seed=0)
    pt = {n: torch.from_numpy(v) for n, v in init_params(tspec, 0).items()}
    rng = np.random.RandomState(2)
    for plen, sb in ((5, 8), (16, 16), (30, 32)):
        toks = np.zeros((1, sb), np.int32)
        toks[0, :plen] = rng.randint(0, 64, plen)
        assert int(tmodel.reprefill_step(tspec, pt, torch.from_numpy(toks),
                                         plen)) == \
            int(jmodel.reprefill_step(jspec, pj, jnp.asarray(toks),
                                      np.int32(plen)))


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_generate_streams_match_jax(kv):
    jspec = jmodel.TransformerLMSpec(**SMALL, name="jx")
    spec = small_spec("jxport")
    j = JaxDecodePredictor(jspec, jmodel.init_params(jspec, seed=0),
                           slots=4, seq_buckets=(8, 16, 32), kv_dtype=kv)
    params = tmx.interop.decode_params_from_jax(
        jmodel.init_params(jspec, seed=0), spec, "cpu")
    t = DecodePredictor(spec, params, slots=4, seq_buckets=(8, 16, 32),
                        kv_dtype=kv, device="cpu")
    for p, m in zip(make_prompts(5), (12, 9, 20, 6, 15)):
        assert list(t.generate(p, max_new_tokens=m)) == \
            list(j.generate(p, max_new_tokens=m))

