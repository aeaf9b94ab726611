"""D1, the decode-attention kernel's wrapper, on the CPU
(``mxnet_tpu_torch/ops/decode_attention.py``).

- ``decode_attention_plain`` against the JAX package's attention math
  (``mxnet_tpu/serving/decode/model.py``: the cache dequantized by its
  ``_kv_dequant``, the einsum, the ``-1e30`` mask, the max-then-exp
  softmax divided last), f32 and int8 caches, W in {1, 5}, positions
  mixed, at the last row and past it, inactive lanes at 0: within 2e-6
  abs (outputs are O(1) averages; the two einsums sum in other orders,
  ~1e-7 apart).
- ``_kv_dequant`` equals the JAX package's bit for bit.
- On CPU tensors the wrapper is the plain version and counts no launch;
  it refuses shapes that do not fit and a lone scale.
- ``model._row_index``: every step writes W distinct rows a lane, the
  fed rows where they belong, so ``index_copy_`` never sees a duplicate
  index, for every position up to and past the cache's end; and the
  write equals the JAX package's ``mode="drop"`` scatter.
- D1's launch counter goes through ``fused_bn_conv``'s counting (a
  capture's tally, ``add_counts``, ``reset_launch_counts``), and
  ``launch_counts`` keeps its five keys.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.serving.decode import model as jmodel

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import decode_attention as da
from mxnet_tpu_torch.ops import fused_bn_conv as tfb
from mxnet_tpu_torch.serving.decode import model as tmodel
from torch_threads import one_torch_thread  # noqa: F401

N, M, H, D = 6, 24, 2, 8
POSITIONS = (0, 3, 23, 11, 0, 22)        # lanes 0 and 4: inactive (0)


def _jax_attention(q, kc, vc, positions):
    """The JAX package's verify attention (model.py:448-455) on cache
    views ``kc``, ``vc`` (N, M, H, D) and q (N, W, H, D)."""
    n, w = q.shape[:2]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    pos = positions[:, None] + jnp.arange(w)[None, :]
    visible = jnp.arange(kc.shape[1])[None, None, :] <= pos[:, :, None]
    s = jnp.einsum("nkhd,nmhd->nkhm", q, kc) * scale
    s = jnp.where(visible[:, :, None, :], s, jmodel._NEG)
    m = jnp.max(s, axis=-1, keepdims=True)
    e = jnp.exp(s - m)
    o = jnp.einsum("nkhm,nmhd->nkhd", e, vc)
    return o / jnp.sum(e, axis=-1)[..., None]


def _inputs(kv, w, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((N, w, H, D)).astype(np.float32)
    k = rng.standard_normal((N, M, H, D)).astype(np.float32)
    v = rng.standard_normal((N, M, H, D)).astype(np.float32)
    pos = np.array(POSITIONS, np.int32)
    if kv == "int8":
        kq, ks = (np.array(a) for a in jmodel._kv_quant_rows(k))
        vq, vs = (np.array(a) for a in jmodel._kv_quant_rows(v))
        return q, pos, (kq, vq, ks, vs)
    return q, pos, (k, v, None, None)


@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_plain_matches_jax_attention(kv, w):
    q, pos, (k, v, ks, vs) = _inputs(kv, w)
    if kv == "int8":
        kc, vc = jmodel._kv_dequant(k, ks), jmodel._kv_dequant(v, vs)
    else:
        kc, vc = k, v
    want = np.asarray(_jax_attention(q, kc, vc, pos))
    t = [torch.from_numpy(np.array(a)) if a is not None else None
         for a in (q, k, v, pos, ks, vs)]
    got = da.decode_attention_plain(*t)
    assert got.dtype == torch.float32 and got.shape == (N, w, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_kv_dequant_equals_jax():
    _, _, (kq, _, ks, _) = _inputs("int8", 1, seed=2)
    np.testing.assert_array_equal(
        tmodel._kv_dequant(torch.from_numpy(kq),
                           torch.from_numpy(ks)).numpy(),
        np.asarray(jmodel._kv_dequant(kq, ks)))


def test_wrapper_is_plain_on_cpu_and_counts_nothing():
    tfb.reset_launch_counts()
    q, pos, (k, v, ks, vs) = _inputs("int8", 5, seed=1)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, pos, ks, vs)]
    assert torch.equal(da.decode_attention(*t),
                       da.decode_attention_plain(*t))
    assert da.decode_attention.launches == 0


def test_wrapper_refuses_what_does_not_fit():
    q, pos, (k, v, ks, vs) = (
        [torch.from_numpy(np.array(a)) for a in x] if isinstance(x, tuple)
        else torch.from_numpy(x) for x in _inputs("int8", 1))
    with pytest.raises(MXNetError):
        da.decode_attention(q, k[:, :, :1], v, pos, ks, vs)
    with pytest.raises(MXNetError):
        da.decode_attention(q, k, v, pos[:3], ks, vs)
    with pytest.raises(MXNetError):
        da.decode_attention(q, k, v, pos, ks, None)
    with pytest.raises(MXNetError):
        da.decode_attention(q, k, v, pos, ks[:, :4], vs)


@pytest.mark.parametrize("w", [1, 2, 5])
def test_row_index_writes_distinct_rows(w):
    n = 8
    for base in range(0, M + 2):
        positions = torch.full((n,), base, dtype=torch.int32)
        fed = torch.from_numpy(
            np.random.RandomState(base).rand(n, w) < 0.6)
        idx, take = tmodel._row_index(M, positions, fed)
        flat = idx.reshape(-1).tolist()
        assert len(set(flat)) == len(flat)
        lanes, rows = idx // M, idx % M
        assert torch.equal(lanes, torch.arange(n)[:, None].expand(n, w))
        assert bool(((rows >= 0) & (rows < M)).all())
        t = base + torch.arange(w)
        assert torch.equal(take, fed & (t < M))
        assert bool((rows[take] == t.expand(n, w)[take]).all())


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_masked_write_equals_drop_scatter(kv):
    """Fed tokens write their rows, dropped ones (not fed, or past the
    end) leave the cache as it was: the JAX package's ``mode="drop"``
    scatter at the ``max_seq`` sentinel."""
    rng = np.random.RandomState(3)
    n, w = 4, 5
    spec = tmodel.TransformerLMSpec(vocab_size=16, num_embed=H * D,
                                    num_heads=H, num_layers=1, max_seq=M)
    caches = tmodel.init_caches(spec, n, kv)
    for c in caches:
        c.copy_(torch.from_numpy(rng.standard_normal(c.shape) * 5)
                .to(c.dtype))
    before = [c.clone() for c in caches]
    positions = np.array([0, 9, M - 2, M - 1], np.int32)
    fed = rng.rand(n, w) < 0.7
    k = rng.standard_normal((n, w, H, D)).astype(np.float32)
    v = rng.standard_normal((n, w, H, D)).astype(np.float32)
    idx, take = tmodel._row_index(M, torch.from_numpy(positions),
                                  torch.from_numpy(fed))
    tmodel._write_rows(caches, 0, kv == "int8", idx, take,
                       torch.from_numpy(k), torch.from_numpy(v))
    wpos = np.where(fed, positions[:, None] + np.arange(w), M)
    sidx = np.arange(n)[:, None]
    news = jmodel._kv_quant_rows(k) + jmodel._kv_quant_rows(v) \
        if kv == "int8" else (k, v)
    order = (0, 1, 2, 3) if kv == "int8" else (0, 1)
    for i, c0, c1 in zip(order, before, caches):
        want = jnp.asarray(c0.numpy()).at[sidx, wpos].set(
            jnp.asarray(news[i]), mode="drop")
        np.testing.assert_array_equal(c1.numpy(), np.asarray(want))


def test_launch_counter_goes_through_the_shared_counting(monkeypatch):
    from types import SimpleNamespace
    monkeypatch.setattr(tfb, "_stream_handle", lambda device: 7)
    tfb.reset_launch_counts()
    dev = torch.device("cpu")
    with tfb.capture_tally(SimpleNamespace(cuda_stream=7)) as tally:
        tfb._count("decode_attention", dev)
        tfb._count("decode_attention", dev)
    assert tally == {"decode_attention": 2}
    assert da.decode_attention.launches == 0
    tfb.add_counts(tally, 3)                  # three replays
    assert da.decode_attention.launches == 6
    assert sorted(tfb.launch_counts()) == sorted(
        ["bn_relu_conv_nchw", "bn_act_prologue", "bn_relu_matmul_fwd",
         "bn_backward_reduce", "bn_backward_dx"])
    tfb.reset_launch_counts()
    assert da.decode_attention.launches == 0
