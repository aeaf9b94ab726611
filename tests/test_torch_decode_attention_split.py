"""D1's split order on the CPU (``mxnet_tpu_torch/ops/decode_attention.py``).

D1 splits each lane's cache rows into chunks of R rows, forms each
chunk's partial softmax (max m, sum l, p . V) and combines the chunks in
chunk order. ``decode_attention_split_plain`` is that order in plain
PyTorch; these tests hold it, with R shrunk to 4 (and 16, which leaves a
ragged last chunk of 8 rows), against ``decode_attention_plain`` and the
JAX package's attention math, and pin ``_d1_plan``, the host's plan of
the CUDA kernel (rows a chunk, grid, workspace, shared memory and what
it refuses; the kernel is built for R of 32, 64 and 128 only). The
kernel itself runs only on the card (``chip_smoke.py`` holds it against
both plain versions there).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.serving.decode import model as jmodel

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import decode_attention as da
from torch_threads import one_torch_thread  # noqa: F401

N, M, H, D = 6, 24, 2, 8
R = 4
# R - 1, R, R + 1, the last row, past the cache's end, an inactive lane
POSITIONS = (R - 1, R, R + 1, M - 1, M + 6, 0)
# Tolerance against both references: the outputs are O(1) averages of
# the V rows; the split form takes each chunk's exp against the chunk's
# own max and scales it by exp(m_c - M) (two rounded exps where the
# references take one) and sums in another order, ~1e-7 apart here.
TOL = 2e-6


def _jax_attention(q, kc, vc, positions):
    """The JAX package's verify attention (model.py:448-455) on cache
    views ``kc``, ``vc`` (N, M, H, D) and q (N, W, H, D)."""
    w = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    pos = positions[:, None] + jnp.arange(w)[None, :]
    visible = jnp.arange(kc.shape[1])[None, None, :] <= pos[:, :, None]
    s = jnp.einsum("nkhd,nmhd->nkhm", q, kc) * scale
    s = jnp.where(visible[:, :, None, :], s, jmodel._NEG)
    m = jnp.max(s, axis=-1, keepdims=True)
    e = jnp.exp(s - m)
    o = jnp.einsum("nkhm,nmhd->nkhd", e, vc)
    return o / jnp.sum(e, axis=-1)[..., None]


def _inputs(kv, w, positions=POSITIONS, seed=0):
    """(numpy arrays q, pos, k, v, ks, vs; the same as torch tensors)."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((N, w, H, D)).astype(np.float32)
    k = rng.standard_normal((N, M, H, D)).astype(np.float32)
    v = rng.standard_normal((N, M, H, D)).astype(np.float32)
    pos = np.array(positions, np.int32)
    ks = vs = None
    if kv == "int8":
        k, ks = (np.array(a) for a in jmodel._kv_quant_rows(k))
        v, vs = (np.array(a) for a in jmodel._kv_quant_rows(v))
    arrays = (q, pos, k, v, ks, vs)
    return arrays, [None if a is None else torch.from_numpy(a)
                    for a in arrays]


def _split(t, rows=R):
    q, pos, k, v, ks, vs = t
    return da.decode_attention_split_plain(q, k, v, pos, ks, vs, rows=rows)


@pytest.mark.parametrize("rows", [R, 16])
@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_split_matches_plain_and_jax(kv, w, rows):
    (q, pos, k, v, ks, vs), t = _inputs(kv, w)
    got = _split(t, rows)
    assert got.dtype == torch.float32 and got.shape == (N, w, H, D)
    plain = da.decode_attention_plain(t[0], t[2], t[3], t[1], t[4], t[5])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=TOL)
    if kv == "int8":
        k, v = jmodel._kv_dequant(k, ks), jmodel._kv_dequant(v, vs)
    want = np.asarray(_jax_attention(q, k, v, pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_partials_cover_the_rows_each_lane_needs(kv):
    """Chunks at or past hi = min(positions + W, M) have no rows (m at
    -1e30, l and acc 0); every other chunk has a finite max and l >= 1."""
    w = 5
    _, t = _inputs(kv, w)
    q, pos, k, v, ks, vs = t
    mx, l, acc = da.d1_chunk_partials(q, k, v, pos, ks, vs, rows=R)
    assert mx.shape == l.shape == (N, w, H, M // R)
    assert acc.shape == (N, w, H, M // R, D)
    hi = np.minimum(np.array(POSITIONS) + w, M)
    for n in range(N):
        for c in range(M // R):
            if c * R >= hi[n]:
                assert bool((mx[n, :, :, c] == np.float32(-1e30)).all())
                assert bool((l[n, :, :, c] == 0).all())
                assert bool((acc[n, :, :, c] == 0).all())
            else:
                assert bool((l[n, :, :, c] >= 1).all())
                assert bool(torch.isfinite(acc[n, :, :, c]).all())


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_wholly_masked_chunk_weighs_exactly_zero(kv):
    """At W = 5 a chunk can hold rows the lane reads (below positions +
    W) that no row of token j sees: lane 2 at position R + 1 reads rows
    0..R+5, and chunk 2 (rows 2R..3R-1) is invisible to tokens 0..R-2.
    Its m is -1e30, its weight exp(-1e30 - M) an exact 0.0, and the
    output has no NaN and matches the plain version."""
    w = 5
    _, t = _inputs(kv, w)
    q, pos, k, v, ks, vs = t
    mx, l, acc = da.d1_chunk_partials(q, k, v, pos, ks, vs, rows=R)
    out, wgt = da.d1_combine(mx, l, acc)
    lane, chunk, p = 2, 2, POSITIONS[2]
    masked = [j for j in range(w) if chunk * R > p + j]
    assert masked == [0, 1, 2]
    for j in masked:
        assert bool((mx[lane, j, :, chunk] == np.float32(-1e30)).all())
        assert bool((l[lane, j, :, chunk] > 0).all())
        assert bool((wgt[lane, j, :, chunk] == 0.0).all())
    for j in range(3, w):
        assert bool((wgt[lane, j, :, chunk] > 0.0).all())
    assert not bool(torch.isnan(out).any())
    plain = da.decode_attention_plain(q, k, v, pos, ks, vs)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_lane_is_bit_identical_whatever_the_other_lanes(kv, w):
    """Chunk boundaries depend on the row index only, so lane 3's output
    is the same bits whatever positions the other lanes are at."""
    _, t = _inputs(kv, w)
    base = _split(t)
    for seed in range(3):
        other = np.random.RandomState(seed).randint(0, M + 4, N)
        other[3] = POSITIONS[3]
        t2 = list(t)
        t2[1] = torch.from_numpy(other.astype(np.int32))
        assert torch.equal(_split(t2)[3], base[3])


# (n, w, m, h, d, int8, rows) -> (grid, workspace, shared-memory bytes):
# 128 bytes of alignment slack; a head of each chunk's (m, l) a token, w
# denominators, the combine's w x d running sums and two mbarriers, to a
# 128-byte boundary; the K and V tiles, w x R scores, 4 warps' R weights, 2R
# scales (int8), (128 / min(d/4, 16)) groups x d partials and the w q
# rows, or the chunks' partials where larger
PLANS = [
    ((16, 1, 1024, 12, 64, False, 64), ((16, 12, 16), (16, 12, 1, 16, 68),
                                        36992)),
    ((16, 5, 1024, 12, 64, False, 64), ((16, 12, 16), (16, 12, 5, 16, 68),
                                        40576)),
    ((16, 1, 1024, 12, 64, True, 64), ((16, 12, 16), (16, 12, 1, 16, 68),
                                       12928)),
    ((16, 5, 1024, 12, 64, True, 64), ((16, 12, 16), (16, 12, 5, 16, 68),
                                       23936)),
    ((6, 5, 100, 2, 16, False, 32), ((4, 2, 6), (6, 2, 5, 4, 20), 8384)),
    ((2, 16, 100, 3, 256, True, 128), ((1, 3, 2), (2, 3, 16, 1, 260),
                                       118144)),
]


@pytest.mark.parametrize("args,want", PLANS)
def test_d1_plan(args, want):
    plan = da._d1_plan(*args)
    assert plan == da.D1Plan(args[-1], *want)
    assert plan.smem_bytes <= 232448 - 1024


def test_d1_plan_default_rows():
    assert da._d1_plan(16, 1, 1024, 12, 64, False).rows == da.D1_ROWS == 64


def _lone_scale():
    _, (q, pos, k, v, ks, _) = _inputs("int8", 1)
    da.decode_attention(q, k, v, pos, ks, None)


REFUSALS = {
    "head_dim 48": lambda: da._d1_plan(16, 1, 1024, 12, 48, False),
    "head_dim 8": lambda: da._d1_plan(16, 1, 1024, 12, 8, False),
    "head_dim 512": lambda: da._d1_plan(16, 1, 1024, 12, 512, False),
    "W 17": lambda: da._d1_plan(16, 17, 1024, 12, 64, False),
    "W 0": lambda: da._d1_plan(16, 0, 1024, 12, 64, False),
    "2^31 elements": lambda: da._d1_plan(8, 1, 2 ** 20, 4, 64, True),
    "rows 48": lambda: da._d1_plan(16, 1, 1024, 12, 64, False, 48),
    "rows 16": lambda: da._d1_plan(16, 1, 1024, 12, 64, False, 16),
    "rows 512": lambda: da._d1_plan(16, 1, 1024, 12, 64, False, 512),
    "shared memory": lambda: da._d1_plan(2, 16, 1024, 2, 256, False, 128),
    "lone scale": _lone_scale,
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_d1_refuses(what):
    with pytest.raises(MXNetError):
        REFUSALS[what]()
