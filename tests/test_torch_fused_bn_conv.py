"""The port's fused BN-apply(+ReLU)+conv module
(``mxnet_tpu_torch/ops/fused_bn_conv.py``) against the JAX package's
``mxnet_tpu/ops/pallas_fused.py``.

The same numpy inputs go through both. The JAX side runs as its own
tests run it on the CPU: the Pallas kernels in interpret mode. The port
side runs on CPU tensors, so each kernel wrapper takes its plain
PyTorch version; the CUDA and Triton kernels themselves are held
against those plain versions on the card by ``chip_smoke.py``.

Tolerances: fp32 ``rtol 1e-5, atol 1e-5`` (same arithmetic, different
summation order); bf16 ``atol 2e-2`` relative to the output scale
(``max|want|``). The packages round at different points: XLA keeps
``g * rsqrt(var + eps)`` and ``x*scale + shift`` in fp32 inside a fusion
where PyTorch rounds each op to bf16, so scale/shift may differ by a
bf16 step per channel, and sums of C such terms by about 1% of the
output scale; a wrong scale, shift, ReLU or layout is off by far more.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_fused as jpf
from mxnet_tpu.ops.registry import get_op as jax_get_op

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import fused_bn_conv as tfb
from mxnet_tpu_torch.ops.registry import get_op as torch_get_op

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 2e-2   # times the output scale

# (B, C, H, W, O): S = 49 and 196 as at ResNet-50's late stages, and
# output-channel counts that no multiple of 8 divides
SHAPES = [(2, 16, 7, 7, 32), (2, 8, 14, 14, 24), (1, 12, 5, 6, 20),
          (3, 5, 3, 3, 7)]


def _inputs(b, c, h, w, o, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    wt = (rng.standard_normal((o, c)) / np.sqrt(c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (0.3 * rng.standard_normal(c)).astype(np.float32)
    return x, wt, scale, shift


def _bn_params(c, seed=1):
    rng = np.random.default_rng(seed)
    return {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "beta": (0.2 * rng.standard_normal(c)).astype(np.float32),
            "moving_mean": (0.2 * rng.standard_normal(c)).astype(np.float32),
            "moving_var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _j(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_ATOL * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_relu_conv_nchw_matches_jax(shape, relu, dtype):
    """K1's wrapper (plain version on CPU) against the JAX forward in
    interpret mode (prologue kernel + 1x1 conv)."""
    x, w, sc, sh = _inputs(*shape)
    want, _ = jpf.bn_relu_conv_nchw(_j(x, dtype), _j(w, dtype),
                                    _j(sc, dtype), _j(sh, dtype),
                                    relu=relu, interpret=True)
    got = tfb.bn_relu_conv_nchw(_t(x, dtype), _t(w, dtype), _t(sc, dtype),
                                _t(sh, dtype), relu=relu)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == tuple(want.shape)
    _close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
def test_bn_act_prologue_matches_jax_prologue_kernel(relu, dtype):
    """K2's wrapper against the JAX prologue kernel (interpret mode),
    whose output the interpret branch of bn_relu_conv_nchw returns."""
    x, w, sc, sh = _inputs(2, 6, 9, 11, 4, seed=3)
    _, want = jpf.bn_relu_conv_nchw(_j(x, dtype), _j(w, dtype),
                                    _j(sc, dtype), _j(sh, dtype),
                                    relu=relu, interpret=True)
    got = tfb.bn_act_prologue(_t(x, dtype), _t(sc, dtype), _t(sh, dtype),
                              relu=relu)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _op_args(c, o, k, dtype, seed):
    rng = np.random.default_rng(seed)
    p = _bn_params(c, seed)
    wshape = (o, c) + ((k, k) if k else (1, 1))
    fan_in = int(np.prod(wshape[1:]))
    w = (rng.standard_normal(wshape) / np.sqrt(fan_in)).astype(np.float32)
    names = ("gamma", "beta", "moving_mean", "moving_var")
    return [p[n] for n in names] + [w]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fix_gamma,act", [(False, "relu"), (True, None)])
@pytest.mark.parametrize("shape", [(2, 16, 7, 7, 32), (2, 8, 14, 14, 20)])
def test_fused_bn_relu_conv_op_eval_forward(shape, fix_gamma, act, dtype):
    """``_FusedBNReLUConv``'s eval forward (moving statistics) in both
    packages, with params in the compute dtype as the Predictor stages
    them."""
    b, c, h, w, o = shape
    x = np.random.default_rng(5).standard_normal((b, c, h, w)) \
        .astype(np.float32)
    params = _op_args(c, o, None, dtype, seed=6)
    attrs = dict(eps=2e-5, fix_gamma=fix_gamma, act_type=act,
                 num_filter=o, no_bias=True)
    want = jax_get_op("_FusedBNReLUConv").fn(
        _j(x, dtype), *[_j(p, dtype) for p in params], **attrs)
    got = torch_get_op("_FusedBNReLUConv").fn(
        _t(x, dtype), *[_t(p, dtype) for p in params], **attrs)
    assert len(got) == 3
    _close(_np(got[0]), _np(want[0]), dtype)
    for g, wv in zip(got[1:], want[1:]):   # moving stats pass through
        np.testing.assert_array_equal(_np(g), _np(wv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", [
    # (C, O, kernel, stride, pad, act)
    (8, 12, 3, 2, 1, "relu"),
    (3, 8, 7, 2, 3, None),
    (6, 10, 1, 2, 0, "relu"),
])
def test_fused_bn_relu_conv_k_op_eval_forward(geom, dtype):
    """``_FusedBNReLUConvK``'s eval forward: the prologue then the
    convolution with the node's stride and pad."""
    c, o, k, stride, pad, act = geom
    x = np.random.default_rng(7).standard_normal((2, c, 15, 13)) \
        .astype(np.float32)
    params = _op_args(c, o, k, dtype, seed=8)
    attrs = dict(eps=2e-5, fix_gamma=False, act_type=act,
                 kernel=(k, k), stride=(stride, stride), pad=(pad, pad),
                 num_filter=o, no_bias=True)
    want = jax_get_op("_FusedBNReLUConvK").fn(
        _j(x, dtype), *[_j(p, dtype) for p in params], **attrs)
    got = torch_get_op("_FusedBNReLUConvK").fn(
        _t(x, dtype), *[_t(p, dtype) for p in params], **attrs)
    assert tuple(got[0].shape) == tuple(want[0].shape)
    _close(_np(got[0]), _np(want[0]), dtype)


@pytest.mark.parametrize("n_out,spatial", [
    (64, 3136), (256, 49), (2048, 49), (12, 196), (20, 3000), (7, 2000),
    (512, 1030), (96, 1024)])
def test_tile_rule_matches_jax(n_out, spatial):
    """The pass's applicability rule is the JAX package's, decision and
    bail-out reason alike."""
    assert tfb.select_conv_tiles(n_out, spatial) == \
        jpf.select_conv_tiles(n_out, spatial)
    assert tfb.conv_tile_failure(n_out, spatial) == \
        jpf.conv_tile_failure(n_out, spatial)


def test_cpu_path_does_not_count_launches():
    """On CPU tensors the wrappers run their plain versions: no kernel
    launch is counted."""
    tfb.reset_launch_counts()
    x, w, sc, sh = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 3, 8))
    tfb.bn_relu_conv_nchw(x, w, sc, sh)
    tfb.bn_act_prologue(x, sc, sh)
    assert tfb.launch_counts() == {"bn_relu_conv_nchw": 0,
                                   "bn_act_prologue": 0}


def test_meta_tensors_give_shapes():
    """Shape inference runs the ops on meta tensors."""
    x = torch.empty(4, 16, 7, 7, device="meta")
    out = tfb.bn_relu_conv_nchw(x, torch.empty(24, 16, device="meta"),
                                torch.empty(16, device="meta"),
                                torch.empty(16, device="meta"))
    assert out.shape == (4, 24, 7, 7) and out.device.type == "meta"


def test_requires_grad_raises():
    x, w, sc, sh = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 3, 8))
    with pytest.raises(NotImplementedError, match="next slice"):
        tfb.bn_relu_conv_nchw(x.requires_grad_(), w, sc, sh)
    with pytest.raises(NotImplementedError, match="next slice"):
        tfb.bn_act_prologue(x, sc.requires_grad_(), sh)


def test_shape_mismatch_raises():
    x, w, sc, sh = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 3, 8))
    with pytest.raises(MXNetError, match="do not fit"):
        tfb.bn_relu_conv_nchw(x, w[:, :3], sc, sh)
    with pytest.raises(MXNetError, match="do not fit"):
        tfb.bn_act_prologue(x, sc[:3], sh)

