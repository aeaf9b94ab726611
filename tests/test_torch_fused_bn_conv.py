"""The port's fused BN-apply(+ReLU)+conv module
(``mxnet_tpu_torch/ops/fused_bn_conv.py``) against the JAX package's
``mxnet_tpu/ops/pallas_fused.py``.

The same numpy inputs go through both. The JAX side runs as its own
tests run it on the CPU: the Pallas kernels in interpret mode. The port
side runs on CPU tensors, so each kernel wrapper takes its plain
PyTorch version; the CUDA and Triton kernels themselves are held
against those plain versions on the card by ``chip_smoke.py``.

Training (``bn_relu_matmul``, the fused ops with batch statistics, the
BN backward's B1/B2 plain versions) is compared in forward and in every
gradient, through ``jax.vjp`` on the JAX side and autograd on the port's,
with the same random cotangents.

Tolerances: fp32 ``rtol 1e-5, atol 1e-5`` (same arithmetic, different
summation order; gradients ``1e-4`` of their scale, as the BN backward
sums B*H*W terms in a different order); bf16 ``atol 2e-2`` relative to the output scale
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
from torch_threads import one_torch_thread  # noqa: F401

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
    tfb.bn_relu_matmul_fwd(x.reshape(9, 4), w.t(), sc, sh)
    tfb.bn_backward_reduce(x, x, x)
    tfb.bn_backward_dx(x, x, x, sc, sc, sh)
    assert tfb.launch_counts() == {"bn_relu_conv_nchw": 0,
                                   "bn_act_prologue": 0,
                                   "bn_relu_matmul_fwd": 0,
                                   "bn_backward_reduce": 0,
                                   "bn_backward_dx": 0}


def test_meta_tensors_give_shapes():
    """Shape inference runs the ops on meta tensors."""
    x = torch.empty(4, 16, 7, 7, device="meta")
    out = tfb.bn_relu_conv_nchw(x, torch.empty(24, 16, device="meta"),
                                torch.empty(16, device="meta"),
                                torch.empty(16, device="meta"))
    assert out.shape == (4, 24, 7, 7) and out.device.type == "meta"


def test_shape_mismatch_raises():
    x, w, sc, sh = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 3, 8))
    with pytest.raises(MXNetError, match="do not fit"):
        tfb.bn_relu_conv_nchw(x, w[:, :3], sc, sh)
    with pytest.raises(MXNetError, match="do not fit"):
        tfb.bn_act_prologue(x, sc[:3], sh)



# ---------------------------------------------------------------------------
# training: bn_relu_matmul (K3) and the fused ops' analytic BN backward
# ---------------------------------------------------------------------------
import jax  # noqa: E402


def _grad_close(got, want, dtype, what):
    scale = max(np.abs(want).max(), 1e-6)
    atol = (1e-4 if dtype == "float32" else 5e-2) * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("mkn", [(64, 24, 32), (48, 8, 16)])
def test_bn_relu_matmul_forward_and_grads_match_jax(mkn, relu, dtype):
    """``bn_relu_matmul`` (K3's plain version on CPU, the JAX custom VJP's
    backward) against the JAX op in interpret mode: the output and the
    gradients of x, w, scale and shift under one random cotangent. Both
    backwards keep dxhat = g @ w.T in fp32, so in bf16 the gradients of
    x, scale and shift round once, from the same fp32 values: to 1e-3 of
    their scale (they read 0 here; a dxhat rounded to bf16 first reads
    up to 7e-3). The bf16 w gradient to 5e-2 of its scale (it reads one
    bf16 step: the fp32 sums of xhat.T @ g round to either side)."""
    m, k, n = mkn
    rng = np.random.default_rng(10)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.3 * rng.standard_normal((k, n))).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, k).astype(np.float32)
    sh = (0.3 * rng.standard_normal(k)).astype(np.float32)
    cot = rng.standard_normal((m, n)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jpf.bn_relu_matmul(*a, relu=relu),
                        *[_j(a, dtype) for a in (x, w, sc, sh)])
    jgrads = vjp(_j(cot, dtype))
    ins = [_t(a, dtype).requires_grad_() for a in (x, w, sc, sh)]
    got = tfb.bn_relu_matmul(*ins, relu=relu)
    tgrads = torch.autograd.grad(got, ins, _t(cot, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(_np(got.detach()), _np(want), dtype)
    for name, g, jg in zip(("x", "w", "scale", "shift"), tgrads, jgrads):
        assert g.dtype == getattr(torch, dtype)
        if dtype == "bfloat16" and name != "w":
            np.testing.assert_allclose(
                _np(g), _np(jg), rtol=0,
                atol=1e-3 * max(np.abs(_np(jg)).max(), 1e-6),
                err_msg=f"grad {name}")
        else:
            _grad_close(_np(g), _np(jg), dtype, f"grad {name}")


def test_bn_relu_matmul_rejects_bad_tiles():
    x, w, sc, sh = (torch.zeros(s) for s in ((512, 64), (64, 256), (64,),
                                             (64,)))
    with pytest.raises(ValueError, match="M % bm"):
        tfb.bn_relu_matmul(x, w, sc, sh, bm=100, bn=128)
    with pytest.raises(ValueError, match="divides M=100"):
        tfb.bn_relu_matmul(torch.zeros(100, 64), w, sc, sh)
    with pytest.raises(ValueError, match="divides N=30"):
        tfb.bn_relu_matmul(x, torch.zeros(64, 30), sc, sh)
    out = tfb.bn_relu_matmul(torch.zeros(100, 64), w, sc, sh, bm=4)
    assert tuple(out.shape) == (100, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,geom", [
    ("_FusedBNReLUConv", None),
    ("_FusedBNReLUConvK", (3, 2, 1)),
    ("_FusedBNReLUConvK", (1, 2, 0)),
    ("_FusedBNReLUConvK", (3, 1, 1))])
@pytest.mark.parametrize("fix_gamma,act", [(False, "relu"), (True, None)])
def test_fused_ops_training_match_jax(op, geom, fix_gamma, act, dtype):
    """Both fused ops in training mode (batch statistics): the output,
    the batch mean and variance, and the gradients of data, gamma, beta
    and weight under random cotangents on all three outputs, against the
    JAX op's custom VJP (``jax.vjp``; Pallas in interpret mode). The
    moving statistics take no gradient in either package. bf16: outputs
    and stats to 2e-2 of their scale, gradients to 5e-2 (the JAX backward
    sums and folds its coefficients in bf16, the port in fp32)."""
    b, c, h, w, o = 4, 8, 7, 6, 16
    rng = np.random.default_rng(12)
    x = (1.5 * rng.standard_normal((b, c, h, w)) + 0.3).astype(np.float32)
    k = geom[0] if geom else None
    params = _op_args(c, o, k, dtype, seed=13)
    attrs = dict(eps=2e-5, fix_gamma=fix_gamma, act_type=act, num_filter=o,
                 no_bias=True, training=True)
    if geom:
        attrs.update(kernel=(k, k), stride=(geom[1],) * 2,
                     pad=(geom[2],) * 2)
    jfn, tfn = jax_get_op(op).fn, torch_get_op(op).fn
    jins = [_j(x, dtype)] + [_j(p, dtype) for p in params]
    want, vjp = jax.vjp(lambda *a: jfn(*a, **attrs), *jins)
    cots = [rng.standard_normal(np.shape(v)).astype(np.float32)
            for v in want]
    jgrads = vjp(tuple(_j(cv, dtype) for cv in cots))
    tins = [_t(x, dtype).requires_grad_()] + \
        [_t(p, dtype).requires_grad_() for p in params]
    got = tfn(*tins, **attrs)
    live = [0, 1, 2, 5]         # data, gamma, beta, weight
    tgrads = torch.autograd.grad(got, [tins[i] for i in live],
                                 [_t(cv, dtype) for cv in cots],
                                 allow_unused=True)
    for g, wv, name in zip(got, want, ("out", "mean", "var")):
        assert tuple(g.shape) == tuple(np.shape(wv)), name
        _close(_np(g.detach()), _np(wv), dtype)
    for i, g in zip(live, tgrads):
        jg = _np(jgrads[i])
        if g is None:           # fix_gamma: gamma is not read
            assert not np.abs(jg).any()
            continue
        _grad_close(_np(g), jg, dtype, f"grad of input {i}")
    for i in (3, 4):            # moving statistics: zero in JAX
        assert not np.abs(_np(jgrads[i])).any()


@pytest.mark.parametrize("layout", ["nchw", "matrix", "channels_last",
                                    "strided"])
@pytest.mark.parametrize("relu", [True, False])
def test_bn_backward_plain_versions_any_strides(layout, relu):
    """B1's and B2's plain versions (the wrappers' CPU path) against
    explicit numpy sums, on an NCHW tensor, a row-major (M, K) matrix, a
    channels-last NCHW view and a strided slice: B1 reduces over every
    axis but axis 1 whatever the strides; B2 assembles dz*scale + x*cx +
    c0, and dz*scale alone. On CUDA the kernels take contiguous NCHW or
    (M, K) tensors only, the layouts the fused ops give them."""
    rng = np.random.default_rng(14)
    shape = (6, 5) if layout == "matrix" else (3, 5, 4, 6)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    dy, x, xh = (torch.from_numpy(a) for a in arrs)
    if layout == "channels_last":
        dy, x, xh = (t.to(memory_format=torch.channels_last)
                     for t in (dy, x, xh))
    if layout == "strided":
        big = [torch.from_numpy(rng.standard_normal((3, 10, 4, 6))
                                .astype(np.float32)) for _ in range(3)]
        dy, x, xh = (t[:, ::2] for t in big)
        arrs = [t.numpy() for t in (dy, x, xh)]
    a_dy, a_x, a_xh = arrs
    if layout == "strided":
        dx_args = [t.contiguous() for t in (dy, x, xh)]
    else:
        dx_args = [dy, x, xh]
    dz = np.where(a_xh > 0, a_dy, 0.0) if relu else a_dy
    axes = tuple(i for i in range(dz.ndim) if i != 1)
    s = tfb.bn_backward_reduce(dy, x, xh if relu else None)
    np.testing.assert_allclose(s.numpy(), np.stack(
        [dz.sum(axis=axes), (dz * a_x).sum(axis=axes)]), rtol=1e-5,
        atol=1e-5)
    c = shape[1]
    sc, cx, c0 = (torch.from_numpy(rng.standard_normal(c)
                                   .astype(np.float32)) for _ in range(3))
    bshape = (1, c) + (1,) * (dz.ndim - 2)
    dy, x, xh = dx_args         # B2 takes contiguous tensors
    dx = tfb.bn_backward_dx(dy, x, xh if relu else None, sc, cx, c0)
    want = dz * sc.numpy().reshape(bshape) + a_x * cx.numpy().reshape(
        bshape) + c0.numpy().reshape(bshape)
    np.testing.assert_allclose(dx.numpy(), want, rtol=1e-5, atol=1e-5)
    dx = tfb.bn_backward_dx(dy, x, xh if relu else None, sc)
    np.testing.assert_allclose(dx.numpy(), dz * sc.numpy().reshape(bshape),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(MXNetError, match="differ"):
        tfb.bn_backward_reduce(dy, x[:1], None)


@pytest.mark.parametrize("relu", [True, False])
def test_bn_backward_takes_fp32_gradient_with_bf16_input(relu):
    """``bn_relu_matmul``'s backward gives B1 and B2 an fp32 dxhat beside
    a bf16 x and xhat: B1's sums are those of the fp32 values (to fp32
    rounding), B2's dx is theirs rounded once to bf16. A (B, C, S)
    tensor is neither NCHW nor (M, K) and is refused."""
    rng = np.random.default_rng(15)
    dy = torch.from_numpy(rng.standard_normal((40, 6)).astype(np.float32))
    x, xh = (torch.from_numpy(rng.standard_normal((40, 6)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    mask = xh if relu else None
    s = tfb.bn_backward_reduce(dy, x, mask)
    dz = torch.where(xh > 0, dy, 0.0) if relu else dy
    want = torch.stack([dz.sum(0), (dz * x.float()).sum(0)])
    np.testing.assert_allclose(s.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    dx = tfb.bn_backward_dx(dy, x, mask, sc)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, (dz * sc).to(torch.bfloat16))
    with pytest.raises(MXNetError, match="not NCHW or"):
        tfb.bn_backward_reduce(dy.reshape(4, 6, 10), x.reshape(4, 6, 10))


def test_kernel_wrappers_carry_no_gradient():
    """The kernel wrappers are forward kernels: their outputs carry no
    gradient on the CPU either (the differentiable ops are the
    autograd.Functions around them)."""
    x, w, sc, sh = (torch.from_numpy(a).requires_grad_()
                    for a in _inputs(1, 4, 3, 3, 8))
    for out in (tfb.bn_relu_conv_nchw(x, w, sc, sh),
                tfb.bn_act_prologue(x, sc, sh),
                tfb.bn_relu_matmul_fwd(x.reshape(9, 4), w.t(), sc, sh)):
        assert not out.requires_grad
