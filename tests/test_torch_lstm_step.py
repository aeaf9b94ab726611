"""The fused LSTM step's CPU side (``mxnet_tpu_torch/ops/lstm_cell.py``):
the layer function ``_LSTMLayer`` (through ``lstm_layer``) on its plain
route, the plain versions of ``lstm_step_fwd`` / ``lstm_step_bwd``, the
staged recurrent weight and the route plan ``_l1_plan``.

The kernels themselves (``kernels/csrc/lstm_step.cu``) run only on the
card; ``chip_smoke.py``'s ``lstm_step`` phase holds them against the
plain versions there. Here the same numpy inputs (seed 0) go through the
JAX package's ``_run_layer`` / ``_lstm_cell_step``
(``mxnet_tpu/ops/nn.py``, jnp in ``lax.scan``: no Pallas kernel) and the
port, at T = 5, N = 4, H = 13 (an odd width, which pads the staged
copies), 2 layers, both directions. Tolerances: fp32 forward within
1e-5 relative + 1e-5 absolute and gradients within 1e-4 + 1e-5 (the same
fp32 arithmetic, sums in another order); the plain steps against
``torch.matmul`` with L1's plain versions within 1e-6 (the same fp32
operations); the float64 gradcheck at its defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import lstm_cell as lc
from mxnet_tpu_torch.ops import nn as tnn

T, N, H, C = 5, 4, 13, 7
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
SAME = dict(rtol=1e-6, atol=1e-6)


def _layer_inputs(seed, h=H, steps=T, n=N, dtype=np.float32):
    r = np.random.default_rng(seed)
    return {"gx": r.standard_normal((steps, n, 4 * h)).astype(dtype),
            "wh": (r.standard_normal((4 * h, h)) * h ** -0.5).astype(dtype),
            "b": (r.standard_normal(4 * h) * 0.1).astype(dtype),
            "h0": (r.standard_normal((n, h)) * 0.5).astype(dtype),
            "c0": (r.standard_normal((n, h)) * 0.5).astype(dtype)}


def _jax_layer(gx, wh, b, h0, c0, reverse):
    """The JAX package's ``_run_layer`` on the hoisted input product:
    data ``gx`` through an identity input weight, the summed bias as
    ``bx`` and a zero ``bh``."""
    g4 = gx.shape[-1]
    (c, h), ys = jnn._run_layer(gx, "lstm", jnp.eye(g4, dtype=gx.dtype), wh,
                                b, jnp.zeros_like(b), h0, c0,
                                reverse=reverse)
    return ys, h, c


@pytest.mark.parametrize("reverse", [False, True])
def test_layer_forward_matches_jax_run_layer(reverse):
    ins = _layer_inputs(0)
    want = _jax_layer(*[jnp.asarray(ins[k]) for k in
                        ("gx", "wh", "b", "h0", "c0")], reverse)
    got = lc.lstm_layer(*[torch.tensor(ins[k]) for k in
                          ("gx", "wh", "b", "h0", "c0")], reverse=reverse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


@pytest.mark.parametrize("reverse", [False, True])
def test_layer_gradients_match_jax_grad(reverse):
    names = ("gx", "wh", "b", "h0", "c0")
    ins = _layer_inputs(1)
    r = np.random.default_rng(2)
    gy = r.standard_normal((T, N, H)).astype(np.float32)
    gh = r.standard_normal((N, H)).astype(np.float32)
    gc = r.standard_normal((N, H)).astype(np.float32)

    def loss(*a):
        ys, h, c = _jax_layer(*a, reverse)
        return (jnp.sum(ys * gy) + jnp.sum(h * gh) + jnp.sum(c * gc))

    want = jax.grad(loss, argnums=tuple(range(5)))(
        *[jnp.asarray(ins[k]) for k in names])
    leaves = [torch.tensor(ins[k], requires_grad=True) for k in names]
    ys, h, c = lc.lstm_layer(*leaves, reverse=reverse)
    ((ys * torch.tensor(gy)).sum() + (h * torch.tensor(gh)).sum()
     + (c * torch.tensor(gc)).sum()).backward()
    for name, leaf, w in zip(names, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_op_two_layers_matches_jax(bidirectional):
    """The whole ``RNN`` op (2 layers, H 13) through the layer function,
    forward and the gradients of data, parameters and both states."""
    layers, dirs = 2, 2 if bidirectional else 1
    size = tnn.rnn_param_size("lstm", layers, C, H, bidirectional)
    r = np.random.default_rng(3)
    ins = [r.standard_normal((T, N, C)).astype(np.float32),
           (r.uniform(-1, 1, size) * H ** -0.5).astype(np.float32),
           (r.standard_normal((layers * dirs, N, H)) * 0.5)
           .astype(np.float32),
           (r.standard_normal((layers * dirs, N, H)) * 0.5)
           .astype(np.float32)]
    kw = dict(state_size=H, num_layers=layers, mode="lstm",
              bidirectional=bidirectional, state_outputs=True)
    gy = [r.standard_normal(s).astype(np.float32) for s in
          ((T, N, dirs * H), (layers * dirs, N, H), (layers * dirs, N, H))]

    def jloss(*a):
        outs = jnn.rnn(*a, **kw)
        return sum(jnp.sum(o * g) for o, g in zip(outs, gy))

    jouts = jnn.rnn(*[jnp.asarray(x) for x in ins], **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(x) for x in ins])
    leaves = [torch.tensor(x, requires_grad=True) for x in ins]
    outs = tnn.rnn(*leaves, **kw)
    sum((o * torch.tensor(g)).sum() for o, g in zip(outs, gy)).backward()
    for o, w in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w), **FWD)
    for leaf, w in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD)


def _step_inputs(dtype=torch.float32, seed=4):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dtype)

    return (r(N, 4 * H), r(N, H, scale=0.5), r(4 * H, H, scale=H ** -0.5),
            r(4 * H, scale=0.1), r(N, H, scale=0.5))


def test_step_fwd_plain_is_matmul_and_l1_plain():
    xg, h_prev, wh, b, cp = _step_inputs()
    h, c, z = lc.lstm_step_fwd_plain(xg, h_prev, wh, b, cp)
    hg = torch.matmul(h_prev, wh.t())
    wh_, wc_ = lc.lstm_cell_fwd_plain(xg, hg, b, cp)
    np.testing.assert_allclose(h.numpy(), wh_.numpy(), **SAME)
    np.testing.assert_allclose(c.numpy(), wc_.numpy(), **SAME)
    np.testing.assert_allclose(z.numpy(), (xg + hg + b).numpy(), **SAME)


def test_step_fwd_plain_bf16_rounds_once():
    """In bf16 the product and the cell stay fp32 and each output is
    rounded once: L1's plain forward on the fp32 product gives the same
    bits."""
    xg, h_prev, wh, b, cp = _step_inputs(torch.bfloat16)
    h, c, z = lc.lstm_step_fwd_plain(xg, h_prev, wh, b, cp)
    hg = torch.matmul(h_prev.float(), wh.float().t())
    wh_, wc_ = lc.lstm_cell_fwd_plain(xg, hg, b, cp)
    assert h.dtype == c.dtype == z.dtype == torch.bfloat16
    assert torch.equal(h, wh_) and torch.equal(c, wc_)
    assert torch.equal(z, (xg.float() + hg + b.float()).bfloat16())


def test_step_bwd_plain_is_l1_plain_and_matmul():
    xg, h_prev, wh, b, cp = _step_inputs()
    g = torch.Generator().manual_seed(5)
    dy, dh_rec, dc = (torch.randn((N, H), generator=g) for _ in range(3))
    hg = torch.matmul(h_prev, wh.t())
    z = xg + hg + b
    dz, dcp, dhp = lc.lstm_step_bwd_plain(dy, dh_rec, dc, z, cp, wh)
    wdz, wdcp = lc.lstm_cell_bwd_plain(xg, hg, b, cp, dy + dh_rec, dc)
    np.testing.assert_allclose(dz.numpy(), wdz.numpy(), **SAME)
    np.testing.assert_allclose(dcp.numpy(), wdcp.numpy(), **SAME)
    np.testing.assert_allclose(dhp.numpy(), torch.matmul(wdz, wh).numpy(),
                               **SAME)


def test_step_wrappers_write_their_outputs_on_cpu():
    xg, h_prev, wh, b, cp = _step_inputs()
    w = lc.StagedWeight(wh, None, None)
    h, c, z, hn = (torch.empty(N, H), torch.empty(N, H),
                   torch.empty(N, 4 * H), torch.empty(N, H))
    lc.lstm_step_fwd(xg, h_prev, w, b, cp, h, c, z, hn)
    want = lc.lstm_step_fwd_plain(xg, h_prev, wh, b, cp)
    for got, ref in zip((h, c, z, hn), want + (want[0],)):
        assert torch.equal(got, ref)
    dy, dh_rec, dc = torch.ones(N, H), torch.zeros(N, H), torch.ones(N, H)
    outs = (torch.empty(N, 4 * H), torch.empty(N, H), torch.empty(N, H))
    lc.lstm_step_bwd(dy, dh_rec, dc, z, cp, w, *outs)
    for got, ref in zip(outs, lc.lstm_step_bwd_plain(dy, dh_rec, dc, z, cp,
                                                     wh)):
        assert torch.equal(got, ref)
    with pytest.raises(MXNetError):
        lc.lstm_step_fwd(xg, h_prev, w, b, cp, h, c, torch.empty(N, H), hn)
    with pytest.raises(MXNetError):
        lc.lstm_step_bwd(dy, dh_rec.bfloat16(), dc, z, cp, w, *outs)
    assert lc.lstm_step_fwd.launches == 0 and lc.lstm_step_bwd.launches == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_layer_gradcheck_float64(reverse):
    ins = _layer_inputs(6, h=3, steps=3, n=2, dtype=np.float64)
    leaves = tuple(torch.tensor(ins[k], requires_grad=True) for k in
                   ("gx", "wh", "b", "h0", "c0"))
    assert torch.autograd.gradcheck(
        lambda *a: lc.lstm_layer(*a, reverse=reverse), leaves)


def _unstage(w, h):
    """wh rebuilt from the two staged copies, and the copies' entries
    that hold no weight (which must be 0)."""
    hp = 16 * -(-h // 16)
    back_f = torch.zeros(4 * h, h, dtype=w.fwd.dtype)
    pad_f = torch.ones_like(w.fwd, dtype=torch.bool)
    for row in range(4 * hp):
        p, q, j = row // 64, (row % 64) // 16, row % 16
        unit = 16 * p + j
        if unit < h:
            back_f[q * h + unit] = w.fwd[row, :h]
            pad_f[row, :h] = False
    back_b = torch.zeros(4 * h, h, dtype=w.bwd.dtype)
    pad_b = torch.ones_like(w.bwd, dtype=torch.bool)
    for col in range(4 * hp):
        step, c = col // 16, col % 16
        unit = 16 * (step // 4) + 4 * ((c % 8) // 2) + step % 4
        gate = c % 2 + 2 * (c // 8)
        if unit < h:
            back_b[gate * h + unit] = w.bwd[:h, col]
            pad_b[:h, col] = False
    return back_f, pad_f, back_b, pad_b


@pytest.mark.parametrize("h", [13, 40])
def test_stage_recurrent_weight_round_trips(h):
    wh = torch.randn(4 * h, h, generator=torch.Generator().manual_seed(h))
    w = lc.stage_recurrent_weight(wh)
    hp = 16 * -(-h // 16)
    assert w.wh is wh
    assert w.fwd.shape == (4 * hp, hp) and w.bwd.shape == (672, 4 * hp)
    back_f, pad_f, back_b, pad_b = _unstage(w, h)
    assert torch.equal(back_f, wh) and torch.equal(back_b, wh)
    assert not w.fwd[pad_f].any() and not w.bwd[pad_b].any()
    # one buffer: the backward's copy starts 16-byte aligned after it
    assert w.bwd.data_ptr() - w.fwd.data_ptr() == 4 * hp * hp * 4


def test_stage_recurrent_weight_rejects_other_shapes():
    with pytest.raises(MXNetError):
        lc.stage_recurrent_weight(torch.zeros(4 * H, H + 1))


def test_l1_plan_routes():
    bf16, f32 = torch.bfloat16, torch.float32
    cuda = torch.device("cuda", 0)
    for dev in ("cpu", "meta"):
        assert lc._l1_plan(bf16, 512, 650, dev).route == "plain"
        assert lc._l1_plan(torch.float16, 3, 7, dev).route == "plain"
    assert lc._l1_plan(f32, 512, 650, cuda).route == "triton"
    p = lc._l1_plan(bf16, 512, 650, cuda)
    assert p.route == "fused" and p.hp == 656
    assert p.fwd_tile == lc.L1_FWD_TILE and p.bwd_slices == lc.L1_BWD_SLICES
    bm, bn = p.fwd_tile
    assert p.fwd_grid == (-(-2624 // bn), -(-512 // bm))
    assert p.bwd_grid == (p.bwd_slices, 8)
    assert p.fwd_smem <= 232448 and p.bwd_smem <= 232448
    for tile in lc._FWD_TILES:
        assert lc._l1_plan(bf16, 512, 650, cuda, fwd_tile=tile).fwd_tile \
            == tile
    assert lc._l1_plan(bf16, 512, 650, cuda, bwd_slices=4).bwd_stages == 1
    for bad in (dict(dtype=torch.float16), dict(dtype=torch.float64),
                dict(h=13), dict(h=674), dict(h=0)):
        args = dict(dtype=bf16, n=512, h=650, device=cuda)
        args.update(bad)
        with pytest.raises(MXNetError):
            lc._l1_plan(**args)
    with pytest.raises(MXNetError):
        lc._l1_plan(bf16, 512, 650, cuda, fwd_tile=(32, 32))
    with pytest.raises(MXNetError):
        lc._l1_plan(bf16, 512, 650, cuda, bwd_slices=3)
    with pytest.raises(MXNetError):
        lc._l1_plan(bf16, 512, 650, "xpu")


@pytest.mark.parametrize("dtype,h", [(torch.float16, 12),
                                     (torch.bfloat16, 13),
                                     (torch.bfloat16, 700)])
def test_cuda_layers_the_kernels_do_not_take_raise(dtype, h):
    """On (fake) CUDA tensors an LSTM layer, or a step, of a dtype or
    width no route takes raises before anything launches; nothing runs
    the plain steps instead."""
    ct = torch.promote_types(dtype, torch.float32)
    with FakeTensorMode():
        def e(*shape, dt=dtype):
            return torch.empty(shape, device="cuda", dtype=dt)

        with pytest.raises(MXNetError):
            lc.lstm_layer(e(2, 4, 4 * h), e(4 * h, h), e(4 * h), e(4, h),
                          e(4, h))
        w = lc.StagedWeight(e(4 * h, h), None, None)
        with pytest.raises(MXNetError):
            lc.lstm_step_fwd(e(4, 4 * h), e(4, h), w, e(4 * h), e(4, h),
                             e(4, h), e(4, h))
        with pytest.raises(MXNetError):
            lc.lstm_step_bwd(e(4, h), e(4, h, dt=ct), e(4, h, dt=ct),
                             e(4, 4 * h), e(4, h), w, e(4, 4 * h),
                             e(4, h, dt=ct), e(4, h, dt=ct))
    assert lc.lstm_step_fwd.launches == 0
    assert lc.lstm_step_bwd.launches == 0
