"""The port's ``RNN`` and ``Dropout`` ops and L1's plain versions against
the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX package's registry
functions (``mxnet_tpu/ops/nn.py`` ``rnn``, ``_lstm_cell_step``,
``rnn_param_size``, ``rnn_unpack_params``) and the port's, and the
gradients through ``jax.vjp`` and torch's autograd with the same
cotangents. Tolerances (fp32): forwards within 1e-5 relative + 1e-5
absolute (the port hoists the input product over all steps into one
matmul, so the sums run in another order: about 1e-7 here); gradients
within 1e-4 relative + 1e-5 absolute; bf16 within 2e-2 relative +
2e-2 absolute (each package rounds at other places).

- ``RNN``: every mode (lstm, gru, rnn_tanh, rnn_relu), 1 and 2 layers,
  one and two directions, with ``state_outputs``: the output, the final
  states and the gradients of data, the flat parameters and the initial
  states; without ``state_outputs`` the output alone; through ``nd`` and
  ``sym`` (shape inference of the parameters and states, a bound
  executor's forward); a step-by-step LSTM built from the JAX
  package's cell gives the same output.
- L1's plain versions (``ops/lstm_cell.py``) against the JAX package's
  cell and its ``jax.vjp``, fp32 and bf16; the autograd function against
  autograd of the plain cell; shapes it does not take raise.
- ``rnn_param_size`` / ``rnn_unpack_params`` against the JAX package's.
- ``Dropout``: the identity at p = 0 (bit for bit) and outside training;
  at p = 0.3 the kept fraction and the 1 / (1 - p) scale; ``axes``
  broadcast one mask; the generator reproduces a draw; inter-layer
  dropout of ``RNN`` in training only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import lstm_cell as lc
from mxnet_tpu_torch.ops import nn as tnn
from torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
T, N, C, H = 5, 3, 4, 6


def _inputs(mode, layers, bidir, seed=0):
    rng = np.random.RandomState(seed)
    dirs = 2 if bidir else 1
    size = jnn.rnn_param_size(mode, layers, C, H, bidir)
    return {"data": rng.randn(T, N, C).astype(np.float32),
            "params": (rng.uniform(-0.4, 0.4, size)).astype(np.float32),
            "state": (0.3 * rng.randn(layers * dirs, N, H))
            .astype(np.float32),
            "state_cell": (0.3 * rng.randn(layers * dirs, N, H))
            .astype(np.float32)}


def _jax_run(mode, layers, bidir, ins, cts):
    names = ["data", "params", "state"] + (["state_cell"] if mode == "lstm"
                                           else [])

    def f(*args):
        kw = dict(zip(names, args))
        return jnn.rnn(kw["data"], kw["params"], kw["state"],
                       kw.get("state_cell"), state_size=H,
                       num_layers=layers, mode=mode, bidirectional=bidir,
                       state_outputs=True)

    outs, vjp = jax.vjp(f, *[jnp.asarray(ins[n]) for n in names])
    grads = vjp(tuple(jnp.asarray(c) for c in cts))
    return [np.asarray(o) for o in outs], dict(zip(names, map(np.asarray,
                                                              grads)))


def _port_run(mode, layers, bidir, ins, cts):
    names = ["data", "params", "state"] + (["state_cell"] if mode == "lstm"
                                           else [])
    leaves = {n: torch.tensor(ins[n], requires_grad=True) for n in names}
    outs = tnn.rnn(leaves["data"], leaves["params"], leaves["state"],
                   leaves.get("state_cell"), state_size=H,
                   num_layers=layers, mode=mode, bidirectional=bidir,
                   state_outputs=True)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cts])
    return ([o.detach().numpy() for o in outs],
            {n: leaves[n].grad.numpy() for n in names})


def _cotangents(mode, layers, bidir, seed=1):
    rng = np.random.RandomState(seed)
    dirs = 2 if bidir else 1
    shapes = [(T, N, dirs * H)] + [(layers * dirs, N, H)] * \
        (2 if mode == "lstm" else 1)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


CASES = [(m, nl, bi) for m in MODES for nl in (1, 2) for bi in (False, True)]


@pytest.mark.parametrize("mode,layers,bidir", CASES)
def test_rnn_forward_matches_jax(mode, layers, bidir):
    ins = _inputs(mode, layers, bidir)
    cts = _cotangents(mode, layers, bidir)
    want, _ = _jax_run(mode, layers, bidir, ins, cts)
    got, _ = _port_run(mode, layers, bidir, ins, cts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **FWD)


@pytest.mark.parametrize("mode,layers,bidir", CASES)
def test_rnn_gradients_match_jax(mode, layers, bidir):
    ins = _inputs(mode, layers, bidir, seed=2)
    cts = _cotangents(mode, layers, bidir, seed=3)
    _, want = _jax_run(mode, layers, bidir, ins, cts)
    _, got = _port_run(mode, layers, bidir, ins, cts)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **GRAD)


@pytest.mark.parametrize("mode", MODES)
def test_rnn_without_state_outputs(mode):
    ins = _inputs(mode, 2, False)
    cell = jnp.asarray(ins["state_cell"]) if mode == "lstm" else None
    want = jnn.rnn(jnp.asarray(ins["data"]), jnp.asarray(ins["params"]),
                   jnp.asarray(ins["state"]), cell, state_size=H,
                   num_layers=2, mode=mode)
    got = tnn.rnn(torch.tensor(ins["data"]), torch.tensor(ins["params"]),
                  torch.tensor(ins["state"]),
                  torch.tensor(ins["state_cell"]) if mode == "lstm"
                  else None, state_size=H, num_layers=2, mode=mode)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_rnn_bf16_matches_jax():
    ins = _inputs("lstm", 2, False)
    want = jnn.rnn(*[jnp.asarray(ins[n], jnp.bfloat16) for n in
                     ("data", "params", "state", "state_cell")],
                   state_size=H, num_layers=2, mode="lstm")
    got = tnn.rnn(*[torch.tensor(ins[n]).bfloat16() for n in
                    ("data", "params", "state", "state_cell")],
                  state_size=H, num_layers=2, mode="lstm")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16)


def test_rnn_matches_stepwise_jax_cell():
    """One lstm layer equals the JAX package's cell stepped by hand."""
    ins = _inputs("lstm", 1, False, seed=5)
    wx, wh, bx, bh = jnn.rnn_unpack_params(jnp.asarray(ins["params"]),
                                           "lstm", 1, C, H)[0]
    carry = (jnp.asarray(ins["state_cell"][0]), jnp.asarray(ins["state"][0]))
    hs = []
    for t in range(T):
        carry, h = jnn._lstm_cell_step(carry, jnp.asarray(ins["data"][t]),
                                       wx, wh, bx, bh, None)
        hs.append(np.asarray(h))
    got = tnn.rnn(torch.tensor(ins["data"]), torch.tensor(ins["params"]),
                  torch.tensor(ins["state"]), torch.tensor(ins["state_cell"]),
                  state_size=H, num_layers=1, mode="lstm")
    np.testing.assert_allclose(got.numpy(), np.stack(hs), **FWD)


def test_nd_and_sym_rnn_match_op():
    ins = _inputs("lstm", 2, True)
    want = tnn.rnn(*[torch.tensor(ins[n]) for n in
                     ("data", "params", "state", "state_cell")],
                   state_size=H, num_layers=2, mode="lstm",
                   bidirectional=True, state_outputs=True)
    with mt.cpu():
        nd_out = mt.nd.RNN(*[mt.nd.array(ins[n]) for n in
                             ("data", "params", "state", "state_cell")],
                           state_size=H, num_layers=2, mode="lstm",
                           bidirectional=True, state_outputs=True)
    for g, w in zip(nd_out, want):
        np.testing.assert_array_equal(g.asnumpy(), w.numpy())
    data = mt.sym.Variable("data")
    state = mt.sym.Variable("h0")
    cell = mt.sym.Variable("c0")
    out = mt.sym.RNN(data=data, state=state, state_cell=cell, state_size=H,
                     num_layers=2, mode="lstm", bidirectional=True,
                     state_outputs=True, name="rnn")
    assert len(out.list_outputs()) == 1 and len(list(out)) == 3
    args, outs, _ = out.infer_shape(data=(T, N, C))
    shapes = dict(zip(out.list_arguments(), args))
    assert shapes == {"data": (T, N, C),
                      "rnn_parameters": (jnn.rnn_param_size(
                          "lstm", 2, C, H, True),),
                      "h0": (4, N, H), "c0": (4, N, H)}
    assert outs == [(T, N, 2 * H)]
    grp = mt.sym.Group(list(out))
    exe = grp.simple_bind(ctx="cpu", grad_req="null", data=(T, N, C))
    res = exe.forward(is_train=False, data=ins["data"],
                      rnn_parameters=ins["params"], h0=ins["state"],
                      c0=ins["state_cell"])
    for g, w in zip(res, want):
        np.testing.assert_allclose(g.asnumpy(), w.numpy(), **FWD)
    # the same graph in the JAX package's JSON loads in the port
    import mxnet_tpu as jmx
    jd = jmx.sym.Variable("data")
    jout = jmx.sym.RNN(data=jd, state=jmx.sym.Variable("h0"),
                       state_cell=jmx.sym.Variable("c0"), state_size=H,
                       num_layers=2, mode="lstm", bidirectional=True,
                       state_outputs=True, name="rnn")
    loaded = mt.sym.load_json(jout.tojson())
    assert loaded.list_arguments() == out.list_arguments()
    assert loaded.infer_shape(data=(T, N, C))[0] == args


@pytest.mark.parametrize("dtype,tol", [("float32", FWD), ("bfloat16", BF16)])
def test_l1_plain_matches_jax_cell(dtype, tol):
    rng = np.random.RandomState(7)
    xg, hg = rng.randn(N, 4 * H), rng.randn(N, 4 * H)
    b, cp = rng.randn(4 * H), rng.randn(N, H)
    dh, dc = rng.randn(N, H), rng.randn(N, H)
    f32 = [a.astype(np.float32) for a in (xg, hg, b, cp, dh, dc)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jcell(xg_, hg_, b_, cp_):
        z = xg_ + hg_ + b_
        i, f, g, o = jnp.split(z, 4, axis=-1)
        i, f, o = jax.nn.sigmoid(i), jax.nn.sigmoid(f), jax.nn.sigmoid(o)
        c = f * cp_ + i * jnp.tanh(g)
        return o * jnp.tanh(c), c

    jins = [jnp.asarray(a, jdt) for a in f32[:4]]
    (jh, jc), vjp = jax.vjp(jcell, *jins)
    jg = vjp((jnp.asarray(f32[4], jdt), jnp.asarray(f32[5], jdt)))
    tdt = getattr(torch, dtype)
    tins = [torch.tensor(a).to(tdt) for a in f32]
    h, c = lc.lstm_cell_fwd_plain(*tins[:4])
    dz, dcp = lc.lstm_cell_bwd_plain(*tins)
    assert h.dtype == c.dtype == dz.dtype == dcp.dtype == tdt

    def np32(x):
        return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") \
            and not isinstance(x, torch.Tensor) else x.float().numpy()

    np.testing.assert_allclose(np32(h), np32(jh), **tol)
    np.testing.assert_allclose(np32(c), np32(jc), **tol)
    # dz is the gradient of xg, of hg and (summed over rows) of b
    for got, want in ((dz, jg[0]), (dz, jg[1]), (dz.float().sum(0),
                                                 jg[2]), (dcp, jg[3])):
        np.testing.assert_allclose(np32(got), np32(want),
                                   **(GRAD if dtype == "float32" else tol))


def test_l1_matches_reference_step():
    """The plain forward equals the JAX package's ``_lstm_cell_step`` with
    the products done outside (xg = x @ wx.T, hg = h @ wh.T)."""
    rng = np.random.RandomState(8)
    x, hp, cp = (rng.randn(N, C).astype(np.float32),
                 rng.randn(N, H).astype(np.float32),
                 rng.randn(N, H).astype(np.float32))
    wx, wh = (rng.randn(4 * H, C).astype(np.float32),
              rng.randn(4 * H, H).astype(np.float32))
    bx, bh = rng.randn(4 * H).astype(np.float32), \
        rng.randn(4 * H).astype(np.float32)
    (jc, jh), _ = jnn._lstm_cell_step((jnp.asarray(cp), jnp.asarray(hp)),
                                      jnp.asarray(x), jnp.asarray(wx),
                                      jnp.asarray(wh), jnp.asarray(bx),
                                      jnp.asarray(bh), None)
    h, c = lc.lstm_cell_fwd_plain(torch.tensor(x @ wx.T),
                                  torch.tensor(hp @ wh.T),
                                  torch.tensor(bx + bh), torch.tensor(cp))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **FWD)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **FWD)


def test_l1_autograd_matches_plain_autograd():
    rng = np.random.RandomState(9)
    ins = [torch.tensor(rng.randn(*s).astype(np.float32),
                        requires_grad=True)
           for s in ((N, 4 * H), (N, 4 * H), (4 * H,), (N, H))]
    cts = [torch.tensor(rng.randn(N, H).astype(np.float32))
           for _ in range(2)]
    h, c = lc.lstm_cell(*ins)
    torch.autograd.backward((h, c), cts)
    got = [x.grad.clone() for x in ins]
    ref = [x.detach().clone().requires_grad_() for x in ins]
    i, f, g, o = (ref[0] + ref[1] + ref[2]).chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * ref[3] + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    np.testing.assert_allclose(h.detach().numpy(), h2.detach().numpy(),
                               **FWD)
    torch.autograd.backward((h2, c2), cts)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.grad.numpy(), **GRAD)


def test_l1_rejects_bad_shapes():
    z = torch.zeros
    with pytest.raises(MXNetError):
        lc.lstm_cell_fwd(z(N, 4 * H), z(N, 4 * H), z(4 * H), z(N, H + 1))
    with pytest.raises(MXNetError):
        lc.lstm_cell_bwd(z(N, 4 * H), z(N, 4 * H), z(4 * H), z(N, H),
                         z(N, H), z(N + 1, H))
    assert lc.lstm_cell_fwd.launches == 0


@pytest.mark.parametrize("mode,layers,bidir,c_in",
                         [(m, nl, bi, c) for m in MODES for nl in (1, 3)
                          for bi in (False, True) for c in (4, 9)])
def test_rnn_param_size_and_unpack(mode, layers, bidir, c_in):
    size = tnn.rnn_param_size(mode, layers, c_in, H, bidir)
    assert size == jnn.rnn_param_size(mode, layers, c_in, H, bidir)
    flat = np.arange(size, dtype=np.float32)
    want = jnn.rnn_unpack_params(jnp.asarray(flat), mode, layers, c_in, H,
                                 bidir)
    got = tnn.rnn_unpack_params(torch.tensor(flat), mode, layers, c_in, H,
                                bidir)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dropout_p0_and_eval_are_identity():
    x = torch.randn(4, 5)
    assert tnn.dropout(x, p=0.0) is x
    assert tnn.dropout(x, p=0.5, training=False) is x
    with mt.cpu():
        a = mt.nd.array(x.numpy())
        out = mt.nd.Dropout(a, p=0.5)           # not training: identity
        np.testing.assert_array_equal(out.asnumpy(), x.numpy())
        with mt.autograd.record():
            out0 = mt.nd.Dropout(a, p=0.0)
        np.testing.assert_array_equal(out0.asnumpy(), x.numpy())


def test_dropout_keep_fraction_and_scale():
    x = torch.ones(400, 500)
    g = torch.Generator().manual_seed(0)
    out = tnn.dropout(x, p=0.3, generator=g)
    kept = out != 0
    frac = float(kept.float().mean())
    assert abs(frac - 0.7) < 0.005, frac
    np.testing.assert_allclose(out[kept].numpy(), 1.0 / 0.7, rtol=1e-6)
    # always-mode applies outside training, and the generator reproduces
    again = tnn.dropout(x, p=0.3, mode="always", training=False,
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_dropout_axes_broadcast_one_mask():
    x = torch.ones(6, 50, 8)
    out = tnn.dropout(x, p=0.5, axes=(1,),
                      generator=torch.Generator().manual_seed(1))
    # one draw per (row, channel), repeated along axis 1
    assert torch.equal(out, out[:, :1, :].expand_as(out))
    assert 0 < int((out[:, 0, :] == 0).sum()) < 48


def test_nd_dropout_in_training_draws_from_seeded_generator():
    with mt.cpu():
        a = mt.nd.ones((64, 64))
        mt.random.seed(3)
        with mt.autograd.record():
            o1 = mt.nd.Dropout(a, p=0.4).asnumpy()
        mt.random.seed(3)
        with mt.autograd.record():
            o2 = mt.nd.Dropout(a, p=0.4).asnumpy()
    np.testing.assert_array_equal(o1, o2)
    assert 0.5 < float((o1 != 0).mean()) < 0.7


def test_rnn_interlayer_dropout_in_training_only():
    ins = _inputs("lstm", 2, False)
    args = [torch.tensor(ins[n]) for n in ("data", "params", "state",
                                           "state_cell")]
    base = tnn.rnn(*args, state_size=H, num_layers=2, mode="lstm")
    off = tnn.rnn(*args, state_size=H, num_layers=2, mode="lstm", p=0.5,
                  training=False)
    assert torch.equal(base, off)
    on = tnn.rnn(*args, state_size=H, num_layers=2, mode="lstm", p=0.5,
                 training=True, generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(base, on)
    # a single layer has no inter-layer dropout
    one = [torch.tensor(v) for v in _inputs("lstm", 1, False).values()]
    assert torch.equal(
        tnn.rnn(*one, state_size=H, num_layers=1, mode="lstm"),
        tnn.rnn(*one, state_size=H, num_layers=1, mode="lstm", p=0.5,
                training=True))
