"""Program sharing between bound executors (``Symbol.bind`` /
``simple_bind`` through ``compile.shared_programs``), within the port:
no JAX package is imported, so the file also runs on a CUDA machine
(``python -m pytest --noconftest tests/test_torch_executor_cuda.py``),
where each executor's programs are captured CUDA graphs. Its ``cuda``
cases skip on a machine without a CUDA device.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx


def _mlp():
    data = tmx.sym.Variable("data")
    h = tmx.sym.FullyConnected(data, num_hidden=12, name="x1", no_bias=True)
    h = tmx.sym.BatchNorm(h, name="xbn", fix_gamma=False)
    h = tmx.sym.Activation(h, act_type="relu", name="xrelu")
    h = tmx.sym.FullyConnected(h, num_hidden=5, name="x2")
    return tmx.sym.SoftmaxOutput(h, name="softmax")


def _values(sym, shapes, seed=0):
    a, _, x = sym.infer_shape(**shapes)
    rng = np.random.default_rng(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), a):
        if n.endswith("label"):
            args[n] = rng.integers(0, 5, s).astype(np.float32)
        else:
            args[n] = (rng.standard_normal(s) * 0.5).astype(np.float32)
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("var")
               else 0.1 * rng.standard_normal(s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), x)}
    return args, aux


def _np(a):
    return np.asarray(a.asnumpy())


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_binds_differing_only_in_args_grad_keep_their_own_grads(device):
    """Two binds of one symbol at one shape and grad_req, one with a
    gradient array for ``data`` alone and one with every gradient: each
    gets its own programs, and each one's gradients land in its own
    arrays (on the card, through replays of captured grad programs).
    Tolerance against the CPU bind: rtol 1e-4, atol 1e-5 (fp32 sums in
    another order on the card)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: checks captured grad programs")
    args, aux = _values(_mlp(), {"data": (6, 7)}, seed=9)
    sym = _mlp()
    names = sym.list_arguments()

    def binds(ctx):
        arr = (lambda v: tmx.nd.array(v, ctx=ctx))
        part = sym.bind(ctx, args={n: arr(args[n]) for n in names},
                        args_grad={"data": arr(np.zeros_like(
                            args["data"]))},
                        grad_req="write",
                        aux_states={n: arr(v) for n, v in aux.items()})
        full = sym.simple_bind(ctx=ctx, grad_req="write", data=(6, 7))
        full.copy_params_from({n: arr(args[n]) for n in names},
                              {n: arr(v) for n, v in aux.items()})
        return part, full

    want = {}
    for kind, exe in zip(("part", "full"), binds("cpu")):
        exe.forward(is_train=True)
        exe.backward()
        want[kind] = {n: _np(g) for n, g in exe.grad_dict.items()}
    part, full = binds("cuda:0" if device == "cuda" else "cpu")
    assert part._progs is not full._progs
    assert set(want["part"]) == {"data"}
    assert set(want["full"]) == set(names)
    for _ in range(3):          # warm, capture, replay on the card
        for exe in (part, full):
            exe.forward(is_train=True)
            exe.backward()
    for kind, exe in (("part", part), ("full", full)):
        for n, g in exe.grad_dict.items():
            np.testing.assert_allclose(_np(g), want[kind][n], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{kind}:{n}")
