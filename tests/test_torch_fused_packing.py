"""The port's flat-buffer update against the JAX package's small-parameter
packing, on the CPU.

The JAX package packs every 1-D fp32 trainable parameter, its optimizer
state and every 1-D fp32 aux state into flat buffers, with the
per-parameter lr_mult / wd_mult as per-element vectors, when the rule is
elementwise; a norm-based rule (LARS: ``lbsgd`` with
``warmup_strategy="lars"``) leaves them unpacked
(``mxnet_tpu/module/fused.py``, the module docstring and
``_partition``). The port keeps every trainable master, each optimizer
state leaf and the aux in one flat fp32 buffer each, whatever the rule
(a view per name; parameters sharing (lr_mult, wd) update as one slice
under an elementwise rule, per view otherwise).

Each case trains 3 fused steps from the same initial values and batches
in both packages, with lr_mult and wd_mult that differ between
parameters, and holds the port's params, aux and optimizer state
against the JAX package's (rtol 1e-5, atol 2e-6: the two packages' fp32
products and BatchNorm statistics sum in other orders, the limit of
``tests/test_torch_module_eager.py``).
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from torch_threads import one_torch_thread  # noqa: F401

BATCH = 8
SHAPE = (BATCH, 1, 6, 6)
RTOL, ATOL = 1e-5, 2e-6
LR_MULT = {"pk2_bias": 2.0, "pkbn_beta": 0.5}
WD_MULT = {"pk1_weight": 0.0, "pkbn_gamma": 3.0}
CASES = {
    "sgd_momentum": ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
                             "wd": 1e-3}),
    "lars": ("lbsgd", {"learning_rate": 0.05, "momentum": 0.9,
                       "wd": 1e-3, "warmup_strategy": "lars"}),
}


def _sym(pkg):
    data = pkg.sym.Variable("data")
    # no bias in front of the BatchNorm: its gradient is zero up to
    # rounding, which LARS's trust ratio (a quotient of norms) magnifies
    h = pkg.sym.FullyConnected(pkg.sym.Flatten(data, name="pkflat"),
                               num_hidden=16, name="pk1", no_bias=True)
    h = pkg.sym.BatchNorm(h, name="pkbn", fix_gamma=False)
    h = pkg.sym.Activation(h, act_type="relu", name="pkrelu")
    h = pkg.sym.FullyConnected(h, num_hidden=10, name="pk2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _init():
    s = _sym(tmx)
    a, _, x = s.infer_shape(data=SHAPE)
    rng = np.random.default_rng(21)
    args = {n: (rng.standard_normal(sh) * 0.3).astype(np.float32)
            for n, sh in zip(s.list_arguments(), a)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.abs(rng.standard_normal(sh)) + 0.5).astype(np.float32)
           for n, sh in zip(s.list_auxiliary_states(), x)}
    return args, aux


def _np(v):
    return np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                      else v.detach().cpu().numpy())


def _train(pkg, name, params):
    ctx = "cpu" if pkg is tmx else jmx.cpu()
    arr = torch.from_numpy if pkg is tmx else jmx.nd.array
    mod = pkg.mod.Module(symbol=_sym(pkg), context=ctx, fused=True)
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (BATCH,))])
    args, aux = _init()
    mod.init_params(arg_params={k: arr(v) for k, v in args.items()},
                    aux_params={k: arr(v) for k, v in aux.items()})
    opt = pkg.optimizer.create(name, **params)
    opt.set_lr_mult(dict(LR_MULT))
    opt.set_wd_mult(dict(WD_MULT))
    mod.init_optimizer(optimizer=opt)
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = rng.random(SHAPE).astype(np.float32)
        y = rng.integers(0, 10, (BATCH,)).astype(np.float32)
        mod.forward(pkg.io.DataBatch([arr(x)], [arr(y)]), is_train=True)
        mod.backward()
        mod.update()
    a, x = mod.get_params()
    state = {k: _np(v).copy() for k, v in list(a.items()) + list(x.items())}
    return mod, state, pickle.loads(mod._fused.get_states())["state"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_buffer_update_matches_jax_packing(case):
    name, params = CASES[case]
    tmod, tstate, topt = _train(tmx, name, params)
    jmod, jstate, jopt = _train(jmx, name, params)
    jf = jmod._fused
    if case == "lars":
        assert jf._small_names == []         # norm-based: not packed
    else:
        assert set(jf._small_names) == {"pk2_bias", "pkbn_gamma",
                                         "pkbn_beta"}
    assert jf._aux_small_names == ["pkbn_moving_mean", "pkbn_moving_var"]
    # the port: every master, state leaf and aux lies in one flat buffer
    tf = tmod._fused
    flat = tf._flat_p.untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == flat
               for v in tf._p.values())
    for i, buf in enumerate(tf._flat_state):
        ptr = buf.untyped_storage().data_ptr()
        assert all(leaves[i].untyped_storage().data_ptr() == ptr
                   for leaves in tf._state.values())
    aux = tf._flat_aux.untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == aux
               for v in tf._aux.values())
    assert set(tstate) == set(jstate)
    for k in jstate:
        np.testing.assert_allclose(tstate[k], jstate[k], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{case} {k}")
    for n in jopt:
        assert len(topt[n]) == len(jopt[n]), n
        for a, b in zip(topt[n], jopt[n]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} state {n}")
