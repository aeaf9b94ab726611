"""The port's imperative layer (``mxnet_tpu_torch.nd``, ``autograd``,
``operator``, ``rtc``) against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages: the JAX package
on CPU JAX (its Pallas hook in interpret mode, as
``tests/test_custom_op.py`` runs it), the port on CPU tensors inside
``with mxnet_tpu_torch.cpu():`` (without a scope the port's default is
``cuda:0``). Tolerances: forward values within 1e-5 relative (+1e-6
absolute) of the JAX package's, gradients within 1e-4 relative (+1e-6):
both packages compute in fp32 with other summation orders.

Not ported, so not tested here: ``test_custom_op.py::test_inside_jit``.
The JAX package also stages ``Custom`` inside ``jax.jit`` through
``pure_callback``; the port has no staged path (``hybridize()`` runs
eagerly), so a Custom op only ever runs eagerly, which the tests below
cover.

The user kernels' CUDA and Triton routes run only on a card; there
``chip_smoke.py`` holds them against their plain versions. Here the hook
takes the plain version, which it does only for CPU tensors.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.kernels import build as tbuild

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_scope():
    with tmx.cpu():
        yield


def _rng(seed=0):
    return np.random.default_rng(seed)


def _inputs():
    r = _rng(0)
    return {"x": r.standard_normal((3, 4)).astype(np.float32),
            "y": r.standard_normal((3, 4)).astype(np.float32),
            "v": r.standard_normal((4,)).astype(np.float32),
            "p": r.uniform(0.5, 2.0, (3, 4)).astype(np.float32),
            "w": r.standard_normal((4, 5)).astype(np.float32),
            "idx": np.array([0, 3, 1], np.float32),
            "img": r.standard_normal((2, 3, 6, 6)).astype(np.float32),
            "k": r.standard_normal((4, 3, 3, 3)).astype(np.float32),
            "g": r.uniform(0.5, 1.5, (3,)).astype(np.float32),
            "b": r.standard_normal((3,)).astype(np.float32)}


# each case: f(nd_module, {name: NDArray}) -> NDArray or tuple of them,
# written once against the API both packages share
OP_CASES = {
    "add": lambda F, a: a["x"] + a["y"],
    "add_broadcast": lambda F, a: a["x"] + a["v"],
    "sub": lambda F, a: a["x"] - a["y"],
    "mul": lambda F, a: a["x"] * a["y"],
    "div": lambda F, a: a["x"] / a["p"],
    "mod": lambda F, a: a["x"] % a["p"],
    "pow": lambda F, a: a["p"] ** a["y"],
    "plus_scalar": lambda F, a: a["x"] + 2.0,
    "rminus_scalar": lambda F, a: 2.0 - a["x"],
    "mul_scalar": lambda F, a: 3.0 * a["x"],
    "div_scalar": lambda F, a: a["x"] / 4.0,
    "rdiv_scalar": lambda F, a: 2.0 / a["p"],
    "power_scalar": lambda F, a: a["x"] ** 2,
    "rpower_scalar": lambda F, a: 2.0 ** a["x"],
    "mod_scalar": lambda F, a: a["x"] % 0.7,
    "neg_abs": lambda F, a: abs(-a["x"]),
    "greater": lambda F, a: a["x"] > a["y"],
    "lesser_equal_scalar": lambda F, a: a["x"] <= 0.25,
    "equal_scalar": lambda F, a: (a["idx"] == 3.0),
    "not_equal": lambda F, a: a["x"] != a["x"] * 1.0,
    "sum_all": lambda F, a: a["x"].sum(),
    "sum_axis": lambda F, a: a["x"].sum(axis=1),
    "mean_keepdims": lambda F, a: a["x"].mean(axis=0, keepdims=True),
    "mean_exclude": lambda F, a: F.mean(a["img"], axis=0, exclude=True),
    "max_axis": lambda F, a: a["x"].max(axis=1),
    "min_all": lambda F, a: a["x"].min(),
    "argmax": lambda F, a: a["x"].argmax(axis=1),
    "norm": lambda F, a: a["x"].norm(),
    "reshape_codes": lambda F, a: a["img"].reshape((0, -1)),
    "reshape_split": lambda F, a: a["img"].reshape((-4, 1, 2, -3, 0)),
    "transpose": lambda F, a: a["x"].T,
    "expand_squeeze": lambda F, a: a["x"].expand_dims(1).squeeze(axis=1),
    "flatten": lambda F, a: a["img"].flatten(),
    "swapaxes": lambda F, a: a["img"].swapaxes(1, 3),
    "slice_axis": lambda F, a: a["img"].slice_axis(2, 1, 4),
    "getitem": lambda F, a: a["img"][1, :, 2:5],
    "exp_log": lambda F, a: (a["x"].exp() + 1.0).log(),
    "sqrt_square": lambda F, a: a["p"].sqrt() + a["x"].square(),
    "relu_sigmoid_tanh": lambda F, a: a["x"].relu() + a["y"].sigmoid()
    + a["x"].tanh(),
    "softmax": lambda F, a: a["x"].softmax(axis=1),
    "log_softmax": lambda F, a: F.log_softmax(a["x"], axis=0),
    "clip": lambda F, a: a["x"].clip(-0.5, 0.5),
    "dot": lambda F, a: F.dot(a["x"], a["w"]),
    "dot_transpose": lambda F, a: F.dot(a["x"], a["y"], transpose_b=True),
    "pick": lambda F, a: F.pick(a["x"], a["idx"], axis=1, keepdims=True),
    "one_hot": lambda F, a: F.one_hot(a["idx"], depth=5),
    "where": lambda F, a: F.where(a["x"] > 0, a["x"], a["y"]),
    "zeros_ones_like": lambda F, a: F.zeros_like(a["x"]) + F.ones_like(
        a["y"]),
    "maximum": lambda F, a: F.broadcast_maximum(a["x"], a["y"]),
    "concat": lambda F, a: F.concat(a["x"], a["y"], dim=0),
    "fully_connected": lambda F, a: F.FullyConnected(
        a["img"], F.reshape(a["img"], shape=(2, -1)), a["v"][:2],
        num_hidden=2),
    "activation_softrelu": lambda F, a: F.Activation(a["x"],
                                                     act_type="softrelu"),
    "convolution": lambda F, a: F.Convolution(
        a["img"], a["k"], kernel=(3, 3), stride=(2, 2), pad=(1, 1),
        num_filter=4, no_bias=True),
    "pooling_max": lambda F, a: F.Pooling(a["img"], kernel=(3, 3),
                                          stride=(2, 2), pad=(1, 1),
                                          pool_type="max"),
    "pooling_global_avg": lambda F, a: F.Pooling(
        a["img"], kernel=(1, 1), global_pool=True, pool_type="avg"),
    "batch_norm_train": lambda F, a: F.BatchNorm(
        a["img"], a["g"], a["b"], a["b"] * 0.0, a["g"], eps=1e-5,
        fix_gamma=False, training=True),
    "batch_norm_eval": lambda F, a: F.BatchNorm(
        a["img"], a["g"], a["b"], a["b"], a["g"], eps=1e-5,
        fix_gamma=False),
}


def _to_np(out):
    if isinstance(out, (tuple, list)):
        return [o.asnumpy() for o in out]
    return [out.asnumpy()]


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_nd_op_matches_jax(case):
    fn = OP_CASES[case]
    ins = _inputs()
    want = _to_np(fn(jnd, {k: jnd.array(v) for k, v in ins.items()}))
    got = _to_np(fn(tnd, {k: tnd.array(v) for k, v in ins.items()}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_nd_creation_and_mutation():
    z = tnd.zeros((2, 3))
    assert z.shape == (2, 3) and z.dtype == np.float32
    assert z.context == tmx.cpu()
    np.testing.assert_array_equal(tnd.ones((2,)).asnumpy(), [1, 1])
    np.testing.assert_array_equal(tnd.full((2,), 7.0).asnumpy(), [7, 7])
    np.testing.assert_array_equal(tnd.arange(4).asnumpy(),
                                  jnd.arange(4).asnumpy())
    np.testing.assert_array_equal(tnd.arange(1, 3, 0.5, repeat=2).asnumpy(),
                                  jnd.arange(1, 3, 0.5, repeat=2).asnumpy())
    a, ja = tnd.array(np.arange(6.0).reshape(2, 3)), \
        jnd.array(np.arange(6.0).reshape(2, 3))
    assert a.dtype == np.float32          # float64 input becomes float32
    for arr in (a, ja):
        arr[0] = 5.0
        arr[:, 2] = -1.0
        arr += 1.0
    np.testing.assert_array_equal(a.asnumpy(), ja.asnumpy())
    b = tnd.zeros((2, 3))
    a.copyto(b)
    c = a.copy()
    a[:] = 0.0
    np.testing.assert_array_equal(b.asnumpy(), ja.asnumpy())
    np.testing.assert_array_equal(c.asnumpy(), ja.asnumpy())
    assert a.astype("float16").dtype == np.float16
    assert a.as_in_context(tmx.cpu()) is a
    assert tnd.array([2.5]).asscalar() == 2.5
    assert len(tnd.ones((4, 2))) == 4


def test_nd_default_context_is_cuda():
    """Without a scope or ctx= the port runs on cuda:0, and raises when
    CUDA is absent instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmx.context.Context._default_ctx.value = None
    try:
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            tnd.zeros((2,))
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            tmx.current_context()
    finally:
        tmx.context.Context._default_ctx.value = None
    with tmx.cpu() as c:
        assert tmx.current_context() == c
        with tmx.gpu(1):
            assert tmx.current_context() == tmx.gpu(1)
            assert tmx.gpu(1).device == torch.device("cuda", 1)
        assert tnd.zeros((1,)).context == tmx.cpu()


def test_random_seed_reproduces_draws():
    tmx.random.seed(3)
    a = tnd.random.uniform(-1, 1, shape=(5,)).asnumpy()
    b = tnd.random.normal(0, 1, shape=(5,)).asnumpy()
    tmx.random.seed(3)
    np.testing.assert_array_equal(tnd.random.uniform(-1, 1, shape=(5,))
                                  .asnumpy(), a)
    np.testing.assert_array_equal(tnd.random.normal(0, 1, shape=(5,))
                                  .asnumpy(), b)
    assert (np.abs(a) <= 1).all()
    st = tmx.random.get_state()
    c = tnd.random.normal(shape=(3,)).asnumpy()
    tmx.random.set_state(st)
    np.testing.assert_array_equal(tnd.random.normal(shape=(3,)).asnumpy(), c)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
def _leaves(pkg_nd, *arrays, req="write"):
    out = [pkg_nd.array(a) for a in arrays]
    for o in out:
        o.attach_grad(req)
    return out


def test_record_backward_matches_jax():
    ins = _inputs()
    grads = {}
    for name, pkg, F in (("jax", jmx, jnd), ("torch", tmx, tnd)):
        x, w = _leaves(F, ins["x"], ins["w"])
        with pkg.autograd.record():
            h = F.dot(x, w).relu()
            loss = (h * h).mean() + (x.sigmoid() * 2.0).sum()
        loss.backward()
        grads[name] = (loss.asnumpy(), x.grad.asnumpy(), w.grad.asnumpy())
    for g, w in zip(grads["torch"], grads["jax"]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=ATOL)


def test_head_gradient_and_two_heads():
    ins = _inputs()
    res = {}
    for name, pkg, F in (("jax", jmx, jnd), ("torch", tmx, tnd)):
        x, = _leaves(F, ins["x"])
        with pkg.autograd.record():
            a = x * 3.0
            b = (x * x).sum(axis=1)
        pkg.autograd.backward([a, b], [F.array(ins["y"]),
                                       F.array(ins["idx"])])
        res[name] = x.grad.asnumpy()
    np.testing.assert_allclose(res["torch"], res["jax"], rtol=GRAD_RTOL,
                               atol=ATOL)


def test_grad_create_graph_matches_jax():
    ins = _inputs()
    res = {}
    for name, pkg, F in (("jax", jmx, jnd), ("torch", tmx, tnd)):
        x, = _leaves(F, ins["x"])
        with pkg.autograd.record():
            y = (x ** 3).sum()
            dx = pkg.autograd.grad(y, x, create_graph=True)
            z = (dx * dx).sum()
        z.backward()
        res[name] = (dx.asnumpy(), x.grad.asnumpy())
    np.testing.assert_allclose(res["torch"][0], 3 * ins["x"] ** 2,
                               rtol=GRAD_RTOL)
    np.testing.assert_allclose(res["torch"][1], 36 * ins["x"] ** 3,
                               rtol=GRAD_RTOL, atol=1e-5)
    for g, w in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=1e-5)


def test_grad_without_create_graph_leaves_buffers():
    x, = _leaves(tnd, _inputs()["x"])
    with tmx.autograd.record():
        y = (x * x).sum()
    g = tmx.autograd.grad(y, [x])[0]
    np.testing.assert_allclose(g.asnumpy(), 2 * _inputs()["x"], rtol=RTOL)
    assert not x.grad.asnumpy().any()      # .grad untouched
    assert x._grad_written_seq is None


def test_pause_and_modes_match_jax():
    ins = _inputs()
    res = {}
    for name, pkg, F in (("jax", jmx, jnd), ("torch", tmx, tnd)):
        ag = pkg.autograd
        x, = _leaves(F, ins["x"])
        assert not ag.is_recording() and not ag.is_training()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            with ag.pause():
                assert not ag.is_recording() and not ag.is_training()
                z = x * 2.0
            with ag.predict_mode():
                assert not ag.is_training()
            y = (x * z).sum()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()
        y.backward()
        res[name] = x.grad.asnumpy()
    np.testing.assert_allclose(res["torch"], 2 * ins["x"], rtol=RTOL)
    np.testing.assert_allclose(res["torch"], res["jax"], rtol=RTOL)


def _sigmoid_function(pkg):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = 1.0 / (1.0 + (-x).exp())
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1.0 - y)
    return Sigmoid()


def test_autograd_function_matches_jax():
    ins = _inputs()
    res = {}
    for name, pkg, F in (("jax", jmx, jnd), ("torch", tmx, tnd)):
        x, = _leaves(F, ins["x"])
        f = _sigmoid_function(pkg)
        with pkg.autograd.record():
            y = f(x)
            loss = (y * F.array(ins["y"])).sum()
        loss.backward()
        res[name] = (y.asnumpy(), x.grad.asnumpy())
    s = 1 / (1 + np.exp(-ins["x"]))
    np.testing.assert_allclose(res["torch"][1], ins["y"] * s * (1 - s),
                               rtol=GRAD_RTOL, atol=ATOL)
    for g, w in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=ATOL)
    # outside record the forward runs and nothing is recorded
    out = _sigmoid_function(tmx)(tnd.array(ins["x"]))
    assert not out.data.requires_grad


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_over_two_backwards_matches_jax(req):
    """torch accumulates into .grad; MXNet's "write" replaces the
    gradient on every backward and only "add" accumulates."""
    ins = _inputs()
    res = {}
    for name, pkg, F in (("jax", jmx, jnd), ("torch", tmx, tnd)):
        x, = _leaves(F, ins["x"], req=req)
        for step in range(2):
            with pkg.autograd.record():
                loss = (x * x * float(step + 1)).sum()
            loss.backward()
        res[name] = x.grad.asnumpy()
    want = 4 * ins["x"] if req == "write" else 6 * ins["x"]
    np.testing.assert_allclose(res["torch"], want, rtol=RTOL)
    np.testing.assert_allclose(res["torch"], res["jax"], rtol=RTOL)


def test_manual_sgd_on_a_leaf_matches_jax():
    """``w -= lr * w.grad`` outside record keeps ``w`` a leaf: the next
    backward still reaches it."""
    ins = _inputs()
    res = {}
    for name, pkg, F in (("jax", jmx, jnd), ("torch", tmx, tnd)):
        w, = _leaves(F, ins["w"])
        x = F.array(ins["x"])
        for _ in range(3):
            with pkg.autograd.record():
                loss = (F.dot(x, w) ** 2).mean()
            loss.backward()
            w -= 0.1 * w.grad
            w[0] = w[0] * 0.5
        res[name] = (w.asnumpy(), w.grad.asnumpy())
    assert res["torch"][1].any()
    for g, want in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(g, want, rtol=GRAD_RTOL, atol=ATOL)


def test_backward_stamps_only_reached_leaves():
    x, w = _leaves(tnd, _inputs()["x"], _inputs()["w"])
    with tmx.autograd.record():
        loss = (x * 2.0).sum()
    loss.backward()
    s1 = x._grad_written_seq
    assert s1 is not None and w._grad_written_seq is None
    with tmx.autograd.record():
        loss = (x * 2.0).sum()
    loss.backward()
    assert x._grad_written_seq == s1 + 1


def test_ops_outside_record_build_no_graph():
    x, = _leaves(tnd, _inputs()["x"])
    y = x * 2.0
    assert not y.data.requires_grad
    with pytest.raises(RuntimeError, match="cannot differentiate"):
        y.backward()


# ---------------------------------------------------------------------------
# Custom ops: the props of tests/test_custom_op.py, in both packages
# ---------------------------------------------------------------------------
def _register_custom(pkg, F, suffix):
    @pkg.operator.register("parity_sigmoid" + suffix)
    class MySigmoidProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return MySigmoid()

    class MySigmoid(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            y = 1.0 / (1.0 + np.exp(-in_data[0].asnumpy()))
            self.assign(out_data[0], req[0], F.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            g = out_grad[0].asnumpy() * y * (1 - y)
            self.assign(in_grad[0], req[0], F.array(g))

    @pkg.operator.register("parity_scaler" + suffix)
    class ScalerProp(pkg.operator.CustomOpProp):
        def __init__(self, scale=1.0):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            prop = self

            class Scaler(pkg.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * prop.scale)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[0] * prop.scale)
            return Scaler()


_register_custom(jmx, jnd, "_jax")
_register_custom(tmx, tnd, "_torch")


@pytest.mark.parametrize("op,kw", [("parity_sigmoid", {}),
                                   ("parity_scaler", {"scale": 3.0})])
def test_custom_op_forward_and_tape_match_jax(op, kw):
    ins = _inputs()
    res = {}
    for name, pkg, F in (("jax", jmx, jnd), ("torch", tmx, tnd)):
        x, = _leaves(F, ins["x"])
        out = F.Custom(F.array(ins["x"]), op_type=f"{op}_{name}", **kw)
        with pkg.autograd.record():
            y = F.Custom(x, op_type=f"{op}_{name}", **kw)
            loss = (y * F.array(ins["y"])).sum()
        loss.backward()
        res[name] = (out.asnumpy(), y.asnumpy(), x.grad.asnumpy())
    if op == "parity_sigmoid":
        np.testing.assert_allclose(res["torch"][0], 1 / (1 + np.exp(
            -ins["x"])), rtol=RTOL)
    else:
        np.testing.assert_allclose(res["torch"][2], 3.0 * ins["y"],
                                   rtol=RTOL)
    for g, w in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=ATOL)


def test_custom_unregistered_raises():
    with pytest.raises(KeyError):
        tnd.Custom(tnd.ones((2,)), op_type="no_such_op")


# ---------------------------------------------------------------------------
# K4: the user-kernel hook
# ---------------------------------------------------------------------------
_CUDA_SRC = r'''
extern "C" __global__ void k(const float* x, float* out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i] * 2.0f;
}
'''
_NAMES = ("parity_double", "parity_scale3")


@pytest.fixture
def _clean_registries():
    """Ops these tests register are removed from both process-wide
    registries afterwards (other tests walk the JAX package's)."""
    yield
    from mxnet_tpu.ops.registry import _OPS as jops
    from mxnet_tpu_torch.ops.registry import _OPS as tops
    for name in _NAMES:
        for ops, ndm in ((jops, jnd), (tops, tnd)):
            ops.pop(name, None)
            if hasattr(ndm, name):
                delattr(ndm, name)


def _cuda_placeholder():
    """A kernel of a CudaModule that has not been compiled: the hook
    must never touch it for a CPU tensor that has a plain version."""
    return tmx.rtc.CudaFunction(tmx.rtc.CudaModule(_CUDA_SRC), "k", None)


def test_register_kernel_op_matches_register_pallas(_clean_registries):
    """``test_custom_op.py::test_register_pallas_op`` through the port's
    hook, against the JAX package's ``register_pallas``."""
    def double_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    jk = jmx.operator.register_pallas(
        "parity_double", double_kernel, out_shape=lambda shapes: shapes[0],
        vjp=lambda ct, x: (ct * 2.0,))
    tk = tmx.operator.register_kernel(
        "parity_double", _cuda_placeholder(),
        out_shape=lambda shapes: shapes[0], vjp=lambda ct, x: (ct * 2.0,),
        plain=lambda x: x * 2.0)
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    np.testing.assert_allclose(tk(tnd.array(x)).asnumpy(),
                               jk(jnd.array(x)).asnumpy())
    np.testing.assert_allclose(tnd.parity_double(tnd.array(x)).asnumpy(),
                               jnd.parity_double(jnd.array(x)).asnumpy())
    # the hook also takes plain tensors
    np.testing.assert_allclose(tk(torch.tensor(x)).numpy(), 2 * x)
    assert tk.launches == 0           # the plain version launches nothing


def test_register_kernel_differentiable_matches_pallas(_clean_registries):
    """``test_custom_op.py::test_pallas_op_differentiable`` through the
    port's hook: the backward is the user's VJP."""
    def scale_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 3.0

    jk = jmx.operator.register_pallas(
        "parity_scale3", scale_kernel, out_shape=lambda shapes: shapes[0],
        vjp=lambda ct, x: (ct * 3.0,))
    vjp_calls = []

    def vjp(ct, x):
        vjp_calls.append(ct.shape)
        return (ct * 3.0,)

    tk = tmx.operator.register_kernel(
        "parity_scale3", _cuda_placeholder(),
        out_shape=lambda shapes: shapes[0], vjp=vjp,
        plain=lambda x: x * 3.0)
    ins = _inputs()
    res = {}
    for name, pkg, F, k in (("jax", jmx, jnd, jk), ("torch", tmx, tnd, tk)):
        x, = _leaves(F, ins["x"])
        with pkg.autograd.record():
            loss = (k(x) * F.array(ins["y"])).sum() + \
                F.parity_scale3(x).sum()
        loss.backward()
        res[name] = (loss.asnumpy(), x.grad.asnumpy())
    assert len(vjp_calls) == 2
    np.testing.assert_allclose(res["torch"][1], 3.0 * ins["y"] + 3.0,
                               rtol=RTOL)
    for g, w in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=ATOL)


def test_hook_out_shape_and_dtype():
    k = tmx.operator.UserKernel(
        _cuda_placeholder(), out_shape=lambda s: (s[0][0],),
        plain=lambda x, y: (x * y).sum(1))
    x = torch.ones(3, 4, dtype=torch.float64)
    out = k(x, torch.full((3, 4), 2.0, dtype=torch.float64))
    assert out.shape == (3,) and out.dtype == torch.float64
    assert not out.requires_grad      # no vjp: not differentiable


def test_cuda_kernel_on_cpu_tensor_without_plain_raises():
    k = tmx.operator.UserKernel(_cuda_placeholder(), out_shape=(4,),
                                name="no_plain")
    with pytest.raises(tmx.MXNetError, match="no plain version"):
        k(torch.ones(4))
    with pytest.raises(tmx.MXNetError, match="no plain version"):
        k(tnd.ones((4,)))
    assert k.launches == 0


def test_hook_rejects_inputs_on_two_devices():
    k = tmx.operator.UserKernel(_cuda_placeholder(), out_shape=(4,),
                                plain=lambda a, b: a + b)
    with pytest.raises(tmx.MXNetError, match="several devices"):
        k(torch.ones(4), torch.ones(4, device="meta"))


def test_cuda_module_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: get_function raises MXNetError; nothing is built and no
    function is handed out."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tbuild, "DEFAULT_NVCC",
                        str(tmp_path / "no" / "nvcc"))
    src = _CUDA_SRC + f"// {tmp_path}\n"      # a source never built
    mod = tmx.rtc.CudaModule(src, options=("-DX=1",))
    with pytest.raises(tmx.MXNetError, match="nvcc not found"):
        mod.get_function("k")
    assert not os.path.exists(mod.cubin)
    assert mod._functions == {} and mod._module is None


def test_cuda_module_cache_key():
    a = tmx.rtc.CudaModule(_CUDA_SRC)
    assert a.cubin == tmx.rtc.CudaModule(_CUDA_SRC).cubin
    assert a.cubin != tmx.rtc.CudaModule(_CUDA_SRC, options=("-DX",)).cubin
    assert a.cubin != tmx.rtc.CudaModule(_CUDA_SRC + " ").cubin
    assert a.ptxas_log() == "" or os.path.exists(a.log_path)


@pytest.mark.parametrize("exports", [(), ("scale3",)])
def test_cuda_module_missing_name_asks_for_extern_c(exports):
    """A name the loaded module lacks (a C++ kernel's name is mangled)
    raises MXNetError naming extern "C", whether or not ``exports`` lists
    it; nothing is handed out."""
    class Driver:
        def cuModuleGetFunction(self, fn, module, name):
            return tmx.rtc.CUDA_ERROR_NOT_FOUND

    mod = tmx.rtc.CudaModule(_CUDA_SRC, exports=exports)
    mod._load = Driver
    with pytest.raises(tmx.MXNetError, match='extern "C"'):
        mod.get_function("scale3")
    assert mod._functions == {}


def test_pallas_entry_points_raise():
    with pytest.raises(NotImplementedError, match="CudaModule"):
        tmx.operator.register_pallas("p", lambda x_ref, o_ref: None,
                                     out_shape=(1,))
    with pytest.raises(NotImplementedError, match="CudaModule"):
        tmx.rtc.PallasModule()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_user_kernel_plain_versions_match_their_library_calls():
    """The plain versions that chip_smoke.py holds the user's CUDA and
    Triton kernels against: double, scale3, and the softmax-CE forward
    and backward against torch's cross-entropy and its gradient."""
    cs = _chip_smoke()
    r = _rng(1)
    x = torch.tensor(r.standard_normal((5, 7)).astype(np.float32))
    np.testing.assert_allclose(cs.double_plain(x), 2 * x.numpy())
    np.testing.assert_allclose(cs.scale3_plain(x), 3 * x.numpy(),
                               rtol=1e-6)
    lab = torch.tensor([0, 6, 3, 3, 1], dtype=torch.float32)
    ct = torch.tensor(r.standard_normal(5).astype(np.float32))
    xl = x.clone().requires_grad_(True)
    ref = torch.nn.functional.cross_entropy(xl, lab.long(),
                                            reduction="none")
    (ref * ct).sum().backward()
    np.testing.assert_allclose(cs.softmax_ce_plain(x, lab), ref.detach(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cs.softmax_ce_bwd_plain(x, lab, ct), xl.grad,
                               rtol=1e-5, atol=1e-6)
