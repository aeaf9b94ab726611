"""The port's remaining initializers (``Orthogonal``, ``MSRAPrelu``,
``Bilinear``, ``LSTMBias``, ``FusedRNN``, ``Load``, ``Mixed``) against
the JAX package's, on the CPU.

The deterministic ones (``Bilinear``, ``LSTMBias``, ``FusedRNN`` over a
constant, ``Load``, ``Mixed``) must write exactly the JAX package's
values into a tensor of the same shape. The random ones draw from
torch's generator, not the JAX package's numpy stream, so they are held
by their defining properties: ``Orthogonal`` gives ``scale`` times an
orthonormal set of rows (or columns, when there are more rows than
columns) to 1e-5; ``MSRAPrelu`` a zero-mean normal whose standard
deviation is ``sqrt(2 / (1 + slope^2) / fan)`` within 3% on 40,000
draws. Every one serializes (``dumps``) as the JAX package's does and
``create`` rebuilds it from that string.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import initializer as tinit
from torch_threads import one_torch_thread  # noqa: F401


def _jax_fill(init, name, shape):
    arr = jmx.nd.zeros(shape)
    init(jmx.init.InitDesc(name), arr)
    return arr.asnumpy()


def _port_fill(init, name, shape, gen=None):
    t = torch.zeros(shape)
    init(tinit.InitDesc(name), t, gen)
    return t.numpy()


@pytest.mark.parametrize("shape", [(2, 1, 4, 4), (3, 3, 5, 6),
                                   (1, 2, 7, 3)])
def test_bilinear_exact(shape):
    np.testing.assert_array_equal(
        _port_fill(tinit.Bilinear(), "up_weight", shape),
        _jax_fill(jmx.init.Bilinear(), "up_weight", shape))


@pytest.mark.parametrize("name,forget", [("lstm_i2h_bias", 1.0),
                                         ("lstm_h2h_bias", 2.5),
                                         ("gates_weight", -0.5)])
def test_lstm_bias_exact(name, forget):
    got = _port_fill(tinit.LSTMBias(forget), name, (24,))
    np.testing.assert_array_equal(
        got, _jax_fill(jmx.init.LSTMBias(forget), name, (24,)))
    assert np.all(got[6:12] == forget) and np.all(got[:6] == 0)


FUSED = [(mode, layers, bi, init)
         for mode in ("lstm", "gru", "rnn_tanh")
         for layers in (1, 2) for bi in (False, True)
         for init in ("constant", "none")]


@pytest.mark.parametrize("mode,layers,bi,init", FUSED)
def test_fused_rnn_exact(mode, layers, bi, init):
    h, c_in = 4, 3
    size = mt.ops.nn.rnn_param_size(mode, layers, c_in, h, bi)

    def fused(pkg):
        inner = pkg.init.Constant(0.25) if init == "constant" else None
        return pkg.init.FusedRNN(inner, h, layers, mode, bidirectional=bi,
                                 forget_bias=2.0)

    if init == "constant":
        want = _jax_fill(fused(jmx), "lstm_parameters", (size,))
        got = _port_fill(fused(mt), "lstm_parameters", (size,))
    else:
        # no inner initializer: the dispatching (global) one fills views
        arr = jmx.nd.zeros((size,))
        jmx.init.Constant(-0.5)(jmx.init.InitDesc(
            "lstm_parameters", attrs={"__init__": fused(jmx).dumps()}), arr)
        want = arr.asnumpy()
        t = torch.zeros(size)
        tinit.Constant(-0.5)(tinit.InitDesc(
            "lstm_parameters", attrs={"__init__": fused(mt).dumps()}), t)
        got = t.numpy()
    np.testing.assert_array_equal(got, want)
    assert fused(mt).dumps() == fused(jmx).dumps()


def test_load_exact_and_fallbacks():
    rng = np.random.RandomState(0)
    src = {"arg:fc_weight": rng.randn(3, 4).astype(np.float32),
           "aux:bn_moving_var": rng.rand(5).astype(np.float32)}
    for pkg, fill in ((jmx, _jax_fill), (mt, _port_fill)):
        load = pkg.init.Load(src, default_init=pkg.init.Constant(7.0))
        np.testing.assert_array_equal(fill(load, "fc_weight", (3, 4)),
                                      src["arg:fc_weight"])
        np.testing.assert_array_equal(fill(load, "bn_moving_var", (5,)),
                                      src["aux:bn_moving_var"])
        np.testing.assert_array_equal(fill(load, "other_weight", (2,)),
                                      np.full(2, 7.0, np.float32))
        with pytest.raises(ValueError, match="Shape mismatch"):
            fill(load, "fc_weight", (4, 3))
        with pytest.raises(ValueError, match="no default"):
            fill(pkg.init.Load(src), "missing_weight", (2,))
    # an NDArray and a tensor as sources
    load = tinit.Load({"w": mt.nd.array(src["arg:fc_weight"], ctx="cpu"),
                       "v": torch.tensor(src["aux:bn_moving_var"])})
    np.testing.assert_array_equal(_port_fill(load, "w", (3, 4)),
                                  src["arg:fc_weight"])
    np.testing.assert_array_equal(_port_fill(load, "v", (5,)),
                                  src["aux:bn_moving_var"])


def test_mixed_exact():
    def mixed(pkg):
        return pkg.init.Mixed([".*bias", ".*gamma", ".*"],
                              [pkg.init.Zero(), pkg.init.Constant(1.5),
                               pkg.init.Constant(-2.0)])
    for name, shape in (("fc_bias", (4,)), ("bn_gamma", (3,)),
                        ("fc_weight", (2, 3))):
        np.testing.assert_array_equal(_port_fill(mixed(mt), name, shape),
                                      _jax_fill(mixed(jmx), name, shape))
    with pytest.raises(ValueError, match="did not match"):
        _port_fill(tinit.Mixed(["a.*"], [tinit.Zero()]), "b_weight", (2,))


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 2, 3, 3)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_property(shape, rand_type):
    g = torch.Generator().manual_seed(0)
    w = _port_fill(tinit.Orthogonal(scale=1.3, rand_type=rand_type),
                   "q_weight", shape, g).reshape(shape[0], -1)
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(gram, 1.3 ** 2 * np.eye(gram.shape[0]),
                               atol=1e-5)
    assert tinit.Orthogonal(1.3, rand_type).dumps() == \
        jmx.init.Orthogonal(1.3, rand_type).dumps()


@pytest.mark.parametrize("factor_type,slope", [("avg", 0.25), ("in", 0.0),
                                               ("out", 1.0)])
def test_msra_prelu_property(factor_type, slope):
    shape = (200, 200)
    g = torch.Generator().manual_seed(1)
    w = _port_fill(tinit.MSRAPrelu(factor_type, slope), "c_weight", shape, g)
    want_std = np.sqrt(2.0 / (1 + slope ** 2) / 200.0)
    assert abs(w.std() / want_std - 1) < 0.03
    assert abs(w.mean()) < 3 * want_std / 200
    assert tinit.MSRAPrelu(factor_type, slope).dumps() == \
        jmx.init.MSRAPrelu(factor_type, slope).dumps()


@pytest.mark.parametrize("init", [tinit.Orthogonal(), tinit.MSRAPrelu(),
                                  tinit.Bilinear(), tinit.LSTMBias(0.5),
                                  tinit.FusedRNN("zeros", 4, 1, "lstm")])
def test_create_from_dumps(init):
    again = tinit.create(init.dumps())
    assert type(again) is type(init)
    assert again.dumps() == init.dumps()
    name = json.loads(init.dumps())[0]
    assert type(tinit.create(name) if name != "fusedrnn"
                else again) is type(init)
