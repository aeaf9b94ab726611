"""The op set's samplers (the ``random_*`` draws, the per-element
``sample_*`` draws, multinomial with ``get_prob``, shuffle and the
log-uniform ``_sample_unique_zipfian``) and ``nd.random`` against the
JAX package's, on the CPU. Draws cannot be equal across packages, so
each sampler is held to its distribution in both: at 2^16 draws
(seeded: the port's ``random.seed(11)``, the JAX package's
``PRNGKey(11)``) the mean and the variance lie within 5 standard errors
of the distribution's, and ``scipy.stats.kstest`` gives p > 1e-3 (for
a discrete distribution, on the randomized probability integral
transform of the draws, which is uniform under the null). The
port's draws repeat under the same seed, and its shapes and dtypes are
the JAX package's."""
import numpy as np
import pytest
import scipy.stats as st
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import sweep
from mxnet_tpu_torch.ops.registry import get_op

N = 2 ** 16
SEED = 11
PARAMS = sweep.SAMPLER_PARAMS
PROBS = sweep.MULTINOMIAL_PROBS
RANGE_MAX = sweep.SAMPLERS["_sample_unique_zipfian"][0]["range_max"]


def _port_draws(name, kind, n=N, small=False):
    """The port's draws as a list of 1-D numpy rows (``small``: the raw
    output of a small call, for shapes and dtypes)."""
    fn = get_op(name).fn
    if name.startswith("_random_"):
        out = fn(shape=(3, 4) if small else (n,), device="cpu",
                 **sweep.SAMPLERS[name][0])
        return out if small else [out.double().numpy()]
    if kind in PARAMS:
        params = [torch.tensor(c, dtype=torch.float32) for c in PARAMS[kind]]
        out = fn(*params, shape=(3,) if small else (n,))
        return out if small else [r for r in out.double().numpy()]
    if kind == "multinomial":
        out = fn(torch.tensor([PROBS]), shape=(2, 3) if small else n)
        return out if small else [out[0].double().numpy()]
    if kind == "zipfian":
        out = fn(range_max=RANGE_MAX, shape=(5,) if small else (n,),
                 device="cpu")
        return out if small else [out.double().numpy()]
    x = torch.arange(n, dtype=torch.float32)
    out = fn(x[:12].reshape(4, 3) if small else x)
    return out if small else [out.double().numpy()]


def _jax_draws(name, kind, n=N, small=False):
    import jax
    import jax.numpy as jnp
    import mxnet_tpu.ops  # noqa: F401
    from mxnet_tpu.ops.registry import get_op as jget
    fn = jget(name).fn
    key = jax.random.PRNGKey(SEED)
    if name.startswith("_random_"):
        out = fn(shape=(3, 4) if small else (n,), key=key,
                 **sweep.SAMPLERS[name][0])
    elif kind in PARAMS:
        params = [jnp.asarray(c, jnp.float32) for c in PARAMS[kind]]
        out = fn(*params, shape=(3,) if small else (n,), key=key)
    elif kind == "multinomial":
        out = fn(jnp.asarray([PROBS]), shape=(2, 3) if small else n, key=key)
    elif kind == "zipfian":
        out = fn(range_max=RANGE_MAX, shape=(5,) if small else (n,),
                 key=key)
    else:
        x = jnp.arange(n, dtype=jnp.float32)
        out = fn(x[:12].reshape(4, 3) if small else x, key=key)
    if small:
        return out
    out = np.asarray(out, dtype=np.float64)
    return [r for r in out] if kind in PARAMS and \
        name.startswith("_sample_") else [out.reshape(-1)]


def _check_distribution(rows, dists, what):
    for i, (x, d) in enumerate(zip(rows, dists)):
        n = x.size
        mean, var, kurt = (float(v) for v in d.stats(moments="mvk"))
        se_mean = np.sqrt(var / n)
        se_var = var * np.sqrt((kurt + 2.0) / n)
        assert abs(x.mean() - mean) < 5 * se_mean, \
            f"{what} row {i}: mean {x.mean()} vs {mean} (se {se_mean})"
        assert abs(x.var() - var) < 5 * se_var, \
            f"{what} row {i}: var {x.var()} vs {var} (se {se_var})"
        if isinstance(getattr(d, "dist", d), st.rv_discrete):
            # discrete: the randomized probability integral transform
            # F(x - 1) + V (F(x) - F(x - 1)), V uniform, is uniform
            v = np.random.RandomState(SEED).uniform(size=n)
            x = d.cdf(x - 1) + v * (d.cdf(x) - d.cdf(x - 1))
            d = st.uniform(0, 1)
        p = st.kstest(x, d.cdf).pvalue
        assert p > 1e-3, f"{what} row {i}: KS p = {p}"


NAMES = sorted(sweep.SAMPLERS)


@pytest.mark.parametrize("name", NAMES)
def test_sampler_seeded_shapes_dtypes(name):
    """The same seed gives the same draws twice; shapes and dtypes equal
    the JAX package's."""
    kind = sweep.SAMPLERS[name][1]
    mt.random.seed(SEED)
    first = _port_draws(name, kind, n=4096)
    mt.random.seed(SEED)
    again = _port_draws(name, kind, n=4096)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    mt.random.seed(SEED + 1)
    other = _port_draws(name, kind, n=4096)
    assert any(not np.array_equal(a, b) for a, b in zip(first, other))
    p = _port_draws(name, kind, small=True)
    j = _jax_draws(name, kind, small=True)
    assert tuple(p.shape) == tuple(j.shape), name
    assert str(p.dtype).replace("torch.", "") == str(j.dtype), name


@pytest.mark.parametrize("name", NAMES)
def test_sampler_distribution(name):
    """Both packages' draws pass the moment and KS checks."""
    kind = sweep.SAMPLERS[name][1]
    if kind == "shuffle":
        for rows, who in ((_port_draws(name, kind), "port"),
                          (_jax_draws(name, kind), "jax")):
            x = rows[0]
            np.testing.assert_array_equal(np.sort(x), np.arange(N))
            # the first half of a shuffled range is a uniform subset
            _check_distribution([x[:N // 2] / N],
                                [st.uniform(0, 1)], f"{name} {who}")
        return
    mt.random.seed(SEED)
    dists = sweep.sampler_dists(name)
    _check_distribution(_port_draws(name, kind), dists, f"{name} port")
    _check_distribution(_jax_draws(name, kind), dists, f"{name} jax")


def test_multinomial_get_prob():
    """``get_prob`` returns each draw's log probability, as the JAX
    package's."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.registry import get_op as jget
    probs = np.asarray([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    s, lp = get_op("_sample_multinomial").fn(torch.from_numpy(probs),
                                             get_prob=True)
    js, jlp = jget("_sample_multinomial").fn(jnp.asarray(probs),
                                             get_prob=True,
                                             key=jax.random.PRNGKey(0))
    assert s.dtype == torch.int32 and tuple(s.shape) == tuple(js.shape)
    assert tuple(lp.shape) == tuple(jlp.shape)
    np.testing.assert_allclose(
        lp.numpy(), np.log(probs[np.arange(2), s.numpy()]), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jlp), np.log(probs[np.arange(2), np.asarray(js)]),
        rtol=1e-6)


ND_RANDOM = {
    "exponential": {"scale": 2.0, "shape": (3, 4)},
    "gamma": {"alpha": 2.0, "beta": 0.5, "shape": (3, 4)},
    "generalized_negative_binomial": {"mu": 2.0, "alpha": 0.5,
                                      "shape": (3, 4)},
    "negative_binomial": {"k": 3, "p": 0.4, "shape": (3, 4)},
    "poisson": {"lam": 2.0, "shape": (3, 4)},
}


@pytest.mark.parametrize("fn", sorted(ND_RANDOM) + ["multinomial",
                                                    "shuffle"])
def test_nd_random(fn):
    """``nd.random``'s draws: the JAX package's shapes and dtypes, the
    seed repeating them."""
    import mxnet_tpu as mx
    with mt.cpu():
        def port():
            if fn == "multinomial":
                return mt.nd.random.multinomial(
                    mt.nd.array([[0.2, 0.8], [0.5, 0.5]]), shape=3)
            if fn == "shuffle":
                return mt.nd.random.shuffle(mt.nd.arange(10))
            return getattr(mt.nd.random, fn)(**ND_RANDOM[fn])
        mt.random.seed(3)
        a = port().asnumpy()
        mt.random.seed(3)
        b = port().asnumpy()
    np.testing.assert_array_equal(a, b)
    if fn == "multinomial":
        j = mx.nd.random.multinomial(mx.nd.array([[0.2, 0.8], [0.5, 0.5]]),
                                     shape=3).asnumpy()
    elif fn == "shuffle":
        j = mx.nd.random.shuffle(mx.nd.arange(10)).asnumpy()
        np.testing.assert_array_equal(np.sort(a), np.arange(10))
    else:
        j = getattr(mx.nd.random, fn)(**ND_RANDOM[fn]).asnumpy()
    assert a.shape == j.shape and a.dtype == j.dtype, fn
