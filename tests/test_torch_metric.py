"""The port's metrics (``mxnet_tpu_torch.metric``) against the JAX
package's on the same arrays, on the CPU.

Each case builds labels and predictions from one seeded numpy generator,
feeds them to both packages (torch tensors to the port, NDArrays to the
JAX package) over two updates, and compares ``get()``. Both reduce on
the host in numpy from the same float32 values, so the tolerance is
rtol 1e-6 (the order of the float64 sums is the same; this leaves room
for the float32 to float64 casts).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx


def _probs(rng, n, c):
    x = rng.random((n, c)).astype(np.float32) + 1e-3
    return x / x.sum(1, keepdims=True)


def _cls(rng, n=12, c=5):
    return rng.integers(0, c, n).astype(np.float32), _probs(rng, n, c)


def _binary(rng, n=16):
    return rng.integers(0, 2, n).astype(np.float32), _probs(rng, n, 2)


def _reg(rng, n=10):
    y = rng.standard_normal(n).astype(np.float32)
    return y, (y + 0.3 * rng.standard_normal(n)).astype(np.float32)


def _reg2d(rng, n=6):
    y = rng.standard_normal((n, 3)).astype(np.float32)
    return y, (y + 0.3 * rng.standard_normal((n, 3))).astype(np.float32)


def _seq(rng, n=4, t=6, c=7):
    return (rng.integers(0, c, (n, t)).astype(np.float32),
            _probs(rng, n * t, c).reshape(n, t, c))


def _mae_fn(label, pred):
    return float(np.abs(label - pred).mean())


def _sum_count(label, pred):
    return float((pred.argmax(1) == label).sum()), len(label)


CASES = {
    "acc": (lambda p: p.metric.Accuracy(), _cls),
    "acc_by_name": (lambda p: p.metric.create("acc"), _cls),
    "top_k": (lambda p: p.metric.TopKAccuracy(top_k=3), _cls),
    "f1_macro": (lambda p: p.metric.F1(), _binary),
    "f1_micro": (lambda p: p.metric.F1(average="micro"), _binary),
    "mcc_macro": (lambda p: p.metric.MCC(), _binary),
    "mcc_micro": (lambda p: p.metric.MCC(average="micro"), _binary),
    "perplexity": (lambda p: p.metric.Perplexity(ignore_label=None), _seq),
    "perplexity_ignore": (lambda p: p.metric.Perplexity(ignore_label=2),
                          _seq),
    "mae": (lambda p: p.metric.MAE(), _reg),
    "mse": (lambda p: p.metric.MSE(), _reg),
    "rmse": (lambda p: p.metric.RMSE(), _reg2d),
    "ce": (lambda p: p.metric.CrossEntropy(), _cls),
    "nll": (lambda p: p.metric.NegativeLogLikelihood(), _cls),
    "nll_by_name": (lambda p: p.metric.create("nll_loss"), _cls),
    "pearsonr": (lambda p: p.metric.PearsonCorrelation(), _reg),
    "loss": (lambda p: p.metric.Loss(), _reg),
    "torch": (lambda p: p.metric.Torch(), _reg),
    "caffe": (lambda p: p.metric.Caffe(), _reg),
    "custom": (lambda p: p.metric.CustomMetric(_mae_fn), _reg),
    "custom_pair": (lambda p: p.metric.CustomMetric(_sum_count,
                                                    name="hits"), _cls),
    "create_callable": (lambda p: p.metric.create(_mae_fn), _reg),
    "np_decorator": (lambda p: p.metric.np()(_mae_fn), _reg),
    "composite": (lambda p: p.metric.CompositeEvalMetric(
        [p.metric.Accuracy(), p.metric.TopKAccuracy(top_k=2),
         p.metric.CrossEntropy()]), _cls),
    "create_list": (lambda p: p.metric.create(["acc", "ce"]), _cls),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case):
    make, data = CASES[case]
    rng = np.random.default_rng(0)
    tm, jm = make(tmx), make(jmx)
    for _ in range(2):
        label, pred = data(rng)
        tm.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
        jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
    tn, tv = tm.get()
    jn, jv = jm.get()
    assert tn == jn
    np.testing.assert_allclose(np.asarray(tv, np.float64),
                               np.asarray(jv, np.float64), rtol=1e-6)
    tm.reset()
    jm.reset()
    assert str(tm.get_name_value()) == str(jm.get_name_value())


def test_update_dict_name_filters_match_jax():
    rng = np.random.default_rng(1)
    label, pred = _cls(rng)
    other = _probs(rng, 12, 5)
    for pkg, arr in ((tmx, torch.from_numpy), (jmx, jmx.nd.array)):
        m = pkg.metric.CompositeEvalMetric(
            [pkg.metric.Accuracy(output_names=["b_output"])],
            label_names=["lab"])
        m.update_dict({"lab": arr(label), "skip": arr(label)},
                      {"a_output": arr(other), "b_output": arr(pred)})
        if pkg is tmx:
            got = m.get()
        else:
            want = m.get()
    assert got == want


def test_get_config_matches_jax():
    for make in (lambda p: p.metric.Accuracy(axis=1),
                 lambda p: p.metric.TopKAccuracy(top_k=4),
                 lambda p: p.metric.CrossEntropy(eps=1e-8)):
        assert make(tmx).get_config() == make(jmx).get_config()
    with pytest.raises(NotImplementedError):
        tmx.metric.CustomMetric(_mae_fn).get_config()
