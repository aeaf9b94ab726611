"""The port's Gluon examples (``mxnet_tpu_torch/examples/gluon/``) on the
CPU, mirroring ``tests/test_gluon_examples.py``, and held against the
JAX package's examples.

- ``mnist.train`` converges (training accuracy above 0.9, the JAX test's
  bar), hybridized and not.
- ``dcgan.train`` at the JAX test's size: finite losses and ``d_loss``
  below 1.3 (the JAX test's bar).
- A JAX-initialised dcgan (the JAX example's build functions, its
  parameters carried by ``interop.gluon_params_from_jax``) gives the
  same forward in the port (within 1e-5), and one whole iteration (the discriminator on
  the real and the detached fake batch under one tape, then the
  generator through the discriminator, two Adam Trainers) of both
  hybridized nets gives the JAX package's losses, gradients and updated
  parameters: losses within 1e-5, gradients and parameters within 1e-4
  relative L2 (+2e-6 in L2 norm; read: ~1e-6), narrow widths
  (ngf = ndf = 8, batch 4).
- The word language model hybridized (tied weights, dropout 0): one step
  of ``train.py``'s loop against the eager port and the JAX package's
  model (whose hybridized LSTM cannot take its states, so it runs
  unhybridized: ROADMAP.md queue C) within the same limits.

The JAX examples are loaded by file path under private names.
"""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JaxNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples.gluon import dcgan, mnist
from mxnet_tpu_torch.examples.word_language_model import model as tmodel
from mxnet_tpu_torch.name import NameManager as TorchNameManager
from torch_threads import one_torch_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
REL_L2 = 1e-4
FLOOR = 2e-6


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_dcgan():
    return _load("examples/gluon/dcgan.py", "_jax_gluon_dcgan_example")


@pytest.fixture(scope="module")
def jax_wlm():
    return _load("examples/word_language_model/model.py",
                 "_jax_wlm_model_example")


def _close(got, want):
    assert np.linalg.norm(got - want) <= REL_L2 * np.linalg.norm(want) \
        + FLOOR, np.linalg.norm(got - want) / np.linalg.norm(want)


def _params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


@pytest.mark.parametrize("hybridize", [True, False])
def test_gluon_mnist_converges(hybridize):
    _, acc = mnist.train(epochs=3, batch_size=32, n_batches=25,
                         hybridize=hybridize, device="cpu")
    assert acc > 0.9, acc


def test_dcgan_trains():
    _, _, d_loss, g_loss = dcgan.train(epochs=1, batch_size=8,
                                       batches_per_epoch=6, device="cpu")
    assert np.isfinite(d_loss) and np.isfinite(g_loss)
    assert d_loss < 1.3, d_loss


def _dcgan_pair(jax_dcgan, nz=16, width=8, batch=4):
    with JaxNameManager():
        jgen = jax_dcgan.build_generator(ngf=width, nz=nz)
        jdisc = jax_dcgan.build_discriminator(ndf=width)
    jmx.random.seed(0)
    jgen.initialize(jmx.init.Normal(0.02))
    jdisc.initialize(jmx.init.Normal(0.02))
    rng = np.random.default_rng(0)
    noise = rng.standard_normal((batch, nz, 1, 1)).astype(np.float32)
    real = rng.uniform(-1, 1, (batch, 3, 64, 64)).astype(np.float32)
    jdisc(jgen(jmx.nd.array(noise)))       # finishes the deferred init
    with tmx.cpu():
        with TorchNameManager():
            tgen = dcgan.build_generator(ngf=width, nz=nz)
            tdisc = dcgan.build_discriminator(ndf=width)
        tmx.interop.gluon_params_from_jax(_params(jgen), tgen, "cpu")
        tmx.interop.gluon_params_from_jax(_params(jdisc), tdisc, "cpu")
    return jgen, jdisc, tgen, tdisc, noise, real


def test_jax_initialised_dcgan_gives_the_same_forward(jax_dcgan):
    jgen, jdisc, tgen, tdisc, noise, _ = _dcgan_pair(jax_dcgan)
    want = jdisc(jgen(jmx.nd.array(noise))).asnumpy()
    with tmx.cpu():
        tgen.hybridize()
        got = tdisc(tgen(tmx.nd.array(noise))).asnumpy()
    assert got.shape == (4, 1, 1, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dcgan_iteration_matches_jax(jax_dcgan):
    jgen, jdisc, tgen, tdisc, noise, real = _dcgan_pair(jax_dcgan)
    hp = {"learning_rate": 0.0002, "beta1": 0.5}
    jgen.hybridize()
    jdisc.hybridize()
    jtr = [jmx.gluon.Trainer(n.collect_params(), "adam", hp)
           for n in (jgen, jdisc)]
    jloss = jmx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    # the JAX example's iteration, inline (its loop draws its own noise)
    with jmx.autograd.record():
        err_real = jloss(jdisc(jmx.nd.array(real)).reshape((-1,)),
                         jmx.nd.ones((4,)))
        fake = jgen(jmx.nd.array(noise))
        err_fake = jloss(jdisc(fake.detach()).reshape((-1,)),
                         jmx.nd.zeros((4,)))
        jd = err_real + err_fake
    jd.backward()
    jtr[1].step(4)
    with jmx.autograd.record():
        jg = jloss(jdisc(fake).reshape((-1,)), jmx.nd.ones((4,)))
    jg.backward()
    jtr[0].step(4)
    with tmx.cpu():
        tgen.hybridize()
        tdisc.hybridize()
        ttr = [tmx.gluon.Trainer(n.collect_params(), "adam", hp)
               for n in (tgen, tdisc)]
        td, tg = dcgan.iteration(
            tgen, tdisc, ttr[0], ttr[1],
            tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss(),
            tmx.nd.array(real), tmx.nd.array(noise), tmx.nd.ones((4,)),
            tmx.nd.zeros((4,)))
    np.testing.assert_allclose(td.asnumpy(), jd.asnumpy(), atol=ATOL)
    np.testing.assert_allclose(tg.asnumpy(), jg.asnumpy(), atol=ATOL)
    for jnet, tnet in ((jgen, tgen), (jdisc, tdisc)):
        jp = jnet.collect_params()
        for n, p in tnet.collect_params().items():
            _close(p.data().asnumpy(), jp[n].data().asnumpy())
            if p.grad_req != "null":
                _close(p.grad().asnumpy(), jp[n].grad().asnumpy())


def _wlm(pkg_model, vocab=50, width=16):
    return pkg_model.RNNModel("lstm", vocab, width, width, 2, dropout=0.0,
                              tie_weights=True, prefix="wlm_")


def test_word_lm_hybridized_step_matches_eager_and_jax(jax_wlm):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 50, (5, 3)).astype(np.float32)
    target = rng.integers(0, 50, 15).astype(np.float32)
    with JaxNameManager():
        jm = _wlm(jax_wlm)
    jm.initialize(jmx.init.Xavier())
    jh = jm.begin_state(batch_size=3)
    jm(jmx.nd.array(data), jh)
    with jmx.autograd.record():
        jout, jhid = jm(jmx.nd.array(data), jh)
        jl = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(jout,
                                                      jmx.nd.array(target))
    jl.backward()
    want = {n: p.grad().asnumpy() for n, p in jm.collect_params().items()}
    results = {}
    with tmx.cpu():
        for hybrid in (False, True):
            with TorchNameManager():
                tm = _wlm(tmodel)
            tmx.interop.gluon_params_from_jax(_params(jm), tm, "cpu")
            if hybrid:
                tm.hybridize()
            hid = tm.begin_state(batch_size=3)
            with tmx.autograd.record():
                out, hid = tm(tmx.nd.array(data), hid)
                loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
                    out, tmx.nd.array(target))
            loss.backward()
            results[hybrid] = (loss.asnumpy(), [h.asnumpy() for h in hid],
                               {n: p.grad().asnumpy() for n, p in
                                tm.collect_params().items()})
    for hybrid, (loss, hid, grads) in results.items():
        np.testing.assert_allclose(loss, jl.asnumpy(), atol=ATOL)
        for h, w in zip(hid, jhid):
            np.testing.assert_allclose(h, w.asnumpy(), atol=ATOL)
        assert sorted(grads) == sorted(want)
        for n, g in grads.items():
            _close(g, want[n])
