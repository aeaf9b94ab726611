#!/usr/bin/env python3
"""The discriminator loss of the Gluon dcgan example, iteration by
iteration, in the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python tools/dcgan_d_loss.py [--batch-size 16] [--iterations 20]

Runs each package's example (``examples/gluon/dcgan.py``,
``mxnet_tpu_torch/examples/gluon/dcgan.py``) at its widths (ngf = ndf =
64, nz 100, 64x64) for ``--iterations`` iterations of
``--batch-size`` on the synthetic images, both unhybridized, and prints
one JSON line per package: each iteration's mean ``d_loss`` (the sum of
the real and the fake batch's binary cross-entropies; 2 ln 2 = 1.386 is
chance), their mean, and the last. The packages draw their noise and
initial weights differently, so the trajectories differ; what they
share is where the loss sits against chance.
"""
import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def jax_trajectory(batch, iterations, seed):
    import mxnet_tpu as mx
    spec = importlib.util.spec_from_file_location(
        "_jax_gluon_dcgan", os.path.join(ROOT, "examples/gluon/dcgan.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    mx.random.seed(seed)
    gen, disc = m.build_generator(), m.build_discriminator()
    gen.initialize(mx.init.Normal(0.02))
    disc.initialize(mx.init.Normal(0.02))
    hp = {"learning_rate": 0.0002, "beta1": 0.5}
    g_tr = mx.gluon.Trainer(gen.collect_params(), "adam", hp)
    d_tr = mx.gluon.Trainer(disc.collect_params(), "adam", hp)
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    ones, zeros = mx.nd.ones((batch,)), mx.nd.zeros((batch,))
    out = []
    for real in m.synthetic_batches(batch, iterations):
        noise = mx.nd.random.normal(shape=(batch, 100, 1, 1))
        with mx.autograd.record():
            err_real = loss_fn(disc(real).reshape((-1,)), ones)
            fake = gen(noise)
            err_fake = loss_fn(disc(fake.detach()).reshape((-1,)), zeros)
            d_loss = err_real + err_fake
        d_loss.backward()
        d_tr.step(batch)
        with mx.autograd.record():
            g_loss = loss_fn(disc(fake).reshape((-1,)), ones)
        g_loss.backward()
        g_tr.step(batch)
        out.append(float(d_loss.mean().asscalar()))
    return out


def port_trajectory(batch, iterations, seed):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples.gluon import dcgan
    ctx = mx.cpu()
    gen, disc, g_tr, d_tr, loss_fn = dcgan.setup(batch, device="cpu",
                                                 seed=seed, hybridize=False)
    ones, zeros = mx.nd.ones((batch,), ctx=ctx), mx.nd.zeros((batch,),
                                                              ctx=ctx)
    out = []
    for real, noise in zip(dcgan.synthetic_batches(batch, iterations, ctx),
                           dcgan.noise_batches(batch, 100, iterations, seed,
                                               ctx)):
        d, _ = dcgan.iteration(gen, disc, g_tr, d_tr, loss_fn, real, noise,
                               ones, zeros)
        out.append(float(d.mean().asscalar()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    for name, fn in (("jax", jax_trajectory), ("port", port_trajectory)):
        d = fn(a.batch_size, a.iterations, a.seed)
        print(json.dumps({"package": name, "batch_size": a.batch_size,
                          "iterations": a.iterations, "seed": a.seed,
                          "d_loss": [round(v, 4) for v in d],
                          "mean": float(np.mean(d)), "last": d[-1]}),
              flush=True)


if __name__ == "__main__":
    main()
