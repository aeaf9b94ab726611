"""DCGAN (Radford et al. 2015; the port's counterpart of
``examples/gluon/dcgan.py``; reference: example/gluon/dcgan.py): a
64x64 generator of ``Conv2DTranspose`` stacks and a convolutional
discriminator with ``LeakyReLU``, trained in turns with two Adam
Trainers under autograd. Both nets are hybridized by default, so on the
card each runs as captured CUDA graphs (the discriminator runs three
times an iteration: on the real batch and on the detached fake one
under one tape, then on the fake one for the generator's step).

It trains against the JAX example's low-frequency synthetic images.
The noise is drawn with numpy from ``seed`` on the host, so two runs
(eager and hybridized, or the two packages) see the same noise. Not
ported yet: ``--data`` (images from a folder), which decodes through the
``image`` module (ROADMAP.md A9).

Run: python -m mxnet_tpu_torch.examples.gluon.dcgan
     python -m mxnet_tpu_torch.examples.gluon.dcgan --device cpu \\
         --batches 2 --ngf 8 --ndf 8
"""
import argparse
import logging
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn


def build_generator(ngf=64, nc=3, nz=100):
    net = nn.HybridSequential(prefix="gen_")
    with net.name_scope():
        # nz -> (ngf*8) 4x4 -> (ngf*4) 8x8 -> (ngf*2) 16x16 -> ngf 32x32
        # -> nc 64x64
        net.add(nn.Conv2DTranspose(ngf * 8, 4, 1, 0, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(ngf * 4, 4, 2, 1, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(ngf * 2, 4, 2, 1, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(ngf, 4, 2, 1, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False),
                nn.Activation("tanh"))
    return net


def build_discriminator(ndf=64):
    net = nn.HybridSequential(prefix="disc_")
    with net.name_scope():
        net.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False),
                nn.LeakyReLU(0.2),
                nn.Conv2D(ndf * 2, 4, 2, 1, use_bias=False),
                nn.BatchNorm(), nn.LeakyReLU(0.2),
                nn.Conv2D(ndf * 4, 4, 2, 1, use_bias=False),
                nn.BatchNorm(), nn.LeakyReLU(0.2),
                nn.Conv2D(ndf * 8, 4, 2, 1, use_bias=False),
                nn.BatchNorm(), nn.LeakyReLU(0.2),
                nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return net


def synthetic_batches(batch_size, n, ctx=None):
    """Low-frequency 64x64 images in [-1, 1] (the JAX example's)."""
    rng = np.random.RandomState(0)
    for _ in range(n):
        base = rng.rand(batch_size, 3, 8, 8).astype(np.float32)
        img = base.repeat(8, axis=2).repeat(8, axis=3) * 2 - 1
        yield mx.nd.array(img, ctx=ctx)


def noise_batches(batch_size, nz, n, seed=0, ctx=None):
    """Generator inputs drawn with numpy from ``seed`` on the host."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield mx.nd.array(rng.standard_normal(
            (batch_size, nz, 1, 1)).astype(np.float32), ctx=ctx)


def iteration(gen, disc, g_tr, d_tr, loss_fn, real, noise, real_label,
              fake_label):
    """One discriminator step and one generator step; returns
    ``(d_loss, g_loss)`` (per-sample NDArrays)."""
    batch_size = real.shape[0]
    # discriminator: max log D(x) + log(1 - D(G(z)))
    with autograd.record():
        out_real = disc(real).reshape((-1,))
        err_real = loss_fn(out_real, real_label)
        fake = gen(noise)
        out_fake = disc(fake.detach()).reshape((-1,))
        err_fake = loss_fn(out_fake, fake_label)
        d_loss = err_real + err_fake
    d_loss.backward()
    d_tr.step(batch_size)
    # generator: max log D(G(z))
    with autograd.record():
        out = disc(fake).reshape((-1,))
        g_loss = loss_fn(out, real_label)
    g_loss.backward()
    g_tr.step(batch_size)
    return d_loss, g_loss


def setup(batch_size=16, nz=100, lr=0.0002, beta1=0.5, ngf=64, ndf=64,
          hybridize=True, device="cuda:0", seed=0):
    """The nets (initialized from ``seed``), their Adam Trainers and the
    loss."""
    ctx = mx.context.as_context(device)
    mx.random.seed(seed)
    gen = build_generator(ngf=ngf, nz=nz)
    disc = build_discriminator(ndf=ndf)
    gen.initialize(mx.init.Normal(0.02), ctx=ctx)
    disc.initialize(mx.init.Normal(0.02), ctx=ctx)
    if hybridize:
        gen.hybridize()
        disc.hybridize()
    g_tr = gluon.Trainer(gen.collect_params(), "adam",
                         {"learning_rate": lr, "beta1": beta1})
    d_tr = gluon.Trainer(disc.collect_params(), "adam",
                         {"learning_rate": lr, "beta1": beta1})
    return gen, disc, g_tr, d_tr, gluon.loss.SigmoidBinaryCrossEntropyLoss()


def train(epochs=1, batch_size=16, nz=100, lr=0.0002, beta1=0.5,
          batches_per_epoch=20, data=None, ngf=64, ndf=64, hybridize=True,
          device="cuda:0", seed=0):
    """Train; returns ``(gen, disc, d_loss, g_loss)``, the losses the
    last iteration's means."""
    if data is not None:
        raise MXNetError("dcgan --data: images from a folder decode "
                         "through the image module, which is not ported "
                         "yet (ROADMAP.md A9)")
    ctx = mx.context.as_context(device)
    gen, disc, g_tr, d_tr, loss_fn = setup(batch_size, nz, lr, beta1, ngf,
                                           ndf, hybridize, device, seed)
    real_label = mx.nd.ones((batch_size,), ctx=ctx)
    fake_label = mx.nd.zeros((batch_size,), ctx=ctx)
    d_loss = g_loss = None
    for epoch in range(epochs):
        tic = time.time()
        noises = noise_batches(batch_size, nz, batches_per_epoch,
                               seed + epoch, ctx)
        for real, noise in zip(synthetic_batches(batch_size,
                                                 batches_per_epoch, ctx),
                               noises):
            d_loss, g_loss = iteration(gen, disc, g_tr, d_tr, loss_fn, real,
                                       noise, real_label, fake_label)
        logging.info("epoch %d: d_loss %.3f g_loss %.3f (%.1fs)", epoch,
                     float(d_loss.mean().asscalar()),
                     float(g_loss.mean().asscalar()), time.time() - tic)
    return gen, disc, float(d_loss.mean().asscalar()), \
        float(g_loss.mean().asscalar())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--nz", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.0002)
    ap.add_argument("--batches", type=int, default=20,
                    help="iterations an epoch")
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--ndf", type=int, default=64)
    ap.add_argument("--data", type=str, default=None,
                    help="image folder (not ported yet)")
    ap.add_argument("--no-hybridize", action="store_true")
    ap.add_argument("--device", type=str, default="cuda:0")
    args = ap.parse_args(argv)
    return train(args.epochs, args.batch_size, args.nz, args.lr,
                 batches_per_epoch=args.batches, data=args.data,
                 ngf=args.ngf, ndf=args.ndf,
                 hybridize=not args.no_hybridize, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
