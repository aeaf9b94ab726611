"""Gluon MNIST (the port's counterpart of ``examples/gluon/mnist.py``;
reference: example/gluon/mnist.py): a minimal imperative training loop
(``record`` / ``backward`` / ``Trainer.step``) over an MLP, hybridized
by default, so on the card its forward and backward run as captured
CUDA graphs.

With no dataset the loop trains on the JAX example's learnable
synthetic digits (fixed class prototypes plus noise, drawn with numpy
from a seed). Everything runs on ``--device`` (``cuda:0`` by default,
``cpu`` for a run without a card).

Run: python -m mxnet_tpu_torch.examples.gluon.mnist
     python -m mxnet_tpu_torch.examples.gluon.mnist --device cpu --epochs 1
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn


def build_net():
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(128, activation="relu"),
                nn.Dense(64, activation="relu"),
                nn.Dense(10))
    return net


def synthetic_loader(batch_size, n_batches, seed=0, ctx=None):
    """Batches of (images, labels); the class prototypes are the same
    every epoch, only the noise follows ``seed``."""
    protos = np.random.RandomState(0).rand(10, 28 * 28).astype(np.float32)
    rng = np.random.RandomState(seed + 1)
    for _ in range(n_batches):
        y = rng.randint(0, 10, batch_size)
        x = protos[y] + 0.3 * rng.randn(batch_size, 28 * 28).astype(
            np.float32)
        yield (mx.nd.array(x.reshape(batch_size, 1, 28, 28), ctx=ctx),
               mx.nd.array(y, ctx=ctx))


def train(epochs=5, batch_size=64, lr=0.1, hybridize=True, n_batches=50,
          device="cuda:0"):
    """Train; returns ``(net, last epoch's training accuracy)``."""
    ctx = mx.context.as_context(device)
    net = build_net()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    if hybridize:
        net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    acc = None
    for epoch in range(epochs):
        metric.reset()
        for x, y in synthetic_loader(batch_size, n_batches, seed=epoch,
                                     ctx=ctx):
            with autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            trainer.step(batch_size)
            metric.update([y], [out])
        name, acc = metric.get()
        logging.info("epoch %d: train %s=%.4f", epoch, name, acc)
    return net, acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--no-hybridize", action="store_true")
    ap.add_argument("--device", type=str, default="cuda:0")
    args = ap.parse_args(argv)
    _, acc = train(args.epochs, args.batch_size, args.lr,
                   hybridize=not args.no_hybridize, device=args.device)
    if acc <= 0.9:
        raise SystemExit(f"did not converge: {acc}")
    return acc


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
