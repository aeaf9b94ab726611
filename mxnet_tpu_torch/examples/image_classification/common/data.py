"""Data iterators of the image-classification examples (the port's copy
of ``examples/image_classification/common/data.py``; reference:
example/image-classification/common/data.py).

``SyntheticDataIter`` makes the JAX example's numpy draws from the same
seeds, so both packages train on the same batches; its arrays are
NDArrays on the current context (``fit.fit`` runs the data loader inside
the run's device context, so the batches already lie on the card).
``get_mnist_iter`` reads the MNIST idx files from ``--data-dir`` and
falls back to a learnable synthetic set of MNIST's shape. ``get_rec_iter``
is synthetic under ``--benchmark 1``; reading RecordIO images needs
``ImageRecordIter``, which is not ported (ROADMAP.md A9).
"""
from __future__ import annotations

import argparse
import gzip
import os
import struct

import numpy as np

import mxnet_tpu_torch as mx


def add_data_args(parser: argparse.ArgumentParser):
    data = parser.add_argument_group("Data", "the input images")
    data.add_argument("--data-train", type=str, help="the training data (.rec)")
    data.add_argument("--data-val", type=str, help="the validation data (.rec)")
    data.add_argument("--rgb-mean", type=str, default="123.68,116.779,103.939",
                      help="a tuple of size 3 for the mean rgb")
    data.add_argument("--image-shape", type=str, default="3,224,224",
                      help="the image shape feed into the network")
    data.add_argument("--num-classes", type=int, default=1000,
                      help="the number of classes")
    data.add_argument("--num-examples", type=int, default=1281167,
                      help="the number of training examples")
    data.add_argument("--data-nthreads", type=int, default=4,
                      help="number of decode workers")
    data.add_argument("--benchmark", type=int, default=0,
                      help="if 1, run on synthetic data of --image-shape")
    return data


def add_aug_args(parser: argparse.ArgumentParser):
    aug = parser.add_argument_group("Augmentation", "image augmentations")
    aug.add_argument("--random-crop", type=int, default=1)
    aug.add_argument("--random-mirror", type=int, default=1)
    aug.add_argument("--max-random-scale", type=float, default=1)
    aug.add_argument("--min-random-scale", type=float, default=1)
    return aug


class SyntheticDataIter(mx.io.DataIter):
    """Deterministic synthetic classification batches.

    With ``learnable`` each class is a fixed random prototype and a
    sample is its prototype plus noise, so a short training converges;
    the prototypes come from ``proto_seed``, so train and validation sets
    of other sample seeds describe the same task. Without it one random
    batch repeats (the reference's ``--benchmark`` data)."""

    def __init__(self, num_classes, data_shape, num_batches=100,
                 dtype="float32", label_name="softmax_label",
                 learnable=False, noise=0.3, seed=0, proto_seed=42):
        super().__init__()
        self.batch_size = data_shape[0]
        self.cur_batch = 0
        self.num_batches = num_batches
        rng = np.random.RandomState(seed)
        if learnable:
            n = self.batch_size * num_batches
            label = rng.randint(0, num_classes, (n,))
            protos = np.random.RandomState(proto_seed).randn(
                num_classes, *data_shape[1:])
            data = protos[label] + noise * rng.randn(n, *data_shape[1:])
            self.data = [mx.nd.array(
                data[i * self.batch_size:(i + 1) * self.batch_size]
                .astype(dtype)) for i in range(num_batches)]
            self.label = [mx.nd.array(
                label[i * self.batch_size:(i + 1) * self.batch_size]
                .astype(np.float32)) for i in range(num_batches)]
        else:
            label = rng.randint(0, num_classes, (self.batch_size,))
            data = rng.uniform(-1, 1, data_shape)
            self.data = [mx.nd.array(data.astype(dtype))]
            self.label = [mx.nd.array(label.astype(np.float32))]
        self.data_shape = data_shape
        self.label_name = label_name

    @property
    def provide_data(self):
        return [mx.io.DataDesc("data", self.data_shape)]

    @property
    def provide_label(self):
        return [mx.io.DataDesc(self.label_name, (self.batch_size,))]

    def reset(self):
        self.cur_batch = 0

    def next(self):
        if self.cur_batch >= self.num_batches:
            raise StopIteration
        i = self.cur_batch % len(self.data)
        self.cur_batch += 1
        return mx.io.DataBatch(data=[self.data[i]], label=[self.label[i]],
                               pad=0, index=None)


def _read_mnist_images(path):
    with gzip.open(path, "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, 1, rows, cols).astype(np.float32) / 255.0


def _read_mnist_labels(path):
    with gzip.open(path, "rb") as f:
        struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.float32)


def get_mnist_iter(args, kv=None):
    """MNIST train / val iterators from the idx files under
    ``--data-dir``; without them a learnable synthetic set of MNIST's
    shape (nothing is downloaded)."""
    data_dir = getattr(args, "data_dir", "data/mnist")
    names = ["train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
             "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"]
    paths = [os.path.join(data_dir, n) for n in names]
    if all(os.path.exists(p) for p in paths):
        tx, ty = _read_mnist_images(paths[0]), _read_mnist_labels(paths[1])
        vx, vy = _read_mnist_images(paths[2]), _read_mnist_labels(paths[3])
        train = mx.io.NDArrayIter(tx, ty, args.batch_size, shuffle=True)
        val = mx.io.NDArrayIter(vx, vy, args.batch_size)
        return train, val
    shape = (args.batch_size, 1, 28, 28)
    train = SyntheticDataIter(10, shape, num_batches=60, learnable=True,
                              noise=0.5, seed=0)
    val = SyntheticDataIter(10, shape, num_batches=10, learnable=True,
                            noise=0.5, seed=0)
    return train, val


def get_rec_iter(args, kv=None):
    """Train / val iterators: synthetic under ``--benchmark 1``. RecordIO
    images (``--data-train``) need ``ImageRecordIter``, ROADMAP.md A9."""
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    if args.benchmark:
        shape = (args.batch_size,) + image_shape
        train = SyntheticDataIter(args.num_classes, shape,
                                  num_batches=getattr(args, "num_batches", 50))
        return train, None
    raise NotImplementedError(
        "get_rec_iter reads RecordIO images through ImageRecordIter, which "
        "is not ported (ROADMAP.md A9); run with --benchmark 1 for "
        "synthetic data")
