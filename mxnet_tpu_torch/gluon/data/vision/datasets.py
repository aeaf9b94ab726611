"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; reference:
python/mxnet/gluon/data/vision/datasets.py).

MNIST and FashionMNIST read the idx-ubyte files (gzip or raw), CIFAR10
and CIFAR100 the binary batches (``*.bin``, the reference's format) or
the python batches (the JAX package's), from a local ``root``: there is
no download. Images are uint8 HWC NDArrays on the CPU, labels int32
numpy; the DataLoader puts batches on the device.
``SyntheticImageDataset`` draws deterministic images from a seed.
Not ported yet: ``ImageRecordDataset`` and ``ImageFolderDataset``,
which decode images through the ``image`` module (ROADMAP.md A9).
"""
from __future__ import annotations

import gzip
import io
import os
import pickle
import struct
import tarfile

import numpy as np
import torch

from ....base import MXNetError
from ....ndarray.ndarray import NDArray
from .. import dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "SyntheticImageDataset"]


def _host_images(data):
    """uint8 images as one NDArray on the CPU."""
    return NDArray(torch.from_numpy(np.array(data, dtype=np.uint8)))


class _DownloadedDataset(dataset.Dataset):
    """(reference: datasets.py:45)"""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from the idx-ubyte files (reference: datasets.py:60)."""

    _train_data = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _test_data = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        images, labels = self._train_data if self._train else self._test_data
        img_path = os.path.join(self._root, images)
        lbl_path = os.path.join(self._root, labels)
        for p in (img_path, lbl_path):
            if not os.path.exists(p) and not os.path.exists(p[:-3]):
                raise MXNetError(
                    f"{type(self).__name__} file {p} not found: there is no "
                    f"download; place the idx files under {self._root} "
                    "(gzip or raw)")

        def opener(p):
            return gzip.open(p, "rb") if os.path.exists(p) \
                else open(p[:-3], "rb")

        with opener(lbl_path) as fin:
            struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8)\
                .astype(np.int32)
        with opener(img_path) as fin:
            _, num, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
        self._data = _host_images(data.reshape(num, rows, cols, 1))
        self._label = label


class FashionMNIST(MNIST):
    """(reference: datasets.py:103)"""

    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class _BatchUnpickler(pickle.Unpickler):
    """Reads a CIFAR python batch: dicts of bytes, lists and numpy
    arrays, and no other class."""

    _ALLOWED = {("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(
                f"a CIFAR batch holds no {module}.{name}")
        return super().find_class(module, name)


def _load_batch(f):
    return _BatchUnpickler(f, encoding="bytes").load()


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 (reference: datasets.py:130): the binary batches
    (``cifar-10-batches-bin/data_batch_N.bin``: a label byte and 3072
    image bytes a record) or the python batches
    (``cifar-10-batches-py/data_batch_N`` or
    ``cifar-10-python.tar.gz``)."""

    _bin_dir = "cifar-10-batches-bin"
    _label_bytes = 1

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _names(self):
        return [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]

    def _read_bin(self, path):
        rec = self._label_bytes + 3072
        with open(path, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8).reshape(-1, rec)
        return raw[:, self._label_bytes:], \
            raw[:, self._label_bytes - 1].astype(np.int32)

    def _load_batches(self, names):
        data, label = [], []
        tar = os.path.join(self._root, "cifar-10-python.tar.gz")
        for n in names:
            bin_path = os.path.join(self._root, self._bin_dir, n + ".bin")
            if not os.path.exists(bin_path):
                bin_path = os.path.join(self._root, n + ".bin")
            if os.path.exists(bin_path):
                d, lab = self._read_bin(bin_path)
            elif os.path.exists(tar):
                with tarfile.open(tar) as tf, \
                        tf.extractfile(f"cifar-10-batches-py/{n}") as f:
                    d, lab = self._from_pickle(_load_batch(
                        io.BytesIO(f.read())))
            else:
                p = os.path.join(self._root, "cifar-10-batches-py", n)
                if not os.path.exists(p):
                    p = os.path.join(self._root, n)
                if not os.path.exists(p):
                    raise MXNetError(
                        f"{type(self).__name__} batch {n} not found under "
                        f"{self._root}: there is no download; place the "
                        "binary or python batches there")
                with open(p, "rb") as f:
                    d, lab = self._from_pickle(_load_batch(f))
            data.append(d)
            label.append(lab)
        data = np.concatenate(data).reshape(-1, 3, 32, 32)\
            .transpose(0, 2, 3, 1)
        return data, np.concatenate(label).astype(np.int32)

    def _from_pickle(self, d):
        return np.asarray(d[b"data"], np.uint8), \
            np.asarray(d[b"labels"], np.int32)

    def _get_data(self):
        data, label = self._load_batches(self._names())
        self._data = _host_images(data)
        self._label = label


class CIFAR100(CIFAR10):
    """CIFAR-100 (reference: datasets.py:171): the binary files
    (``cifar-100-binary/train.bin`` / ``test.bin``: coarse and fine label
    bytes and 3072 image bytes a record) or the python files
    (``cifar-100-python/train`` / ``test``)."""

    _bin_dir = "cifar-100-binary"
    _label_bytes = 2

    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=False,
                 train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _names(self):
        return ["train"] if self._train else ["test"]

    def _read_bin(self, path):
        with open(path, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8).reshape(-1, 3074)
        return raw[:, 2:], raw[:, 1 if self._fine_label else 0]\
            .astype(np.int32)

    def _load_batches(self, names):
        name = names[0]
        for d in (self._bin_dir, ""):
            p = os.path.join(self._root, d, name + ".bin")
            if os.path.exists(p):
                data, label = self._read_bin(p)
                return data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
                    label
        for d in ("cifar-100-python", ""):
            p = os.path.join(self._root, d, name)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    b = _load_batch(f)
                key = b"fine_labels" if self._fine_label \
                    else b"coarse_labels"
                data = np.asarray(b[b"data"], np.uint8)
                return data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
                    np.asarray(b[key], np.int32)
        raise MXNetError(f"CIFAR-100 file {name} not found under "
                         f"{self._root}: there is no download")


class SyntheticImageDataset(dataset.Dataset):
    """Deterministic images (uint8 HWC) and labels from ``seed`` (the JAX
    package's; sample ``i`` is drawn from ``RandomState(seed + i)``)."""

    def __init__(self, num_samples=1000, shape=(3, 224, 224), classes=1000,
                 seed=0):
        self._n = num_samples
        self._shape = shape
        self._classes = classes
        self._seed = seed

    def __len__(self):
        return self._n

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seed + idx)
        img = rng.randint(0, 256, (self._shape[1], self._shape[2],
                                   self._shape[0])).astype(np.uint8)
        label = int(rng.randint(self._classes))
        return _host_images(img), label
