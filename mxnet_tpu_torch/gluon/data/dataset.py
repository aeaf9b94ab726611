"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``;
reference: python/mxnet/gluon/data/dataset.py). Samples stay on the
host: the DataLoader builds each batch on the device."""
from __future__ import annotations

import os

from ... import recordio
from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """``__getitem__`` and ``__len__`` (reference: dataset.py:29)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """A dataset of ``fn(*sample)`` (reference: dataset.py:38); with
        ``lazy=False`` every sample is transformed now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``transform`` of each sample's first element (reference:
        dataset.py:63)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """A list or array as a dataset (reference: dataset.py:89)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Several array-likes of one length, sample ``i`` the tuple of their
    ``i``-th rows (reference: dataset.py:116). A 1-D NDArray is kept as
    numpy, as in the reference."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    f"All arrays must have the same length; 0-th has "
                    f"length {self._length} while {i}-th has {len(data)}.")
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of a RecordIO file with its ``.idx`` index, as bytes
    (reference: dataset.py:153), read through the port's
    ``recordio.MXIndexedRecordIO``."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                 self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
