"""Data iterators (counterpart of ``mxnet_tpu/io.py``; reference:
python/mxnet/io.py — DataDesc/DataBatch :60-130, DataIter :182,
ResizeIter :247, NDArrayIter :546).

The iterators hold numpy arrays and hand out batches of CPU tensors; the
Module moves them to its device. ``NDArrayIter`` and ``ResizeIter`` have
the JAX package's checkpointable cursor (``get_state`` / ``set_state``),
which ``fit(checkpoint_manager=...)`` saves and restores.
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple

import numpy as np
import torch

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data layout description: name, shape, dtype and layout."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return (f"DataDesc[{self.name},{self.shape},{self.dtype},"
                f"{self.layout}]")


class DataBatch:
    """A mini-batch: lists of data and label tensors, and the number of
    padding rows at its end."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), \
                "Data must be list of arrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), \
                "Label must be list of arrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        label_shapes = [lb.shape for lb in self.label] if self.label \
            else None
        return (f"{self.__class__.__name__}: data shapes: {data_shapes} "
                f"label shapes: {label_shapes}")


class DataIter:
    """Base data iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        # deterministic fault site: 'data_iter:batch=B' raises at this
        # iterator's B-th batch (1-based), a dying input worker's stand-in
        from . import faultinject
        if faultinject.active("data_iter") is not None:
            self._fi_ordinal = getattr(self, "_fi_ordinal", 0) + 1
            if faultinject.fire("data_iter", batch=self._fi_ordinal):
                raise faultinject.FaultInjected(
                    "data_iter", batch=self._fi_ordinal)
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class ResizeIter(DataIter):
    """``data_iter`` resized to ``size`` batches an epoch: it restarts
    the inner iterator when that runs out, and (``reset_internal``)
    resets it with each epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def get_state(self):
        """The cursor: ``cur`` and the inner iterator's own. A ``cur``
        alone cannot place the inner iterator, so this raises when the
        inner one has no ``get_state``."""
        inner = getattr(self.data_iter, "get_state", None)
        if not callable(inner):
            raise NotImplementedError(
                "ResizeIter cursor needs the wrapped iterator to support "
                f"get_state(); {type(self.data_iter).__name__} does not")
        return {"cur": int(self.cur), "inner": inner()}

    def set_state(self, state):
        if not isinstance(state, dict) or "cur" not in state or \
                "inner" not in state:
            raise ValueError(
                "not a ResizeIter cursor (missing 'cur'/'inner'; got keys "
                f"{sorted(state) if isinstance(state, dict) else state})")
        setter = getattr(self.data_iter, "set_state", None)
        if not callable(setter):
            raise ValueError(
                "ResizeIter cursor carries an inner-iterator state but "
                f"{type(self.data_iter).__name__} has no set_state()")
        setter(state["inner"])
        self.cur = int(state.get("cur", 0))


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    return np.asarray(v)


def _init_data(data, allow_empty, default_name):
    """[(name, numpy array)] from an array, a list of arrays or a dict."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, torch.Tensor)) \
            or hasattr(data, "asnumpy"):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        data = OrderedDict([(default_name, data[0])] if len(data) == 1
                           else [(f"_{i}_{default_name}", d)
                                 for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be an array, a list of arrays or a dict "
                        "with arrays as values")
    return [(k, _to_numpy(v)) for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays in batches of ``batch_size``. The
    last batch is padded from the start of the data (``pad``), dropped
    (``discard``) or carried into the next epoch (``roll_over``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]
        # the full permutation of the stored rows (idx is cut below for
        # 'discard'): what the resume cursor must carry
        self._row_order = self.idx.copy()
        if last_batch_handle == "discard":
            n = self.data[0][1].shape[0]
            self.idx = self.idx[:n - n % batch_size]
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return [torch.from_numpy(np.ascontiguousarray(
                x[1][self.cursor:end])) for x in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [torch.from_numpy(np.concatenate(
            (x[1][self.cursor:], x[1][:pad]), axis=0))
            for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def get_state(self):
        """The resume cursor: the position and the shuffle permutation
        (``None`` when unshuffled), so another process, whose RNG drew
        another permutation, restores the saved batch stream."""
        n = len(self._row_order)
        identity = np.array_equal(self._row_order, np.arange(n))
        return {"cursor": int(self.cursor),
                "order": None if identity
                else np.asarray(self._row_order, np.int64),
                "rows": int(n)}

    def set_state(self, state):
        if not isinstance(state, dict) or "cursor" not in state or \
                "rows" not in state:
            raise ValueError(
                "not an NDArrayIter cursor (missing 'cursor'/'rows'; got "
                f"keys {sorted(state) if isinstance(state, dict) else state}"
                ")")
        n = len(self._row_order)
        rows = int(state.get("rows", n))
        if rows != n:
            raise ValueError(
                "NDArrayIter cursor was saved for a different dataset: "
                f"saved order covers {rows} rows, this iterator holds {n}")
        order = state.get("order")
        order = np.arange(n) if order is None \
            else np.asarray(order, np.int64)
        if not np.array_equal(order, self._row_order):
            # stored rows are base rows permuted by _row_order; map them
            # to the saved permutation: new[j] = base[order[j]]
            inv = np.empty(n, np.int64)
            inv[self._row_order] = np.arange(n)
            take = inv[order]
            self.data = [(k, v[take]) for k, v in self.data]
            self.label = [(k, v[take]) for k, v in self.label]
            self._row_order = order
            self.idx = order[:len(self.idx)]
        self.cursor = int(state.get("cursor", -self.batch_size))
