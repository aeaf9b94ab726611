"""DataLoader with worker processes (counterpart of
``mxnet_tpu/gluon/data/dataloader.py``; reference:
python/mxnet/gluon/data/dataloader.py:35-200).

Samples stay on the host. With ``num_workers`` 0 the main process reads
them and ``batchify_fn`` builds the batch; with workers, each worker
(started with ``spawn``, never ``fork``: the parent runs CUDA and other
threads) reads its batches' samples and returns them stacked as numpy,
with every CUDA device hidden from it, so a worker never touches the
card. The main process then puts the batch on the current context: a
host batch bound for the card is copied through pinned memory,
asynchronously on the current stream. Batches come back in the
sampler's order whatever the workers' timing, so a seeded
``RandomSampler`` gives the JAX package's order.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import time

import numpy as np
import torch

from ...context import current_context
from ...ndarray.ndarray import NDArray
from . import sampler as _sampler

__all__ = ["DataLoader", "default_batchify_fn"]


def _np_batchify(data):
    """Stack samples (NDArrays, numpy arrays, scalars, tuples of them)
    into numpy arrays, one per tuple position."""
    first = data[0]
    if isinstance(first, NDArray):
        return np.stack([d.asnumpy() for d in data])
    if isinstance(first, tuple):
        return [_np_batchify(list(col)) for col in zip(*data)]
    return np.asarray(data)


def _to_context(batch):
    """A host batch (numpy arrays or lists of them) as NDArrays on the
    current context; float64 becomes float32, MXNet's default. A batch
    bound for the card goes through pinned memory with a non-blocking
    copy."""
    if isinstance(batch, (list, tuple)):
        return [_to_context(b) for b in batch]
    if not isinstance(batch, np.ndarray):
        return batch
    dev = current_context().device
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if t.dtype == torch.float64:
        t = t.float()
    if dev.type == "cuda":
        return NDArray(t.pin_memory().to(dev, non_blocking=True))
    return NDArray(t.to(dev))


def default_batchify_fn(data):
    """Stack samples into a batch on the current context (reference:
    dataloader.py:82): samples already on the card are stacked there,
    host samples on the host and then copied over."""
    first = data[0]
    if isinstance(first, NDArray) and first._data.device.type != "cpu":
        return NDArray(torch.stack([d._data for d in data]))
    if isinstance(first, tuple):
        return [default_batchify_fn(list(col)) for col in zip(*data)]
    return _to_context(_np_batchify(data))


def _record_files(obj, found, _depth=0):
    """The open RecordIO readers reachable from a dataset."""
    from ... import recordio as _recordio
    if _depth > 4:
        return found
    if isinstance(obj, _recordio.MXRecordIO):
        if obj.is_open:
            found.append(obj)
        return found
    for attr in ("_record", "_data", "_dataset"):
        child = getattr(obj, attr, None)
        if child is not None:
            _record_files(child, found, _depth + 1)
    return found


def _reopen_record_files(obj):
    """Reopen the RecordIO readers of a dataset in a worker, so each has
    its own file offset (the JAX package's ``_reopen_record_files``;
    reference: recordio.py:87)."""
    for rec in _record_files(obj, []):
        rec.close()
        rec.open()


def _worker_loop(dataset, key_queue, data_queue, batchify_fn):
    """(reference: dataloader.py:104) Read each batch's samples and put
    them, stacked as numpy, on ``data_queue``."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _reopen_record_files(dataset)
    while True:
        idx, samples = key_queue.get()
        if idx is None:
            break
        try:
            items = [dataset[i] for i in samples]
            if batchify_fn is default_batchify_fn:
                batch = _np_batchify(items)
            else:
                batch = batchify_fn(items)
                if isinstance(batch, NDArray):
                    batch = batch.asnumpy()
                elif isinstance(batch, (list, tuple)):
                    batch = [b.asnumpy() if isinstance(b, NDArray) else b
                             for b in batch]
            data_queue.put((idx, batch, None))
        except Exception as e:  # the error goes to the main process
            data_queue.put((idx, None, f"{type(e).__name__}: {e}"))


class DataLoader:
    """Loads a Dataset in mini-batches (reference: dataloader.py:35)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = _sampler.RandomSampler(len(dataset)) if shuffle \
                    else _sampler.SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = _sampler.BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._batchify_fn = batchify_fn if batchify_fn is not None \
            else default_batchify_fn

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._batchify_fn([self._dataset[i] for i in batch])
            return
        yield from self._multi_worker_iter()

    def _multi_worker_iter(self):
        """Keep 2 x workers batches in flight and yield them in order
        (reference: dataloader.py:143 _MultiWorkerIter)."""
        ctx = multiprocessing.get_context("spawn")
        key_queue = ctx.Queue()
        data_queue = ctx.Queue(2 * self._num_workers)
        records = _record_files(self._dataset, [])
        workers = []
        try:
            for _ in range(self._num_workers):
                w = ctx.Process(target=_worker_loop,
                                args=(self._dataset, key_queue, data_queue,
                                      self._batchify_fn), daemon=True)
                w.start()
                workers.append(w)
        finally:
            # pickling a reader for a worker closes it here
            for rec in records:
                if not rec.is_open:
                    rec.open()
        try:
            batches = list(self._batch_sampler)
            sent = rcvd = 0
            buf = {}
            for i in range(min(2 * self._num_workers, len(batches))):
                key_queue.put((i, batches[i]))
                sent += 1
            while rcvd < len(batches):
                while rcvd not in buf:
                    idx, batch, err = data_queue.get()
                    if err is not None:
                        raise RuntimeError(f"DataLoader worker error: {err}")
                    buf[idx] = batch
                batch = buf.pop(rcvd)
                rcvd += 1
                if sent < len(batches):
                    key_queue.put((sent, batches[sent]))
                    sent += 1
                yield _to_context(batch)
        finally:
            for _ in workers:
                key_queue.put((None, None))
            # drain what the workers still put, so none blocks on a full
            # queue while it is joined
            deadline = time.monotonic() + 10
            while any(w.is_alive() for w in workers) and \
                    time.monotonic() < deadline:
                try:
                    data_queue.get(timeout=0.05)
                except queue.Empty:
                    pass
            for w in workers:
                w.join(timeout=1)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=5)

    def __len__(self):
        return len(self._batch_sampler)
