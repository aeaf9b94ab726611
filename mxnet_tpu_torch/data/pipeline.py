"""Asynchronous host data pipeline: worker threads, read-ahead and
staging onto the device (counterpart of ``mxnet_tpu/data/pipeline.py``).

Over any :class:`~mxnet_tpu_torch.io.DataIter`, or RecordIO shards::

    source thread --(ordinal, batch)--> bounded work queue
        one thread drives the base iterator: the order is assigned here
    worker threads (N) -- transform --> done queue (unordered)
    stager thread -- reorder by ordinal, stage --> staged queue
        ``stage_ahead`` slots: the next batch is on the device before
        the current step retires
    consumer ``next()`` -- pops a staged batch

The stream is byte-identical to the base iterator's for any worker
count: the source thread numbers the batches and the stager emits them
strictly in that order. A transform must be pure (no ambient RNG).

Staging (``device``: by default the current context's device; ``fit``
passes its step's): on a CUDA device the stager thread sets the device,
copies each host tensor into pinned memory and from there with
``non_blocking`` on a stream of its own, and records an event. ``next()``
makes the consumer's current stream wait on that event and calls
``record_stream`` on each staged tensor, so the caching allocator never
hands the tensor's memory to another stream before the consumer's work
on it; the staged batch keeps its pinned source alive. Tensors already
on the device pass through, and on the CPU nothing is copied. The
staged batch's ``host`` attribute is the host batch it was made from
(the sparse id statistics read it instead of the card).

The cursor protocol (``get_state()`` / ``set_state()``: epoch, consumed
batch count, the base iterator's epoch-start state) is what
``CheckpointManager`` persists, so ``fit(auto_resume=True)`` resumes at
the exact next batch. Worker failures (the ``data_worker`` fault site
among them) surface at ``next()``; ``close()`` joins every thread and
never hangs on a full queue (``data/workers.py``, also run at exit).

Not ported: the JAX package's trace spans (``set_trace``, with
``telemetry/trace.py``) and its profiler tasks; the per-host shard of
``RecordIOSource`` defaults to the whole file (one process: the port has
no ``parallel/dist``).
"""
from __future__ import annotations

import copy
import os
import queue
import threading
import time

import numpy as np
import torch

from ..io import DataBatch, DataDesc, DataIter
from . import workers as wk
from .report import register_pipeline

__all__ = ["DataPipeline", "RecordIOSource", "from_recordio",
           "maybe_wrap_for_fit"]

_EOE = object()          # end-of-epoch token


def _cfg(name, override):
    from .. import config
    return int(config.get(name)) if override is None else int(override)


class RecordIOSource(DataIter):
    """RecordIO batch source: yields DataBatches of raw record bytes;
    the pipeline's workers decode them (one reader, N decoders). This
    process reads ``keys[part_index::num_parts]`` (default: every
    record). Epochs shuffle with seed ``seed + epoch``; ``reset()``
    advances to the next epoch."""

    def __init__(self, path_imgrec, path_imgidx=None, batch_size=32,
                 shuffle=False, seed=0, num_parts=None, part_index=None):
        super().__init__(batch_size)
        from .. import recordio
        idx_path = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
        self._rec = recordio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
        num_parts = 1 if num_parts is None else int(num_parts)
        part_index = 0 if part_index is None else int(part_index)
        if not 0 <= part_index < num_parts:
            raise ValueError(f"part_index {part_index} outside "
                             f"[0, {num_parts})")
        self.num_parts = num_parts
        self.part_index = part_index
        self._keys = list(self._rec.keys)[part_index::num_parts]
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.epoch = 0
        self._pos = 0                       # next batch ordinal this epoch
        self.num_batches = len(self._keys) // batch_size   # tail dropped
        if self.num_batches == 0:
            raise ValueError(
                f"shard {part_index}/{num_parts} of {path_imgrec} holds "
                f"{len(self._keys)} records < batch_size {batch_size}")
        self._order = self._epoch_order()
        self.provide_data = None            # raw bytes: the decoder knows
        self.provide_label = None

    def _epoch_order(self):
        order = np.arange(len(self._keys))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def reset(self):
        self.epoch += 1
        self._pos = 0
        self._order = self._epoch_order()

    def skip_batches(self, n):
        """Seek ``n`` batches ahead without reading records."""
        self._pos = min(self._pos + int(n), self.num_batches)

    def next(self):
        if self._pos >= self.num_batches:
            raise StopIteration
        lo = self._pos * self.batch_size
        recs = [self._rec.read_idx(self._keys[int(i)])
                for i in self._order[lo:lo + self.batch_size]]
        self._pos += 1
        return DataBatch(data=[recs], label=None, pad=0)

    # -- checkpointable cursor -------------------------------------------------
    def get_state(self):
        return {"epoch": int(self.epoch), "pos": int(self._pos),
                "seed": self.seed, "shuffle": self.shuffle,
                "num_parts": self.num_parts,
                "part_index": self.part_index}

    def set_state(self, state):
        if not isinstance(state, dict) or "pos" not in state:
            raise ValueError(
                "not a RecordIOSource cursor (missing 'pos'; got keys "
                f"{sorted(state) if isinstance(state, dict) else state})")
        if state.get("num_parts", self.num_parts) != self.num_parts or \
                state.get("part_index", self.part_index) != self.part_index:
            raise ValueError(
                "RecordIOSource cursor was saved for shard "
                f"{state.get('part_index')}/{state.get('num_parts')} but "
                f"this source reads {self.part_index}/{self.num_parts}")
        # seed and shuffle define the saved stream: take them from it
        self.seed = int(state.get("seed", self.seed))
        self.shuffle = bool(state.get("shuffle", self.shuffle))
        self.epoch = int(state.get("epoch", 0))
        self._order = self._epoch_order()
        self._pos = int(state.get("pos", 0))

    def close(self):
        self._rec.close()


def _default_record_decoder(data_shape, dtype):
    """records -> a DataBatch of CPU tensors: ``recordio.unpack`` each
    record, its payload as ``data_shape`` of ``dtype``, its label the
    header's (first) label. Pure: safe for any worker count."""
    from .. import recordio

    def _decode(batch):
        datas, labels = [], []
        for rec in batch.data[0]:
            header, payload = recordio.unpack(rec)
            datas.append(np.frombuffer(payload, dtype=dtype)
                         .reshape(data_shape))
            lab = header.label
            labels.append(np.asarray(lab, np.float32).reshape(-1)[0]
                          if not np.isscalar(lab) else np.float32(lab))
        return DataBatch(
            data=[torch.from_numpy(np.stack(datas))],
            label=[torch.from_numpy(np.asarray(labels, np.float32))],
            pad=batch.pad, index=batch.index)

    return _decode


class DataPipeline(DataIter):
    """See the module docstring. Wraps ``base_iter`` (any DataIter); with
    ``transform`` the decode work runs on ``num_workers`` threads;
    batches are staged on ``sharding`` (a device; by default the
    current context's) ``stage_ahead`` batches ahead of the consumer
    (``stage_device=False``: not staged). ``own_base=True`` closes the
    base with the pipeline."""

    def __init__(self, base_iter, transform=None, num_workers=None,
                 queue_depth=None, stage_ahead=None, stage_device=True,
                 sharding=None, provide_data=None, provide_label=None,
                 own_base=False, name="pipeline"):
        super().__init__(getattr(base_iter, "batch_size", 0))
        self._base = base_iter
        self._transform = transform
        self._num_workers = max(1, _cfg("MXTPU_DATA_WORKERS", num_workers))
        self._queue_depth = max(1, _cfg("MXTPU_DATA_QUEUE_DEPTH",
                                        queue_depth))
        self._stage_ahead = max(1, _cfg("MXTPU_DATA_STAGE_AHEAD",
                                        stage_ahead))
        self._stage_device = bool(stage_device)
        self._sharding = sharding
        self._device = None         # resolved when a stream starts
        self._provide_data = provide_data
        self._provide_label = provide_label
        self._own_base = own_base
        self.name = name
        self._group = None
        self._q_work = self._q_done = self._q_out = None
        self._epoch = 0
        self._consumed = 0          # batches handed to the consumer
        self._skip = 0              # batches to discard on next start
        self._base_epoch_state = self._snap_base_state()
        self._closed = False
        self._current = None
        self._slock = threading.Lock()
        self._zero_stats()
        register_pipeline(self)
        wk.register_closeable(self)

    # -- DataIter surface ------------------------------------------------------
    @property
    def provide_data(self):
        return self._provide_data if self._provide_data is not None \
            else self._base.provide_data

    @property
    def provide_label(self):
        return self._provide_label if self._provide_label is not None \
            else self._base.provide_label

    def __getattr__(self, nm):
        # passthrough to the base iterator (default_bucket_key and the
        # like), so the pipeline drops into any loop the base served
        if nm.startswith("_"):
            raise AttributeError(nm)
        base = self.__dict__.get("_base")
        if base is None:
            raise AttributeError(nm)
        return getattr(base, nm)

    # -- stats -----------------------------------------------------------------
    def _zero_stats(self):
        self._wait_s = 0.0
        self._waits = 0
        self._next_calls = 0
        self._source_busy_s = 0.0
        self._decode_busy_s = 0.0
        self._stage_busy_s = 0.0
        self._batches_decoded = 0
        self._items_decoded = 0
        self._batches_staged = 0

    def stats(self, reset=False):
        """Counter snapshot for ``data_report()`` (no device sync)."""
        with self._slock:
            out = {
                "name": self.name,
                "epoch": self._epoch,
                "consumed": self._consumed,
                "workers": self._num_workers,
                "queue_depth": self._queue_depth,
                "stage_ahead": self._stage_ahead,
                "device": str(self._device) if self._device is not None
                else None,
                "queues": {
                    "work": self._q_work.qsize() if self._q_work else 0,
                    "done": self._q_done.qsize() if self._q_done else 0,
                    "staged": self._q_out.qsize() if self._q_out else 0,
                },
                "wait_s": round(self._wait_s, 6),
                "waits": self._waits,
                "next_calls": self._next_calls,
                "starvation_fraction": round(
                    self._waits / self._next_calls, 6)
                if self._next_calls else 0.0,
                "source_busy_s": round(self._source_busy_s, 6),
                "decode_busy_s": round(self._decode_busy_s, 6),
                "stage_busy_s": round(self._stage_busy_s, 6),
                "batches_decoded": self._batches_decoded,
                "items_decoded": self._items_decoded,
                "batches_staged": self._batches_staged,
                "decode_items_s": round(
                    self._items_decoded / self._decode_busy_s, 2)
                if self._decode_busy_s > 0 else None,
            }
            if reset:
                self._zero_stats()
        return out

    def _acc(self, field, dt):
        with self._slock:
            setattr(self, field, getattr(self, field) + dt)

    # -- stage threads ---------------------------------------------------------
    def _start_stream(self):
        if self._closed:
            raise RuntimeError(f"DataPipeline '{self.name}' is closed")
        if self._stage_device and self._device is None:
            from ..context import as_device
            self._device = as_device(self._sharding)
            if self._device.type == "cuda" and \
                    self._device.index is None:
                self._device = torch.device(
                    "cuda", torch.cuda.current_device())
        self._q_work = queue.Queue(maxsize=self._queue_depth)
        self._q_done = queue.Queue(
            maxsize=self._queue_depth + self._num_workers)
        self._q_out = queue.Queue(maxsize=self._stage_ahead)
        g = self._group = wk.WorkerGroup(f"data-{self.name}")
        skip, self._skip = self._skip, 0
        g.spawn(self._source_loop, g, skip, name=f"data-{self.name}-source")
        for i in range(self._num_workers):
            g.spawn(self._worker_loop, g, i,
                    name=f"data-{self.name}-worker{i}")
        g.spawn(self._stager_loop, g, name=f"data-{self.name}-stager")

    def _source_loop(self, group, skip):
        ordinal = 0
        while not group.stopped:
            t0 = time.perf_counter()
            try:
                batch = self._base.next()
            except StopIteration:
                break
            self._acc("_source_busy_s", time.perf_counter() - t0)
            if skip > 0:       # checkpoint resume: replay to the cursor
                skip -= 1
                continue
            if not wk.q_put(self._q_work, (ordinal, batch), group):
                return
            ordinal += 1
        for _ in range(self._num_workers):
            wk.q_put(self._q_work, _EOE, group)

    def _worker_loop(self, group, widx):
        from .. import faultinject
        while not group.stopped:
            ok, item = wk.q_get(self._q_work, group)
            if not ok:
                return
            if item is _EOE:
                wk.q_put(self._q_done, _EOE, group)
                return
            ordinal, batch = item
            # the 'data_worker:batch=B' fault site: the worker taking the
            # B-th batch (1-based) raises (or, action=kill, dies)
            if faultinject.active("data_worker") is not None and \
                    faultinject.fire("data_worker", batch=ordinal + 1,
                                     worker=widx):
                raise faultinject.FaultInjected(
                    "data_worker", batch=ordinal + 1, worker=widx)
            t0 = time.perf_counter()
            if self._transform is not None:
                batch = self._transform(batch)
            dt = time.perf_counter() - t0
            n_items = self.batch_size or (
                len(batch.data[0]) if batch.data else 0)
            with self._slock:
                self._decode_busy_s += dt
                self._batches_decoded += 1
                self._items_decoded += n_items
            wk.q_put(self._q_done, (ordinal, batch), group)

    def _stager_loop(self, group):
        stream = None
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
            stream = torch.cuda.Stream(self._device)
        pending = {}
        next_ord = 0
        eoes = 0
        while not group.stopped:
            if next_ord in pending:
                batch = self._stage(pending.pop(next_ord), stream)
                if not wk.q_put(self._q_out, batch, group):
                    return
                next_ord += 1
                continue
            if eoes >= self._num_workers:
                if pending:
                    group.fail(RuntimeError(
                        f"data pipeline '{self.name}' lost batch "
                        f"{next_ord} (have {sorted(pending)})"))
                    return
                wk.q_put(self._q_out, _EOE, group)
                return
            ok, item = wk.q_get(self._q_done, group)
            if not ok:
                return
            if item is _EOE:
                eoes += 1
                continue
            pending[item[0]] = item[1]

    def _stage(self, batch, stream):
        """The batch with its tensors on the staging device (copies on
        ``stream`` on the card, an event recorded after them); the
        original batch is not mutated and becomes ``host``."""
        if self._device is None:
            return batch
        t0 = time.perf_counter()
        staged = copy.copy(batch)
        staged.host = batch
        staged.ready = None
        keep = []
        if stream is not None:
            with torch.cuda.stream(stream):
                staged.data = self._put_all(batch.data, keep)
                staged.label = self._put_all(batch.label, keep)
                staged.ready = torch.cuda.Event()
                staged.ready.record(stream)
        else:
            staged.data = self._put_all(batch.data, keep)
            staged.label = self._put_all(batch.label, keep)
        staged.pinned = keep
        with self._slock:
            self._stage_busy_s += time.perf_counter() - t0
            self._batches_staged += 1
        return staged

    def _put_all(self, arrays, keep):
        if not arrays:
            return arrays
        return [self._put(a, keep) for a in arrays]

    def _put(self, arr, keep):
        wrapped = hasattr(arr, "_data") and isinstance(
            getattr(arr, "_data"), torch.Tensor)
        t = arr._data if wrapped else arr
        if not isinstance(t, torch.Tensor) or t.device == self._device:
            return arr      # raw payloads and tensors already there
        if self._device.type == "cuda" and t.device.type == "cpu":
            src = t if t.is_pinned() else t.pin_memory()
            keep.append(src)
            out = src.to(self._device, non_blocking=True)
        else:
            out = t.to(self._device)
        if wrapped:
            from ..ndarray.ndarray import NDArray
            return NDArray(out)
        return out

    # -- consumer --------------------------------------------------------------
    def next(self):
        if self._group is None:
            self._start_stream()
        t0 = time.perf_counter()
        starved = False
        try:
            item = self._q_out.get_nowait()
        except queue.Empty:
            starved = True      # the consumer came before the pipeline
            item = None
            while item is None:
                err = self._group.error()
                if err is not None:
                    self._stop_stream()
                    raise err
                try:
                    item = self._q_out.get(timeout=0.05)
                except queue.Empty:
                    continue
        with self._slock:
            self._next_calls += 1
            if starved:
                self._waits += 1
                self._wait_s += time.perf_counter() - t0
        if item is _EOE:
            self._end_of_epoch()
            raise StopIteration
        self._hand_over(item)
        self._consumed += 1
        self._current = item
        return item

    def _hand_over(self, item):
        """Order the consumer's stream after the staging copies and tie
        each staged tensor's memory to it."""
        ev = getattr(item, "ready", None)
        if ev is None:
            return
        cur = torch.cuda.current_stream(self._device)
        cur.wait_event(ev)
        for a in list(item.data or []) + list(item.label or []):
            t = a._data if hasattr(a, "_data") else a
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(cur)

    def _end_of_epoch(self):
        g, self._group = self._group, None
        if g is not None:
            g.stop()
            g.join()
            err = g.error()
            if err is not None:
                raise err

    def iter_next(self):
        try:
            self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getindex(self):
        return self._current.index

    def getpad(self):
        return self._current.pad

    # -- lifecycle -------------------------------------------------------------
    def _stop_stream(self):
        g, self._group = self._group, None
        if g is None:
            return
        g.stop()
        for q in (self._q_work, self._q_done, self._q_out):
            if q is not None:
                wk.q_drain(q)     # unblock producers stuck on full queues
        g.join()
        for q in (self._q_work, self._q_done, self._q_out):
            if q is not None:
                wk.q_drain(q)

    def reset(self):
        """Advance to the next epoch (fit's semantics): stop the stream,
        reset the base iterator, snapshot its epoch-start state for the
        cursor."""
        self._stop_stream()
        self._base.reset()
        self._epoch += 1
        self._consumed = 0
        self._skip = 0
        self._base_epoch_state = self._snap_base_state()

    def close(self):
        """Join every pipeline thread; idempotent, also run at exit."""
        self._closed = True
        self._stop_stream()
        if self._own_base:
            try:
                self._base.close()
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- checkpointable cursor -------------------------------------------------
    def _snap_base_state(self):
        fn = getattr(self._base, "get_state", None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                return None
        return None

    def get_state(self):
        """The resume cursor: the epoch, the CONSUMED batch count (not
        the read-ahead position) and the base iterator's epoch-start
        state; ``set_state`` replays the base to it."""
        return {"epoch": int(self._epoch),
                "batch": int(self._consumed),
                "base": self._base_epoch_state}

    def set_state(self, state):
        if not isinstance(state, dict) or "batch" not in state:
            raise ValueError(
                "not a DataPipeline cursor (missing 'batch'; got keys "
                f"{sorted(state) if isinstance(state, dict) else state}) "
                "— was this checkpoint saved under a different "
                "MXTPU_DATA_PIPELINE setting?")
        self._stop_stream()
        # the base first: if it refuses its cursor, the pipeline's own
        # counters stay as they were
        base_state = state.get("base")
        setter = getattr(self._base, "set_state", None)
        if base_state is not None and callable(setter):
            setter(base_state)
            new_epoch_state = base_state
        else:
            self._base.reset()
            new_epoch_state = self._snap_base_state()
        self._base_epoch_state = new_epoch_state
        self._epoch = int(state.get("epoch", 0))
        self._consumed = int(state.get("batch", 0))
        self._skip = self._consumed
        # a seekable source jumps to the cursor; others replay and
        # discard in the source thread
        skipper = getattr(self._base, "skip_batches", None)
        if self._skip and callable(skipper):
            skipper(self._skip)
            self._skip = 0


def from_recordio(path_imgrec, data_shape, batch_size, path_imgidx=None,
                  shuffle=False, seed=0, dtype="float32", num_parts=None,
                  part_index=None, decode_fn=None, data_name="data",
                  label_name="softmax_label", num_workers=None,
                  queue_depth=None, stage_ahead=None, sharding=None,
                  name="recordio"):
    """RecordIO shards into the pipeline: a :class:`RecordIOSource`
    feeding ``num_workers`` decode threads. ``decode_fn`` maps a raw
    record batch to a DataBatch of tensors; the default unpacks
    ``recordio.pack`` payloads of ``data_shape`` / ``dtype``."""
    src = RecordIOSource(path_imgrec, path_imgidx=path_imgidx,
                         batch_size=batch_size, shuffle=shuffle, seed=seed,
                         num_parts=num_parts, part_index=part_index)
    decode = decode_fn or _default_record_decoder(
        tuple(data_shape), np.dtype(dtype))
    provide_data = [DataDesc(data_name, (batch_size,) + tuple(data_shape),
                             np.dtype(dtype))]
    provide_label = [DataDesc(label_name, (batch_size,), np.float32)]
    return DataPipeline(src, transform=decode, num_workers=num_workers,
                        queue_depth=queue_depth, stage_ahead=stage_ahead,
                        sharding=sharding, provide_data=provide_data,
                        provide_label=provide_label, own_base=True,
                        name=name)


def maybe_wrap_for_fit(train_data, module=None):
    """``fit``'s hook (``MXTPU_DATA_PIPELINE``: 1/auto = wrap, on every
    device; 0 = off). Returns ``(iter, owned pipeline or None)``; the
    caller closes an owned pipeline when training ends. The wrapper keeps
    the batch stream byte for byte, adds read-ahead and staging into the
    module's device (its fused step's ``staging_sharding()``, else its
    context), and gives any iterator the cursor protocol."""
    from .. import config
    flag = str(config.get("MXTPU_DATA_PIPELINE")).lower()
    if flag in ("0", "false", "off"):
        return train_data, None
    if isinstance(train_data, DataPipeline) or \
            not isinstance(train_data, DataIter):
        return train_data, None
    fused = getattr(module, "_fused", None)
    device = fused.staging_sharding() if fused is not None \
        else getattr(module, "_device", None)
    pipe = DataPipeline(train_data, sharding=device, name="fit")
    return pipe, pipe
