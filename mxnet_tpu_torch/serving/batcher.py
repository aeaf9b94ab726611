"""Dynamic micro-batcher: coalesce concurrent requests onto the buckets
(counterpart of ``mxnet_tpu/serving/batcher.py``).

A thread-safe queue coalesces requests up to ``max_batch`` rows or
``max_wait_us`` (whichever comes first), runs one bucket of the
Predictor, and splits the outputs back per request. Admission control
sheds load with ``Overloaded`` once queued rows would exceed
``max_queue``; a request whose deadline expires while queued completes
with ``DeadlineExceeded`` without taking a batch slot; ``start()`` warms
every bucket first.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from .. import config
from ..base import MXNetError
from . import DeadlineExceeded, Overloaded

__all__ = ["DynamicBatcher", "ServingFuture"]

_DEADLINE_SLACK_S = 0.002  # launch this early so an at-deadline
                           # request is still live when collected
_LATENCY_WINDOW = 4096     # latency samples kept per bucket


class ServingFuture:
    """Completion handle for one submitted request."""

    __slots__ = ("_event", "_result", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error = None

    def _complete(self, result=None, error=None):
        self._result = result
        self._error = error
        self._event.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("serving request still pending")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    __slots__ = ("arrays", "rows", "future", "deadline", "t_submit")

    def __init__(self, arrays, rows, future, deadline):
        self.arrays = arrays
        self.rows = rows
        self.future = future
        self.deadline = deadline
        self.t_submit = time.perf_counter()


class DynamicBatcher:
    """Coalesce concurrent requests through a ``Predictor``.

    Parameters
    ----------
    predictor : Predictor
    max_batch : int, optional
        Row cap per micro-batch (default and maximum: the predictor's
        largest bucket).
    max_wait_us : int, optional
        How long the first queued request waits for company (default
        MXTPU_SERVING_MAX_WAIT_US).
    max_queue : int, optional
        Queued-row bound for admission control (default
        MXTPU_SERVING_MAX_QUEUE).
    """

    def __init__(self, predictor, max_batch=None, max_wait_us=None,
                 max_queue=None, name="serving"):
        self.predictor = predictor
        self.max_batch = int(max_batch) if max_batch is not None \
            else predictor.max_batch
        if self.max_batch > predictor.max_batch:
            raise MXNetError(f"max_batch={self.max_batch} exceeds the "
                             f"largest predictor bucket "
                             f"({predictor.max_batch})")
        self.max_wait_us = int(max_wait_us) if max_wait_us is not None \
            else int(config.get("MXTPU_SERVING_MAX_WAIT_US"))
        self.max_queue = int(max_queue) if max_queue is not None \
            else int(config.get("MXTPU_SERVING_MAX_QUEUE"))
        self.name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._queued_rows = 0
        self._running = False
        self._thread = None
        # counters (guarded by _lock)
        self._occ_rows = {b: 0 for b in predictor.buckets}
        self._occ_batches = {b: 0 for b in predictor.buckets}
        self._latency_ms = {b: collections.deque(maxlen=_LATENCY_WINDOW)
                            for b in predictor.buckets}
        self._shed = 0
        self._deadline_missed = 0
        self._served = 0

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        """Warm every bucket and start the batching thread."""
        if self._running:
            return self
        if self._thread is not None and self._thread.is_alive():
            raise MXNetError(f"DynamicBatcher '{self.name}' is still "
                             "draining from a previous stop(); call stop() "
                             "again first")
        self.predictor.warmup()
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name=f"{self.name}-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain=True):
        """Stop the batching thread. ``drain=True`` serves what is queued
        first; otherwise queued requests fail with ``Overloaded`` and
        in-flight work is cancelled (``_cancel_inflight``). Raises if the
        drain takes more than 60 s (the thread keeps draining)."""
        with self._cond:
            if not self._running:
                if self._thread is None or not self._thread.is_alive():
                    self._thread = None
                    return
            elif not drain:
                for r in self._queue:
                    r.future._complete(error=Overloaded(
                        "server shutting down"))
                self._queue.clear()
                self._queued_rows = 0
                self._cancel_inflight()
            self._running = False
            self._cond.notify_all()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise MXNetError(f"DynamicBatcher '{self.name}' did not finish "
                             "draining within 60s; call stop() again to "
                             "re-join")
        self._thread = None

    def _cancel_inflight(self):
        """Hook of ``stop(drain=False)``, called under the queue lock.
        This batcher's unit of work is a whole request, which always runs
        to completion, so there is nothing to cancel. The continuous
        decode batcher (decode/batcher.py) holds generations mid-stream
        and marks them to end with ``Cancelled`` after the tokens already
        streamed."""

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client surface -------------------------------------------------------
    def submit(self, data, deadline_ms=None):
        """Enqueue one request (array or dict name -> array, at most
        ``max_batch`` rows); returns a ``ServingFuture``. With
        ``deadline_ms``, a request still queued at its deadline completes
        with ``DeadlineExceeded``."""
        arrays, rows = self.predictor.normalize_request(data)
        if rows > self.max_batch:
            raise MXNetError(f"request of {rows} rows exceeds max_batch="
                             f"{self.max_batch}; split it client-side or "
                             "call Predictor.predict directly")
        future = ServingFuture()
        deadline = time.perf_counter() + deadline_ms / 1e3 \
            if deadline_ms is not None else None
        with self._cond:
            if not self._running:
                raise MXNetError(f"DynamicBatcher '{self.name}' is not "
                                 "started")
            if self._queued_rows + rows > self.max_queue:
                self._shed += 1
                raise Overloaded(
                    f"serving queue at bound ({self._queued_rows} rows "
                    f"queued, max_queue={self.max_queue}); shedding load — "
                    "retry with backoff")
            self._queue.append(_Request(arrays, rows, future, deadline))
            self._queued_rows += rows
            self._cond.notify_all()
        return future

    def predict(self, data, deadline_ms=None, timeout=None):
        """Blocking convenience: ``submit(...).result(...)``."""
        return self.submit(data, deadline_ms=deadline_ms).result(timeout)

    # -- the batching loop ----------------------------------------------------
    def _take_batch(self):
        """Wait for work, coalesce up to max_batch rows (or until
        max_wait_us after the first request), drop expired requests.
        Returns a list of requests, or None at shutdown."""
        max_wait_s = self.max_wait_us / 1e6
        with self._cond:
            while self._running and not self._queue:
                self._cond.wait(timeout=0.1)
            if not self._queue:
                return None
            # linger for company unless the batch is full; a queued
            # deadline caps the linger
            t_first = self._queue[0].t_submit
            while self._running:
                rows = 0
                for r in self._queue:
                    if rows + r.rows > self.max_batch:
                        break
                    rows += r.rows
                launch_at = t_first + max_wait_s
                for r in self._queue:
                    if r.deadline is not None:
                        launch_at = min(launch_at,
                                        r.deadline - _DEADLINE_SLACK_S)
                remaining = launch_at - time.perf_counter()
                if rows >= self.max_batch or remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            batch, rows = [], 0
            now = time.perf_counter()
            while self._queue:
                r = self._queue[0]
                if r.deadline is not None and r.deadline < now:
                    self._queue.popleft()
                    self._queued_rows -= r.rows
                    self._deadline_missed += 1
                    r.future._complete(error=DeadlineExceeded(
                        f"deadline expired after "
                        f"{(now - r.t_submit) * 1e3:.1f} ms in queue"))
                    continue
                if rows + r.rows > self.max_batch:
                    break
                self._queue.popleft()
                self._queued_rows -= r.rows
                batch.append(r)
                rows += r.rows
        return batch

    def _loop(self):
        n_inputs = len(self.predictor.data_names)
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            if not batch:
                continue                         # everything expired
            rows = sum(r.rows for r in batch)
            bucket = self.predictor.bucket_for(rows)
            arrays = [np.concatenate([r.arrays[i] for r in batch], axis=0)
                      if len(batch) > 1 else batch[0].arrays[i]
                      for i in range(n_inputs)]
            try:
                outs = self.predictor._run_bucket(arrays, rows, bucket)
            except Exception as e:  # noqa: BLE001 - a failed batch fails
                for r in batch:     # its requests; the loop survives
                    r.future._complete(error=e)
                continue
            now = time.perf_counter()
            with self._lock:
                self._occ_rows[bucket] += rows
                self._occ_batches[bucket] += 1
                self._served += len(batch)
                self._latency_ms[bucket].extend(
                    (now - r.t_submit) * 1e3 for r in batch)
            start = 0
            for r in batch:
                mine = [o[start:start + r.rows] if is_b else o
                        for o, is_b in zip(outs,
                                           self.predictor.out_batched)]
                r.future._complete(
                    result=mine[0] if len(mine) == 1 else mine)
                start += r.rows

    # -- observability --------------------------------------------------------
    @property
    def queue_depth(self):
        """Currently queued rows."""
        with self._lock:
            return self._queued_rows

    def report(self, reset=False):
        """Per-bucket batches, rows, occupancy and p50/p99 latency (ms,
        submit to completion, over the last samples), plus queue depth
        and served / shed / deadline-missed counts."""
        with self._lock:
            per_bucket = {}
            for b in self.predictor.buckets:
                nb = self._occ_batches[b]
                lat = np.asarray(self._latency_ms[b], np.float64)
                per_bucket[b] = {
                    "batches": nb,
                    "rows": self._occ_rows[b],
                    "occupancy": self._occ_rows[b] / (nb * b) if nb
                    else None,
                    "p50_ms": float(np.percentile(lat, 50)) if lat.size
                    else None,
                    "p99_ms": float(np.percentile(lat, 99)) if lat.size
                    else None,
                }
            out = {
                "name": self.name,
                "predictor_id": self.predictor.telemetry_id,
                "max_batch": self.max_batch,
                "max_wait_us": self.max_wait_us,
                "max_queue": self.max_queue,
                "queue_depth": self._queued_rows,
                "served_requests": self._served,
                "shed_requests": self._shed,
                "deadline_missed": self._deadline_missed,
                "per_bucket": per_bucket,
            }
            if reset:
                for b in self.predictor.buckets:
                    self._occ_rows[b] = 0
                    self._occ_batches[b] = 0
                    self._latency_ms[b].clear()
                self._shed = 0
                self._deadline_missed = 0
                self._served = 0
        return out
