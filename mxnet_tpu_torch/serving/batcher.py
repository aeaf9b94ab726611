"""Dynamic micro-batcher: coalesce concurrent requests onto the buckets
(counterpart of ``mxnet_tpu/serving/batcher.py``).

A thread-safe queue coalesces requests up to ``max_batch`` rows or
``max_wait_us`` (whichever comes first), runs one bucket of the
Predictor, and splits the outputs back per request. Admission control
sheds load with ``Overloaded`` once queued rows would exceed
``max_queue``; a request whose deadline expires while queued completes
with ``DeadlineExceeded`` without taking a batch slot; ``start()`` warms
every bucket first.

Observability: per-bucket latency histograms in the telemetry registry
(``serving::<predictor id>::b<b>::latency_ms``, keyed by the predictor's
id so two replicas never share a series) and ``serving::<id>::batches``,
queue depth, occupancy and shed / deadline counters, read through
``serving_report()``. Every request carries a trace id (its future's
``trace_id``): with ``MXTPU_TRACE_DIR`` set a request is a
``serving:request`` span and its micro-batch a ``serving:batch`` span
(listing every member's trace id) with the Predictor's
``serving:bucket<b>`` span nested under it; with ``MXTPU_TELEMETRY_DIR``
set the ``serving_batch``, ``serving_overloaded`` and
``serving_deadline`` events carry the same ids. Each micro-batch runs
under a profiler task of the ``serving`` domain. Events and spans are
written after the futures complete, off the response path; ``stop()``
exports the trace.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from .. import config
from .. import profiler
from ..base import MXNetError
from ..telemetry import trace as _trace
from . import DeadlineExceeded, Overloaded, _register_batcher

__all__ = ["DynamicBatcher", "ServingFuture"]

_DEADLINE_SLACK_S = 0.002  # launch this early so an at-deadline
                           # request is still live when collected


class ServingFuture:
    """Completion handle for one submitted request. ``trace_id`` is the
    request's id in the trace and event-log surfaces."""

    __slots__ = ("_event", "_result", "_error", "trace_id")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error = None
        self.trace_id = None

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
    __slots__ = ("arrays", "rows", "future", "deadline", "t_submit",
                 "trace_id", "span_id")

    def __init__(self, arrays, rows, future, deadline):
        self.arrays = arrays
        self.rows = rows
        self.future = future
        self.deadline = deadline
        # every request has a trace id (a counter, no syscall): the
        # event log and the trace attribute it to THIS request
        self.trace_id = future.trace_id = _trace.new_trace_id()
        self.span_id = _trace.new_span_id()
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
        self._domain = profiler.Domain("serving")
        self._tasks = {b: self._domain.new_task(f"{name}::bucket{b}")
                       for b in predictor.buckets}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._queued_rows = 0
        self._running = False
        self._thread = None
        # counters (guarded by _lock)
        self._occ_rows = {b: 0 for b in predictor.buckets}
        self._occ_batches = {b: 0 for b in predictor.buckets}
        self._shed = 0
        self._deadline_missed = 0
        self._served = 0
        _register_batcher(self)
        # the latency windows are registry histograms keyed by the
        # PREDICTOR id: report() and the snapshots read one store
        from ..telemetry import registry as treg
        pid = predictor.telemetry_id
        self._lat_hist = {
            b: treg.histogram(f"serving::{pid}::b{b}::latency_ms")
            for b in predictor.buckets}
        self._batches_c = treg.counter(f"serving::{pid}::batches")

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
        if _trace.enabled():
            # flush the serving spans now that the loop is quiet
            _trace.export_trace()
        from ..telemetry import export as _texp
        _texp.release()      # the event log's file, until the next event

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
        req = _Request(arrays, rows, future, deadline)
        with self._cond:
            if not self._running:
                raise MXNetError(f"DynamicBatcher '{self.name}' is not "
                                 "started")
            if self._queued_rows + rows > self.max_queue:
                self._shed += 1
                shed_depth = self._queued_rows
            else:
                shed_depth = None
                self._queue.append(req)
                self._queued_rows += rows
                self._cond.notify_all()
        if shed_depth is not None:
            # the event and span carry the shed request's trace id;
            # written outside the queue lock, on the failing path only
            self._shed_event(req, shed_depth)
            raise Overloaded(
                f"serving queue at bound ({shed_depth} rows "
                f"queued, max_queue={self.max_queue}); shedding load — "
                "retry with backoff")
        return future

    def _shed_event(self, req, queue_rows):
        from ..telemetry import export as _texp
        if _texp.enabled():
            _texp.emit_event(
                "serving_overloaded", batcher=self.telemetry_id,
                predictor=self.predictor.telemetry_id,
                trace_id=req.trace_id, rows=req.rows,
                queue_rows=queue_rows, max_queue=self.max_queue)
        if _trace.enabled():
            _trace.record_span(
                "serving:request", "serving", req.t_submit,
                time.perf_counter() - req.t_submit,
                trace_id=req.trace_id, span_id=req.span_id,
                args={"rows": req.rows, "error": "Overloaded"})

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
            batch, rows, expired = [], 0, []
            now = time.perf_counter()
            while self._queue:
                r = self._queue[0]
                if r.deadline is not None and r.deadline < now:
                    self._queue.popleft()
                    self._queued_rows -= r.rows
                    self._deadline_missed += 1
                    waited_ms = (now - r.t_submit) * 1e3
                    r.future._complete(error=DeadlineExceeded(
                        f"deadline expired after "
                        f"{waited_ms:.1f} ms in queue"))
                    expired.append((r, waited_ms))
                    continue
                if rows + r.rows > self.max_batch:
                    break
                self._queue.popleft()
                self._queued_rows -= r.rows
                batch.append(r)
                rows += r.rows
        # expired requests' events and spans, outside the queue lock and
        # after their futures completed
        from ..telemetry import export as _texp
        for r, waited_ms in expired:
            if _texp.enabled():
                _texp.emit_event(
                    "serving_deadline", batcher=self.telemetry_id,
                    predictor=self.predictor.telemetry_id,
                    trace_id=r.trace_id, rows=r.rows,
                    waited_ms=round(waited_ms, 3))
            if _trace.enabled():
                _trace.record_span(
                    "serving:request", "serving", r.t_submit,
                    waited_ms / 1e3, trace_id=r.trace_id,
                    span_id=r.span_id,
                    args={"rows": r.rows, "error": "DeadlineExceeded"})
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
                # the batch span adopts the first member's trace and lists
                # every member's trace id; the Predictor's bucket span
                # nests under it (the thread's open span is its parent)
                with _trace.span(
                        "serving:batch", cat="serving",
                        trace=batch[0].trace_id,
                        args={"batcher": self.telemetry_id,
                              "bucket": bucket, "rows": rows,
                              "requests": len(batch),
                              "trace_ids": [r.trace_id for r in batch]}
                ) as bspan, self._tasks[bucket]:
                    outs = self.predictor._run_bucket(arrays, rows,
                                                      bucket)
            except Exception as e:  # noqa: BLE001 - a failed batch fails
                for r in batch:     # its requests; the loop survives
                    r.future._complete(error=e)
                continue
            now = time.perf_counter()
            with self._lock:
                self._occ_rows[bucket] += rows
                self._occ_batches[bucket] += 1
                self._served += len(batch)
            hist = self._lat_hist[bucket]
            for r in batch:
                hist.observe((now - r.t_submit) * 1e3)
            self._batches_c.inc()
            start = 0
            for r in batch:
                mine = [o[start:start + r.rows] if is_b else o
                        for o, is_b in zip(outs,
                                           self.predictor.out_batched)]
                r.future._complete(
                    result=mine[0] if len(mine) == 1 else mine)
                start += r.rows
            # request spans and the event AFTER the futures complete:
            # the exporter's disk append never sits on the response path
            if _trace.enabled():
                for r in batch:
                    _trace.record_span(
                        "serving:request", "serving", r.t_submit,
                        now - r.t_submit, trace_id=r.trace_id,
                        span_id=r.span_id,
                        args={"rows": r.rows,
                              "batch_span": bspan.span_id})
            from ..telemetry import export as _texp
            if _texp.enabled():
                _texp.emit_event(
                    "serving_batch", batcher=self.telemetry_id,
                    predictor=self.predictor.telemetry_id,
                    bucket=bucket, rows=rows, requests=len(batch),
                    trace_ids=[r.trace_id for r in batch],
                    max_latency_ms=round(max(
                        (now - r.t_submit) * 1e3 for r in batch), 3))

    # -- observability --------------------------------------------------------
    @property
    def queue_depth(self):
        """Currently queued rows."""
        with self._lock:
            return self._queued_rows

    def report(self, reset=False):
        """Per-bucket batches, rows, occupancy and p50/p99 latency (ms,
        submit to completion, from the registry histograms), plus queue
        depth and served / shed / deadline-missed counts."""
        from ..telemetry import registry as treg
        with self._lock:
            per_bucket = {}
            for b in self.predictor.buckets:
                h = self._lat_hist[b]
                hsnap = treg.snapshot(reset=reset,
                                      prefix=h.name).get(h.name, {})
                nb = self._occ_batches[b]
                per_bucket[b] = {
                    "batches": nb,
                    "rows": self._occ_rows[b],
                    "occupancy": self._occ_rows[b] / (nb * b) if nb
                    else None,
                    "p50_ms": hsnap.get("p50"),
                    "p99_ms": hsnap.get("p99"),
                }
            out = {
                "id": self.telemetry_id,
                "name": self.name,
                "predictor_id": self.predictor.telemetry_id,
                "max_batch": self.max_batch,
                "max_wait_us": self.max_wait_us,
                "max_queue": self.max_queue,
                "queue_depth": self._queued_rows,
                "served_requests": self._served,
                "shed_requests": self._shed,
                "deadline_missed": self._deadline_missed,
                "retraces": self.predictor.retraces,
                "per_bucket": per_bucket,
            }
            if reset:
                for b in self.predictor.buckets:
                    self._occ_rows[b] = 0
                    self._occ_batches[b] = 0
                self._shed = 0
                self._deadline_missed = 0
                self._served = 0
        return out
