"""Worker-thread harness of the host data pipeline (counterpart of
``mxnet_tpu/data/workers.py``; stdlib only).

- :class:`WorkerGroup` spawns named daemon threads, keeps the first
  exception any of them raises and re-raises it on the consumer thread
  (``raise_error``): a worker's failure surfaces at ``next()``, never as
  an early end of data.
- ``q_put`` / ``q_get`` are bounded-queue operations that poll with a
  short timeout and give up once the group stops, so no thread blocks
  forever on a full or empty queue during shutdown.
- Every closeable registers in a process-wide ``WeakSet`` that an
  ``atexit`` hook closes, so an interrupted run joins its threads.
"""
from __future__ import annotations

import atexit
import queue
import threading
import time
import weakref

__all__ = ["WorkerGroup", "q_put", "q_get", "q_drain", "register_closeable"]

_POLL_S = 0.05


class WorkerGroup:
    """A set of daemon threads with captured-error + join-on-close
    semantics. One group per pipeline epoch/stream."""

    def __init__(self, name="workers"):
        self.name = name
        self._threads = []
        self._lock = threading.Lock()
        self._error = None
        self._stop = threading.Event()

    @property
    def stopped(self):
        return self._stop.is_set()

    def spawn(self, fn, *args, name=None):
        """Start a daemon thread running ``fn(*args)``; any exception it
        raises is captured (first one wins) and stops the group."""

        def _run():
            try:
                fn(*args)
            except BaseException as e:  # noqa: BLE001 — must never die silent
                self.fail(e)

        t = threading.Thread(target=_run, daemon=True,
                             name=name or f"{self.name}-{len(self._threads)}")
        self._threads.append(t)
        t.start()
        return t

    def fail(self, exc):
        """Record a worker failure and stop the group (first error wins)."""
        with self._lock:
            if self._error is None:
                self._error = exc
        self._stop.set()

    def error(self):
        with self._lock:
            return self._error

    def raise_error(self):
        """Re-raise the first captured worker exception on this thread."""
        err = self.error()
        if err is not None:
            raise err

    def stop(self):
        self._stop.set()

    def join(self, timeout=5.0):
        """Join every thread (bounded); True iff all exited."""
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in self._threads)

    def alive(self):
        return [t.name for t in self._threads if t.is_alive()]


def q_put(q, item, group, poll=_POLL_S):
    """Bounded put that can never deadlock shutdown: polls until the item
    lands or the group stops. Returns True iff the item was enqueued."""
    while not group.stopped:
        try:
            q.put(item, timeout=poll)
            return True
        except queue.Full:
            continue
    return False


def q_get(q, group, poll=_POLL_S):
    """Cooperative get: ``(True, item)`` or ``(False, None)`` once the
    group stops (error or shutdown)."""
    while not group.stopped:
        try:
            return True, q.get(timeout=poll)
        except queue.Empty:
            continue
    return False, None


def q_drain(q):
    """Empty a queue without blocking; returns how many items it held
    (unblocks producers stuck on a full queue during shutdown)."""
    n = 0
    while True:
        try:
            q.get_nowait()
            n += 1
        except queue.Empty:
            return n


# -- process-exit safety net --------------------------------------------------
_closeables = weakref.WeakSet()


def register_closeable(obj):
    """Track an object with a ``close()`` method; all live ones are closed
    at interpreter exit so interrupted runs never hang on pipeline
    threads blocked against a full queue."""
    _closeables.add(obj)


def _close_all():
    for obj in list(_closeables):
        try:
            obj.close()
        except Exception:
            pass


atexit.register(_close_all)
