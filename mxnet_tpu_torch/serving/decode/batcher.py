"""Continuous batching: requests join and leave the decode batch per
TOKEN (counterpart of ``mxnet_tpu/serving/decode/batcher.py``).

Every loop iteration advances ALL in-flight generations one token through
the engine's single decode program, and a lane freed by a finished
generation is backfilled from the queue mid-flight: a prefill for the
newcomer, then it rides the next decode step with everyone else.

This class IS a ``DynamicBatcher``: admission control sheds past
``max_queue`` queued requests with ``Overloaded``; deadlines bound QUEUE
time (a generation that started streams to completion); ``max_wait_us``
is the first-fill window (when nothing is in flight, the first queued
prompt lingers for company so a cold burst prefills together; joins next
to running generations are immediate).

Speculative stepping: with a ``SpecDecodePredictor`` the per-iteration
advance is ``spec_step`` (up to k+1 tokens a lane a round, the same
stream); ``submit(..., speculative=False)`` pins one lane to plain
semantics. Roles (disaggregated prefill/decode): a ``role="prefill"``
batcher fills a lane, streams token #1 and hands the lane to a decode
replica (``set_handoff`` / ``adopt``); a lost transfer (the ``kv_handoff``
fault site) makes the adopting side re-prefill from the prompt, which is
deterministic, so no token is dropped or repeated. A declined handoff
decodes locally.

``submit`` returns a :class:`StreamFuture`: iterate it for tokens as they
decode, or ``result()`` for the whole stream. ``stop(drain=True)`` runs
every in-flight generation to completion; ``stop(drain=False)`` ends
them with ``serving.Cancelled`` after the tokens already streamed, and
fails queued requests with ``Overloaded``; a future is always completed,
even when the loop crashes. Time to first token, inter-token and handoff
times are kept as plain samples (the last 4096 of each), with p50 and
p99 in ``report()``; the port has no telemetry registry yet.
"""
from __future__ import annotations

import collections
import logging
import threading
import time

import numpy as np

from ... import config
from ...base import MXNetError
from .. import Cancelled, DeadlineExceeded, Overloaded
from ..batcher import DynamicBatcher, _DEADLINE_SLACK_S, _LATENCY_WINDOW

__all__ = ["DecodeBatcher", "StreamFuture"]


def _run_callback(cb, fut):
    try:
        cb(fut)
    except Exception:                      # noqa: BLE001
        logging.getLogger("mxnet_tpu_torch.serving").exception(
            "StreamFuture done-callback failed")


def _pct(samples, q):
    return float(np.percentile(np.asarray(samples, np.float64), q)) \
        if samples else None


class StreamFuture:
    """Completion handle for one generation that STREAMS.

    Iterate to receive tokens as they decode::

        for tok in batcher.submit(prompt):
            ...

    ``result(timeout)`` blocks for the full token list. A failed or
    cancelled generation delivers its already-streamed tokens, then the
    iterator (and ``result``) raises the error, ``Cancelled`` on
    ``stop(drain=False)``: never a hang."""

    __slots__ = ("_cond", "_tokens", "_done", "_error", "_callbacks")

    def __init__(self):
        self._cond = threading.Condition()
        self._tokens = []
        self._done = False
        self._error = None
        self._callbacks = []

    # producer side (batcher loop)
    def _push(self, tok):
        with self._cond:
            self._tokens.append(tok)
            self._cond.notify_all()

    def _finish(self, error=None):
        with self._cond:
            if self._done:
                return
            self._done = True
            self._error = error
            cbs, self._callbacks = self._callbacks, []
            self._cond.notify_all()
        for cb in cbs:
            _run_callback(cb, self)

    def add_done_callback(self, fn):
        """Run ``fn(self)`` when the stream terminates (at once when it
        already has)."""
        with self._cond:
            if not self._done:
                self._callbacks.append(fn)
                return
        _run_callback(fn, self)

    def _complete(self, result=None, error=None):
        """Base-class completion contract (``DynamicBatcher.stop`` sheds
        queued futures through this)."""
        self._finish(error=error)

    # consumer side
    def done(self):
        with self._cond:
            return self._done

    def tokens_so_far(self):
        with self._cond:
            return list(self._tokens)

    def __iter__(self):
        idx = 0
        while True:
            with self._cond:
                while len(self._tokens) <= idx and not self._done:
                    self._cond.wait(0.1)
                if len(self._tokens) > idx:
                    tok = self._tokens[idx]
                    idx += 1
                else:
                    if self._error is not None:
                        raise self._error
                    return
            yield tok

    def result(self, timeout=None):
        deadline = time.perf_counter() + timeout \
            if timeout is not None else None
        with self._cond:
            while not self._done:
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("generation still streaming")
                self._cond.wait(remaining if remaining is not None
                                else 0.1)
            if self._error is not None:
                raise self._error
            return list(self._tokens)


class _GenRequest:
    __slots__ = ("prompt", "max_new_tokens", "stop_token", "future",
                 "deadline", "t_submit", "rows", "speculative")

    def __init__(self, prompt, max_new_tokens, stop_token, future,
                 deadline, speculative=True):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.stop_token = stop_token
        self.future = future
        self.deadline = deadline
        self.rows = 1                      # the base batcher's queue unit
        self.speculative = bool(speculative)
        self.t_submit = time.perf_counter()


class _Adoption:
    """One lane arriving from a prefill replica: the request, its
    already-streamed progress and the exported lane, or ``lane=None``
    when the transfer was lost (the adopting side re-prefills)."""

    __slots__ = ("req", "last", "produced", "lane", "t0")

    def __init__(self, req, last, produced, lane, t0):
        self.req = req
        self.last = last
        self.produced = produced
        self.lane = lane
        self.t0 = t0


class _Gen:
    """One in-flight generation: a claimed slot plus stream state."""

    __slots__ = ("req", "slot", "bucket", "last", "produced", "limit",
                 "t_first", "t_last")

    def __init__(self, req, slot, bucket, limit):
        self.req = req
        self.slot = slot
        self.bucket = bucket
        self.limit = limit
        self.last = None
        self.produced = 0
        self.t_first = None
        self.t_last = None

    def finished(self):
        return self.produced >= self.limit or \
            (self.req.stop_token is not None and
             self.last == self.req.stop_token)


class DecodeBatcher(DynamicBatcher):
    """Continuous-batching server over a :class:`DecodePredictor`.

    Parameters
    ----------
    predictor : DecodePredictor
    max_wait_us : int, optional
        First-fill window (default MXTPU_DECODE_MAX_WAIT_US).
    max_queue : int, optional
        Queued-REQUEST bound (default MXTPU_DECODE_MAX_QUEUE).
    name : str
    role : str
        ``"unified"`` (prefill and decode here), ``"prefill"`` (fill
        lanes, then hand each to a decode replica through
        ``set_handoff``; decodes locally when none takes it) or
        ``"decode"`` (adopts handed-off lanes via :meth:`adopt`; direct
        ``submit`` still works).
    speculative : bool, optional
        Advance lanes through the predictor's ``spec_step`` (default:
        exactly when the predictor has one). Streams are the same
        either way.
    """

    def __init__(self, predictor, max_wait_us=None, max_queue=None,
                 name="decode", role="unified", speculative=None):
        if max_wait_us is None:
            max_wait_us = int(config.get("MXTPU_DECODE_MAX_WAIT_US"))
        if max_queue is None:
            max_queue = int(config.get("MXTPU_DECODE_MAX_QUEUE"))
        if role not in ("unified", "prefill", "decode"):
            raise MXNetError(
                f"role={role!r} must be unified|prefill|decode")
        super().__init__(predictor, max_batch=predictor.slots,
                         max_wait_us=max_wait_us, max_queue=max_queue,
                         name=name)
        self.role = role
        if speculative is None:
            speculative = hasattr(predictor, "spec_step")
        elif speculative and not hasattr(predictor, "spec_step"):
            raise MXNetError(
                "speculative=True needs a SpecDecodePredictor "
                "(predictor has no spec_step)")
        self.speculative = bool(speculative)
        self._ttft_ms = collections.deque(maxlen=_LATENCY_WINDOW)
        self._itl_ms = collections.deque(maxlen=_LATENCY_WINDOW)
        self._handoff_ms = collections.deque(maxlen=_LATENCY_WINDOW)
        self._inflight = {}                # slot -> _Gen (under _lock)
        self._adopt_q = collections.deque()  # _Adoption (under _cond)
        self._handoff_fn = None
        self._handoffs = 0
        self._handoff_failures = 0
        self._adopted = 0
        self._cancel_requested = False
        self._cancelled = 0
        self._streamed_tokens = 0

    # -- client surface -------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, stop_token=None,
               deadline_ms=None, speculative=True):
        """Enqueue one generation; returns a :class:`StreamFuture`.

        ``max_new_tokens`` counts the whole stream including token #1 and
        is clamped to the cache capacity (``gen_limit``); ``stop_token``
        ends the stream after being yielded; ``deadline_ms`` bounds queue
        time only; ``speculative=False`` pins this lane to plain decode
        on a speculative batcher (same output)."""
        prompt = self.predictor.check_prompt(prompt)
        self.predictor.bucket_for(prompt.shape[0])  # validates length
        future = StreamFuture()
        deadline = time.perf_counter() + deadline_ms / 1e3 \
            if deadline_ms is not None else None
        req = _GenRequest(prompt, max_new_tokens, stop_token, future,
                          deadline, speculative=speculative)
        with self._cond:
            if not self._running:
                raise MXNetError(
                    f"DecodeBatcher '{self.name}' is not started")
            if self._queued_rows + 1 > self.max_queue:
                self._shed += 1
                raise Overloaded(
                    f"decode queue at bound ({self._queued_rows} requests "
                    f"queued, max_queue={self.max_queue}); shedding load, "
                    "retry with backoff")
            self._queue.append(req)
            self._queued_rows += 1
            self._cond.notify_all()
        return future

    def generate(self, prompt, max_new_tokens=None, stop_token=None,
                 deadline_ms=None):
        """Streaming convenience: submit and iterate tokens."""
        return iter(self.submit(prompt, max_new_tokens=max_new_tokens,
                                stop_token=stop_token,
                                deadline_ms=deadline_ms))

    # -- disaggregated prefill/decode -----------------------------------------
    def set_handoff(self, fn):
        """Install the prefill-role handoff sink ``fn(req, last, produced,
        lane, t0) -> bool`` (a decode replica's :meth:`adopt`). ``lane``
        is ``export_lane``'s dict, or None when the transfer was lost
        (the sink must still place the request: the decode side
        re-prefills). Returning False, or raising, keeps the generation
        here: zero dropped streams."""
        self._handoff_fn = fn

    def adopt(self, req, last, produced, lane, t0=None):
        """Take over a generation whose lane a prefill replica filled. The
        lane lands in a free local slot at the next poll; ``lane=None``
        re-prefills from the prompt (the recomputed token #1 equals the
        one already streamed and is not pushed again)."""
        with self._cond:
            if not self._running:
                raise MXNetError(
                    f"DecodeBatcher '{self.name}' is not started")
            self._adopt_q.append(_Adoption(req, last, produced, lane, t0))
            self._cond.notify_all()
        return req.future

    def _handoff_gen(self, g):
        """Prefill-role epilogue for one freshly filled lane: export it and
        offer it to the sink. The ``kv_handoff`` fault site loses the
        exported rows (the sink gets ``lane=None``); ``action=kill`` dies
        outright. A declining sink leaves the generation here."""
        from ... import faultinject
        t0 = time.perf_counter()
        lane = None
        try:
            if faultinject.fire("kv_handoff", slot=g.slot):
                raise faultinject.FaultInjected("kv_handoff", slot=g.slot)
            lane = self.predictor.export_lane(g.slot)
        except Exception:                    # noqa: BLE001
            lane = None
        ok = False
        try:
            ok = bool(self._handoff_fn(g.req, g.last, g.produced, lane,
                                       t0))
        except Exception:                    # noqa: BLE001
            ok = False
        if ok:
            self.predictor.release(g.slot)
            with self._lock:
                self._handoffs += 1
        else:
            with self._lock:
                self._handoff_failures += 1
                self._inflight[g.slot] = g

    def _start_adopted(self, a, slot):
        """Land one adopted lane (outside the queue lock): import the rows,
        or re-prefill from the prompt when the handoff was lost."""
        req = a.req
        plen = req.prompt.shape[0]
        bucket = self.predictor.bucket_for(plen)
        limit = self.predictor.gen_limit(plen, req.max_new_tokens)
        landed = False
        if a.lane is not None:
            try:
                self.predictor.import_lane(slot, a.lane, prompt=req.prompt)
                landed = True
            except Exception:                # noqa: BLE001
                landed = False
        if not landed:
            try:
                self.predictor.prefill(slot, req.prompt)
            except Exception as e:           # noqa: BLE001
                self.predictor.release(slot)
                req.future._finish(error=e)
                return
        now = time.perf_counter()
        g = _Gen(req, slot, bucket, limit)
        g.last = a.last
        g.produced = a.produced
        g.t_first = g.t_last = now
        with self._lock:
            if a.t0 is not None:
                self._handoff_ms.append((now - a.t0) * 1e3)
            self._adopted += 1
        if g.finished():
            self._complete_gen(g)
        else:
            with self._lock:
                self._inflight[slot] = g

    # -- stop() contract ------------------------------------------------------
    def _cancel_inflight(self):
        # under the queue lock, from stop(drain=False): mark the in-flight
        # generations; the LOOP completes their futures with Cancelled
        # (completing here would race the step about to push tokens)
        self._cancel_requested = True
        self._cond.notify_all()

    # -- the continuous-batching loop ----------------------------------------
    def _take_cancelled(self):
        with self._cond:
            if not self._cancel_requested:
                return None
            self._cancel_requested = False
            victims = list(self._inflight.values())
            self._inflight.clear()
        return victims

    def _poll(self):
        """Admission decisions under the queue lock: ``(admitted, adopted)``
        as ``(request or _Adoption, slot)`` pairs with lanes pre-claimed
        (adopted lanes first: they hold a live stream), or ``None`` at a
        clean exit. Expired requests complete with DeadlineExceeded."""
        max_wait_s = self.max_wait_us / 1e6
        with self._cond:
            while self._running and not self._queue and \
                    not self._inflight and not self._adopt_q and \
                    not self._cancel_requested:
                self._cond.wait(timeout=0.1)
            if self._cancel_requested:
                return [], []
            if not self._queue and not self._inflight and \
                    not self._adopt_q:
                return None                         # stopped + drained
            adopted = []
            while self._adopt_q:
                slot = self.predictor.alloc_slot()
                if slot is None:
                    break                           # lanes saturated
                adopted.append((self._adopt_q.popleft(), slot))
            if self._queue and not self._inflight and not adopted \
                    and self._running:
                # first-fill linger; queued deadlines cap it
                t_first = self._queue[0].t_submit
                while self._running and not self._adopt_q and \
                        len(self._queue) < self.predictor.slots:
                    launch_at = t_first + max_wait_s
                    for r in self._queue:
                        if r.deadline is not None and \
                                r.deadline - _DEADLINE_SLACK_S < launch_at:
                            launch_at = r.deadline - _DEADLINE_SLACK_S
                    remaining = launch_at - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
            admitted = []
            now = time.perf_counter()
            while self._queue:
                r = self._queue[0]
                if r.deadline is not None and r.deadline < now:
                    self._queue.popleft()
                    self._queued_rows -= 1
                    self._deadline_missed += 1
                    r.future._finish(error=DeadlineExceeded(
                        f"deadline expired after "
                        f"{(now - r.t_submit) * 1e3:.1f} ms in queue"))
                    continue
                slot = self.predictor.alloc_slot()
                if slot is None:
                    break                            # lanes saturated
                self._queue.popleft()
                self._queued_rows -= 1
                admitted.append((r, slot))
        return admitted, adopted

    def _start_gen(self, req, slot):
        """Prefill a newly admitted request into its lane (outside the
        queue lock: a capture or a program run never blocks submit) and
        stream token #1."""
        plen = req.prompt.shape[0]
        bucket = self.predictor.bucket_for(plen)
        limit = self.predictor.gen_limit(plen, req.max_new_tokens)
        try:
            tok = self.predictor.prefill(slot, req.prompt)
        except Exception as e:                       # noqa: BLE001
            self.predictor.release(slot)
            req.future._finish(error=e)
            return
        now = time.perf_counter()
        g = _Gen(req, slot, bucket, limit)
        g.last = tok
        g.produced = 1
        g.t_first = g.t_last = now
        req.future._push(tok)
        with self._lock:
            self._ttft_ms.append((now - req.t_submit) * 1e3)
            self._streamed_tokens += 1
        if g.finished():
            self._complete_gen(g)
        elif self.role == "prefill" and self._handoff_fn is not None:
            self._handoff_gen(g)
        else:
            with self._lock:
                self._inflight[slot] = g

    def _step(self):
        """Advance every in-flight generation one token (plain decode) or
        up to k+1 (``spec_step``); retire finished lanes (their slots
        backfill at the next poll). A failed program fails the
        generations that were in it; the loop survives."""
        with self._lock:
            active = dict(self._inflight)
        if not active:
            return
        try:
            if self.speculative:
                out = self.predictor.spec_step(
                    {slot: (g.last, g.limit - g.produced,
                            g.req.speculative)
                     for slot, g in active.items()})
            else:
                out = {slot: [tok] for slot, tok in
                       self.predictor.decode(
                           {slot: g.last for slot, g in active.items()}
                       ).items()}
        except Exception as e:                       # noqa: BLE001
            with self._lock:
                for slot in active:
                    self._inflight.pop(slot, None)
            for slot, g in active.items():
                self.predictor.release(slot)
                g.req.future._finish(error=e)
            return
        now = time.perf_counter()
        finished = []
        pushes = []
        with self._lock:
            for slot, g in active.items():
                # a speculative round may overshoot a stop_token: take
                # committed tokens only up to the finish
                for tok in out[slot]:
                    g.last = tok
                    g.produced += 1
                    self._itl_ms.append((now - g.t_last) * 1e3)
                    g.t_last = now
                    self._streamed_tokens += 1
                    pushes.append((g.req.future, tok))
                    if g.finished():
                        break
                if g.finished():
                    self._inflight.pop(slot, None)
                    finished.append(g)
        for fut, tok in pushes:
            fut._push(tok)
        for g in finished:
            self._complete_gen(g)

    def _complete_gen(self, g, error=None):
        self.predictor.release(g.slot)
        now = time.perf_counter()
        with self._lock:
            self._served += 1
            self._latency_ms[g.bucket].append((now - g.req.t_submit) * 1e3)
        g.req.future._finish(error=error)

    def _loop(self):
        try:
            while True:
                victims = self._take_cancelled()
                if victims is not None:
                    for g in victims:
                        self.predictor.release(g.slot)
                        with self._lock:
                            self._cancelled += 1
                        g.req.future._finish(error=Cancelled(
                            f"server stopped after {g.produced} of "
                            f"{g.limit} tokens"))
                    continue
                work = self._poll()
                if work is None:
                    return
                admitted, adopted = work
                for a, slot in adopted:
                    self._start_adopted(a, slot)
                for r, slot in admitted:
                    self._start_gen(r, slot)
                self._step()
        finally:
            # whatever the exit path (clean drain, cancellation, a crashed
            # loop body), every remaining future completes
            with self._cond:
                victims = list(self._inflight.values())
                self._inflight.clear()
                queued = list(self._queue)
                self._queue.clear()
                self._queued_rows = 0
                orphaned = list(self._adopt_q)
                self._adopt_q.clear()
                self._cancel_requested = False
            for a in orphaned:
                a.req.future._finish(error=Cancelled(
                    f"serving loop exited with the adopted lane unlanded "
                    f"after {a.produced} tokens"))
            for g in victims:
                self.predictor.release(g.slot)
                with self._lock:
                    self._cancelled += 1
                g.req.future._finish(error=Cancelled(
                    f"serving loop exited after {g.produced} of "
                    f"{g.limit} tokens"))
            for r in queued:
                r.future._finish(error=Cancelled(
                    "serving loop exited before this generation started"))

    # -- observability --------------------------------------------------------
    @property
    def inflight(self):
        with self._lock:
            return len(self._inflight)

    def report(self, reset=False):
        """Generations, tokens, queue and shed counters, and p50/p99 (ms)
        of time to first token, inter-token gaps, handoffs and whole
        generations per prompt bucket, over the last samples."""
        with self._lock:
            per_bucket = {
                b: {"generations": len(self._latency_ms[b]),
                    "p50_ms": _pct(self._latency_ms[b], 50),
                    "p99_ms": _pct(self._latency_ms[b], 99)}
                for b in self.predictor.buckets}
            out = {
                "name": self.name,
                "predictor_id": self.predictor.telemetry_id,
                "slots": self.predictor.slots,
                "max_wait_us": self.max_wait_us,
                "max_queue": self.max_queue,
                "queue_depth": self._queued_rows,
                "inflight": len(self._inflight),
                "served_generations": self._served,
                "streamed_tokens": self._streamed_tokens,
                "cancelled": self._cancelled,
                "shed_requests": self._shed,
                "deadline_missed": self._deadline_missed,
                "retraces": self.predictor.retraces,
                "ttft_p50_ms": _pct(self._ttft_ms, 50),
                "ttft_p99_ms": _pct(self._ttft_ms, 99),
                "inter_token_p50_ms": _pct(self._itl_ms, 50),
                "inter_token_p99_ms": _pct(self._itl_ms, 99),
                "per_bucket": per_bucket,
                "role": self.role,
                "speculative": self.speculative,
                "handoffs": self._handoffs,
                "handoff_failures": self._handoff_failures,
                "adopted": self._adopted,
                "handoff_p50_ms": _pct(self._handoff_ms, 50),
                "handoff_p99_ms": _pct(self._handoff_ms, 99),
            }
            if reset:
                for d in ([self._ttft_ms, self._itl_ms, self._handoff_ms]
                          + list(self._latency_ms.values())):
                    d.clear()
                self._served = 0
                self._shed = 0
                self._deadline_missed = 0
                self._cancelled = 0
                self._streamed_tokens = 0
                self._handoffs = 0
                self._handoff_failures = 0
                self._adopted = 0
        return out
