"""Closed-loop load generation for decode serving (counterpart of the
token half of ``mxnet_tpu/serving/loadgen.py``).

``token_closed_loop`` drives a ``DecodeBatcher`` with barrier-started
client threads that submit prompts, iterate the streams and record time
to first token and every inter-token gap; ``mixed_prompts`` builds a
reproducible mixed prompt-length workload. Clients retry ``Overloaded``
with deadline-aware jittered exponential backoff (never a tight retry
storm, never a sleep past the request's deadline); retries and give-ups
are counted in ``client_report()``. The whole-request ``closed_loop``,
``ramp`` and ``raw_predict_rate`` come with the fleet (ROADMAP.md).
"""
from __future__ import annotations

import random
import threading
import time

import numpy as np

from . import Overloaded

__all__ = ["token_closed_loop", "mixed_prompts", "client_report"]

# client-side retry ledger (process-wide; client_report() reads it)
_client_lock = threading.Lock()
_retries = 0      # Overloaded submissions retried after backoff
_gave_up = 0      # Overloaded submissions abandoned (budget/deadline)


def client_report(reset: bool = False) -> dict:
    """``{"retries": n, "gave_up": n}`` of the clients in this process;
    ``reset=True`` starts a fresh window."""
    global _retries, _gave_up
    with _client_lock:
        out = {"retries": _retries, "gave_up": _gave_up}
        if reset:
            _retries = _gave_up = 0
    return out


def _note_retry():
    global _retries
    with _client_lock:
        _retries += 1


def _note_give_up():
    global _gave_up
    with _client_lock:
        _gave_up += 1


def _backoff_s(attempt, backoff_ms, jitter):
    """Jittered exponential backoff: base * 2^attempt, multiplied by a
    uniform draw from [1-jitter, 1+jitter] so retry waves decorrelate."""
    base = (backoff_ms / 1e3) * (2 ** attempt)
    return base * random.uniform(1.0 - jitter, 1.0 + jitter)


def _call_with_retry(fn, deadline, retries, backoff_ms, jitter):
    """Run ``fn()`` retrying ONLY on ``Overloaded``, sleeping the
    jittered exponential backoff between attempts, never sleeping past
    ``deadline`` (a perf_counter timestamp, or None). Re-raises the
    last ``Overloaded`` once the retry budget or the deadline is
    exhausted."""
    attempt = 0
    while True:
        try:
            return fn()
        except Overloaded:
            if attempt >= retries:
                _note_give_up()
                raise
            wait = _backoff_s(attempt, backoff_ms, jitter)
            if deadline is not None:
                room = deadline - time.perf_counter()
                if room <= 0:
                    _note_give_up()
                    raise
                wait = min(wait, room)
            _note_retry()
            time.sleep(wait)
            attempt += 1


def mixed_prompts(dist, vocab_size, n=None, seed=0):
    """Build a MIXED prompt-length workload from ``dist``
    (``{length: weight}``): ``n`` prompts (default ``sum(weights)``)
    whose lengths follow the weighted wheel exactly — a 3:1
    short:long distribution is exactly 3:1 across any window of
    ``sum(weights)`` consecutive draws, not a coin flip (same
    determinism idiom as :func:`ramp`'s tenant wheel). Token ids are
    drawn from a seeded RNG so the workload is reproducible and the
    bit-identity harnesses can replay it."""
    wheel = []
    for length, weight in sorted(dist.items()):
        if int(length) < 1:
            raise ValueError(f"prompt length must be >= 1, got {length}")
        wheel.extend([int(length)] * max(1, int(weight)))
    if not wheel:
        raise ValueError("mixed_prompts needs a non-empty distribution")
    if n is None:
        n = len(wheel)
    rs = np.random.RandomState(seed)
    return [rs.randint(int(vocab_size),
                       size=wheel[i % len(wheel)]).astype(np.int32)
            for i in range(int(n))]


def token_closed_loop(batcher, prompts, clients, per_client,
                      max_new_tokens=8, timeout=300, deadline_ms=None,
                      retries=0, backoff_ms=25, jitter=0.5):
    """Closed-loop token clients on a ``DecodeBatcher``: each of
    ``clients`` threads submits ``per_client`` prompts (drawn round-robin
    from ``prompts``), ITERATES each stream, and records time to first
    token plus every inter-token gap. Returns tokens/s and the TTFT and
    inter-token percentiles. ``retries`` > 0 retries an ``Overloaded``
    submit after jittered exponential backoff (``backoff_ms`` base,
    doubled per attempt, times a uniform ``1 +- jitter`` draw), never
    past ``deadline_ms``; a stream that already produced tokens is never
    replayed.

    ``prompts`` may mix lengths freely (see :func:`mixed_prompts`);
    the result's ``by_length`` section breaks TTFT/ITL percentiles
    down PER PROMPT-LENGTH BUCKET — the aggregate p99 of a mixed
    workload hides exactly the effect disaggregated prefill exists to
    fix (a long prompt's prefill landing between a short stream's
    tokens), so the per-bucket view is what the disagg-vs-unified
    comparison gates on."""
    ttfts, itls = [], []            # (prompt_len, seconds)
    tokens = [0]
    failed = [0]
    lock = threading.Lock()
    barrier = threading.Barrier(clients + 1)

    def client(cid):
        barrier.wait()
        my_ttft, my_itl, my_toks, my_failed = [], [], 0, 0
        for i in range(per_client):
            prompt = prompts[(cid + i * clients) % len(prompts)]
            plen = len(prompt)
            t_r = time.perf_counter()
            deadline = t_r + deadline_ms / 1e3 \
                if deadline_ms is not None else None
            try:
                stream = _call_with_retry(
                    lambda: batcher.submit(
                        prompt, max_new_tokens=max_new_tokens),
                    deadline, retries, backoff_ms, jitter)
            except Overloaded:
                my_failed += 1
                continue
            t_last = None
            for _ in stream:
                now = time.perf_counter()
                if t_last is None:
                    my_ttft.append((plen, now - t_r))
                else:
                    my_itl.append((plen, now - t_last))
                t_last = now
                my_toks += 1
        with lock:
            ttfts.extend(my_ttft)
            itls.extend(my_itl)
            tokens[0] += my_toks
            failed[0] += my_failed

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    deadline = t0 + timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    dt = time.perf_counter() - t0

    def _pct(xs, q):
        return float(np.percentile(xs, q)) * 1e3 if xs else None

    by_length = {}
    for plen in sorted({p for p, _ in ttfts} | {p for p, _ in itls}):
        bt = [s for p, s in ttfts if p == plen]
        bi = [s for p, s in itls if p == plen]
        by_length[plen] = {
            "streams": len(bt),
            "ttft_p50_ms": _pct(bt, 50),
            "ttft_p99_ms": _pct(bt, 99),
            "inter_token_p50_ms": _pct(bi, 50),
            "inter_token_p99_ms": _pct(bi, 99),
        }
    all_ttft = [s for _, s in ttfts]
    all_itl = [s for _, s in itls]
    return {
        "tok_s": tokens[0] / dt,
        "gen_s": clients * per_client / dt,
        "ttft_p50_ms": _pct(all_ttft, 50),
        "ttft_p99_ms": _pct(all_ttft, 99),
        "inter_token_p50_ms": _pct(all_itl, 50),
        "inter_token_p99_ms": _pct(all_itl, 99),
        "tokens": tokens[0],
        "wall_s": dt,
        "gave_up": failed[0],
        "by_length": by_length,
    }
