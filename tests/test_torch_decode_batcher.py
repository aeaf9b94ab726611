"""The port's ``DecodeBatcher`` on the CPU: behaviour pins of
``tests/test_decode.py``.

``stop`` with and without drain (never a hung future), shedding past
``max_queue``, deadlines that bound queue time only, the report's
per-token latency figures, the live-engine registry, and the
``decode_step`` fault site (raise and sleep).
"""
import time

import pytest

from mxnet_tpu_torch import faultinject, serving
from mxnet_tpu_torch.serving import Cancelled, DeadlineExceeded, Overloaded
from mxnet_tpu_torch.serving.decode import DecodeBatcher

from torch_decode_helpers import make_engine, make_prompts
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.serving


# ---------------------------------------------------------------------------
# stop(): the never-a-hung-future contract
# ---------------------------------------------------------------------------
def test_stop_drain_true_completes_inflight():
    eng = make_engine("draintrue", slots=2)
    prompts = make_prompts(4)
    solo = [list(eng.generate(p, max_new_tokens=30)) for p in prompts]
    bat = DecodeBatcher(eng, max_wait_us=0, name="draintrue").start()
    futs = [bat.submit(p, max_new_tokens=30) for p in prompts]
    bat.stop()
    assert [f.result(timeout=1) for f in futs] == solo


def test_stop_no_drain_cancels_partial_generations():
    eng = make_engine("drainfalse", slots=2)
    p = make_prompts(1)[0]
    bat = DecodeBatcher(eng, max_wait_us=0, name="drainfalse").start()
    fut = bat.submit(p, max_new_tokens=5000)
    it = iter(fut)
    got = [next(it), next(it)]
    bat.stop(drain=False)
    with pytest.raises(Cancelled):
        for t in it:
            got.append(t)
    assert fut.done() and len(got) >= 2
    assert got == list(eng.generate(p, max_new_tokens=len(got)))
    with pytest.raises(Cancelled):
        fut.result(timeout=1)
    bat.start()
    assert bat.submit(p, max_new_tokens=3).result(timeout=120) == \
        list(eng.generate(p, max_new_tokens=3))
    bat.stop()


def test_stop_no_drain_fails_queued_with_overloaded():
    eng = make_engine("shedq", slots=1)
    bat = DecodeBatcher(eng, max_wait_us=0, name="shedq").start()
    hog = bat.submit(make_prompts(1)[0], max_new_tokens=3000)
    next(iter(hog))
    queued = [bat.submit(p, max_new_tokens=4)
              for p in make_prompts(3, seed=9)]
    bat.stop(drain=False)
    with pytest.raises(Cancelled):
        hog.result(timeout=1)
    for f in queued:
        with pytest.raises(Overloaded):
            f.result(timeout=1)


# ---------------------------------------------------------------------------
# admission control and deadlines at token granularity
# ---------------------------------------------------------------------------
def test_submit_sheds_past_max_queue():
    eng = make_engine("shed", slots=1)
    with DecodeBatcher(eng, max_wait_us=0, max_queue=1,
                       name="shed") as bat:
        hog = bat.submit(make_prompts(1)[0], max_new_tokens=500)
        next(iter(hog))
        bat.submit(make_prompts(1, seed=3)[0], max_new_tokens=2)
        with pytest.raises(Overloaded):
            bat.submit(make_prompts(1, seed=4)[0], max_new_tokens=2)
        assert bat.report()["shed_requests"] == 1
        hog.result(timeout=120)


def test_deadline_bounds_queue_time_only():
    eng = make_engine("deadline", slots=1)
    p = make_prompts(1)[0]
    with DecodeBatcher(eng, max_wait_us=0, name="deadline") as bat:
        hog = bat.submit(p, max_new_tokens=200)
        late = bat.submit(make_prompts(1, seed=5)[0], max_new_tokens=4,
                          deadline_ms=1)
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=120)
        assert len(hog.result(timeout=120)) == eng.gen_limit(len(p), 200)
        assert bat.report()["deadline_missed"] == 1


# ---------------------------------------------------------------------------
# observability: per-token latency samples, the live-engine registry
# ---------------------------------------------------------------------------
def test_token_latency_report():
    eng = make_engine("teleme", slots=2)
    with DecodeBatcher(eng, max_wait_us=100, name="teleme") as bat:
        futs = [bat.submit(p, max_new_tokens=6) for p in make_prompts(4)]
        for f in futs:
            f.result(timeout=120)
        rep = bat.report()
    assert rep["ttft_p50_ms"] is not None
    assert rep["ttft_p99_ms"] >= rep["ttft_p50_ms"]
    assert rep["inter_token_p50_ms"] is not None
    assert rep["streamed_tokens"] == 24
    assert rep["predictor_id"] == eng.telemetry_id
    assert eng.report()["tokens"] == 24
    assert sum(b["generations"] for b in rep["per_bucket"].values()) == 4
    assert bat.report(reset=True)["served_generations"] == 4
    assert bat.report()["ttft_p50_ms"] is None
    assert eng in set(serving._DECODERS)


def test_engine_released_with_its_last_reference():
    import gc
    eng = make_engine("reaped", slots=1)
    pid = eng.telemetry_id
    list(eng.generate(make_prompts(1)[0], max_new_tokens=2))
    assert pid in {d.telemetry_id for d in serving._DECODERS}
    del eng
    gc.collect()
    assert pid not in {d.telemetry_id for d in serving._DECODERS}


# ---------------------------------------------------------------------------
# faultinject: the decode_step site
# ---------------------------------------------------------------------------
def test_decode_step_fault_fails_inflight_and_loop_survives():
    """An armed decode_step raise fires BEFORE the program advances the
    cache: the in-flight generations fail with FaultInjected, their
    lanes free, the loop survives, and re-submission reproduces the
    reference streams bit for bit."""
    eng = make_engine("faulty", slots=2)
    prompts = make_prompts(2)
    solo = [list(eng.generate(p, max_new_tokens=6)) for p in prompts]
    steps_now = eng.report()["decode_steps"]
    with DecodeBatcher(eng, max_wait_us=50_000, name="faulty") as bat:
        with faultinject.inject(decode_step={"token": steps_now + 3}):
            futs = [bat.submit(p, max_new_tokens=6) for p in prompts]
            errs = []
            for f in futs:
                with pytest.raises(faultinject.FaultInjected) as ei:
                    f.result(timeout=120)
                errs.append(ei.value)
            assert all(e.site == "decode_step" for e in errs)
            assert faultinject.fired("decode_step") == 1
        futs = [bat.submit(p, max_new_tokens=6) for p in prompts]
        assert [f.result(timeout=120) for f in futs] == solo
    assert eng.free_slots == 2


def test_decode_step_sleep_fault_stretches_and_still_runs():
    eng = make_engine("sleepy", slots=2)
    p = make_prompts(1)[0]
    ref = list(eng.generate(p, max_new_tokens=4))
    with faultinject.inject("decode_step:action=sleep:ms=30"):
        t0 = time.perf_counter()
        got = list(eng.generate(p, max_new_tokens=4))
        dt = time.perf_counter() - t0
        assert faultinject.fired("decode_step") == 3
    assert got == ref and dt >= 0.09
