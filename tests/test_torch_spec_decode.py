"""Speculative and disaggregated decode in the port
(``mxnet_tpu_torch/serving/decode/spec.py`` and the batcher roles), on
the CPU: the behaviour pins of ``tests/test_spec_decode.py`` that gate no
timing.

- Speculative continuous-batched streams are bit-identical to solo
  greedy decode under a join/leave drill, lanes pinned to plain
  semantics riding the same verify launches; and equal to the JAX
  package's ``SpecDecodePredictor`` streams.
- A random draft costs efficiency, never correctness.
- Programs: per-bucket prefill, one decode and one verify (width k+1)
  on the target, per-bucket prefill and one decode on the draft, all at
  warmup, none while serving.
- The ``spec_verify`` site (a divergence storm) degrades to plain decode
  without moving a token; the ``kv_handoff`` site (a lost lane) makes
  the decode side re-prefill with no stream dropped.
- Disaggregated prefill -> decode streams equal the unified ones (the
  stream half of ``test_disagg_ttft_p99_beats_unified_under_slow_decode``;
  its TTFT half is a timing race on a shared CPU).
"""
import time

import numpy as np
import pytest

from mxnet_tpu.serving import decode as jdecode

from mxnet_tpu_torch import faultinject
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import loadgen
from mxnet_tpu_torch.serving.decode import (
    DecodeBatcher, DecodePredictor, SpecDecodePredictor,
    TransformerLMSpec, init_params, make_draft_spec)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.serving


def small_spec(name, max_seq=64, vocab=64, dim=32, heads=2, layers=2):
    return TransformerLMSpec(vocab_size=vocab, num_embed=dim,
                             num_heads=heads, num_layers=layers,
                             max_seq=max_seq, name=name)


def make_plain(name, slots=4, seq_buckets=(8, 16, 32)):
    spec = small_spec(name)
    return DecodePredictor(spec, init_params(spec, seed=0), slots=slots,
                           seq_buckets=seq_buckets, device="cpu")


def make_spec_engine(name, slots=4, seq_buckets=(8, 16, 32), k=4, **kw):
    """Target (seed 0, as :func:`make_plain`) and a random shrink-2 draft
    (seed 1): these tests pin correctness and bookkeeping, not
    amortization."""
    spec = small_spec(name)
    dspec = make_draft_spec(spec, num_layers=1, shrink=2)
    return SpecDecodePredictor(spec, init_params(spec, seed=0), dspec,
                               init_params(dspec, seed=1), k=k,
                               slots=slots, seq_buckets=seq_buckets,
                               device="cpu", **kw)


def make_prompts(n, vocab=64, seed=7, lens=(5, 12, 3, 20, 7, 9, 15, 4)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=lens[i % len(lens)]
                        ).astype(np.int32) for i in range(n)]


def solo_streams(prompts, budgets, name="specref"):
    eng = make_plain(name)
    return [list(eng.generate(p, max_new_tokens=m))
            for p, m in zip(prompts, budgets)]


def engine_rows(report, name):
    pre = f"decode:{name}:"
    return [p for p in report["programs"]
            if p["kind"] == "decode" and p["name"].startswith(pre)]


def test_spec_batched_bit_identical_mixed_join_leave():
    prompts = make_prompts(8)
    budgets = [6, 9, 4, 12, 7, 5, 10, 8]
    solo = solo_streams(prompts, budgets, name="specbitref")
    eng = make_spec_engine("specbit", slots=3)
    with DecodeBatcher(eng, max_wait_us=500, name="specbit") as bat:
        futs = []
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            futs.append(bat.submit(p, max_new_tokens=m,
                                   speculative=(i % 3 != 2)))
            time.sleep(0.003 * (i % 3))
        streams = [f.result(timeout=120) for f in futs]
    assert streams == solo
    rep = bat.report()
    assert rep["served_generations"] == 8
    assert rep["streamed_tokens"] == sum(budgets)
    assert rep["speculative"] is True
    assert eng.report()["spec"]["rounds"] > 0


def test_spec_streams_equal_the_jax_package():
    prompts = make_prompts(4)
    budgets = [10, 7, 12, 9]
    jspec = jdecode.TransformerLMSpec(vocab_size=64, num_embed=32,
                                      num_heads=2, num_layers=2,
                                      max_seq=64, name="jspec")
    jd = jdecode.make_draft_spec(jspec, num_layers=1, shrink=2)
    j = jdecode.SpecDecodePredictor(
        jspec, jdecode.init_params(jspec, seed=0), jd,
        jdecode.init_params(jd, seed=1), k=3, slots=2, seq_buckets=(32,))
    eng = make_spec_engine("specjax", slots=2, k=3, seq_buckets=(32,))

    def rounds(e, p, m):
        """One lane through ``spec_step`` rounds: the stream and the
        tokens each round committed."""
        slot = e.alloc_slot()
        out, per_round = [int(e.prefill(slot, p))], []
        while len(out) < m:
            got = [int(t) for t in
                   e.spec_step({slot: (out[-1], m - len(out), True)})[slot]]
            per_round.append(len(got))
            out += got
        e.release(slot)
        return out[:m], per_round

    for p, m in zip(prompts, budgets):
        want = rounds(j, p, m)
        assert rounds(eng, p, m) == want
        assert want[0] == [int(t) for t in j.generate(p, max_new_tokens=m)]


def test_degenerate_draft_costs_efficiency_never_correctness():
    prompts = make_prompts(6)
    budgets = [8, 5, 10, 7, 6, 9]
    solo = solo_streams(prompts, budgets, name="specdegref")
    eng = make_spec_engine("specdegen", slots=4, window=8, probe_steps=4)
    with DecodeBatcher(eng, max_wait_us=0, name="degen") as bat:
        futs = [bat.submit(p, max_new_tokens=m)
                for p, m in zip(prompts, budgets)]
        streams = [f.result(timeout=120) for f in futs]
    assert streams == solo
    s = eng.report()["spec"]
    assert s["rounds"] >= 1
    assert s["accepted_per_step"] is not None \
        and 1.0 <= s["accepted_per_step"] <= eng.spec_k + 1
    assert s["acceptance_rate"] is not None \
        and 0.0 <= s["acceptance_rate"] <= 1.0
    assert eng.spec_bytes_per_accepted_token() is not None


def test_verify_program_in_warmup_and_zero_serving_retraces():
    # unique dims: registry rows are keyed by program key and named by
    # the first engine to acquire them
    spec = small_spec("specpin", max_seq=48, vocab=66, dim=40)
    dspec = make_draft_spec(spec, num_layers=1, shrink=2)
    eng = SpecDecodePredictor(spec, init_params(spec, seed=0), dspec,
                              init_params(dspec, seed=1), slots=2,
                              seq_buckets=(8, 16), device="cpu")
    eng.warmup()
    from mxnet_tpu_torch import compile_report
    rows = engine_rows(compile_report(), eng.name)
    assert len(rows) == len(eng.buckets) + 2
    assert any(f":verify:k{eng.spec_k + 1}" in p["name"] for p in rows)
    assert len(engine_rows(compile_report(), eng.draft.name)) == \
        len(eng.buckets) + 1
    t_before, d_before = eng.retraces, eng.draft.retraces
    prompts = make_prompts(6, lens=(5, 12, 3, 9, 7, 15))
    with DecodeBatcher(eng, max_wait_us=200, name="specpin") as bat:
        futs = [bat.submit(p, max_new_tokens=6) for p in prompts]
        for f in futs:
            f.result(timeout=120)
    assert eng.retraces == t_before and eng.draft.retraces == d_before
    assert len(engine_rows(compile_report(), eng.name)) == \
        len(eng.buckets) + 2


def test_draft_must_fit_the_target():
    spec = small_spec("draftfit")
    with pytest.raises(MXNetError):
        make_draft_spec(spec, shrink=3)
    bad = small_spec("draftbad", vocab=32)
    with pytest.raises(MXNetError):
        SpecDecodePredictor(spec, init_params(spec), bad,
                            init_params(bad), device="cpu")


@pytest.mark.chaos
def test_spec_verify_storm_degrades_and_stays_exact():
    prompts = make_prompts(6)
    budgets = [8, 6, 10, 7, 9, 5]
    solo = solo_streams(prompts, budgets, name="specstormref")
    eng = make_spec_engine("specstorm", slots=3, window=8,
                           probe_steps=1000)
    with DecodeBatcher(eng, max_wait_us=0, name="storm") as bat:
        with faultinject.inject(spec_verify={}):
            futs = [bat.submit(p, max_new_tokens=m)
                    for p, m in zip(prompts, budgets)]
            streams = [f.result(timeout=120) for f in futs]
            assert faultinject.fired("spec_verify") >= 1
    assert streams == solo
    s = eng.report()["spec"]
    assert s["degrade_events"] >= 1
    assert s["acceptance_rate"] is not None \
        and s["acceptance_rate"] < eng.disable_below


def _disagg(pre_eng, dec_eng, prompts, budgets, lose=False):
    dec = DecodeBatcher(dec_eng, max_wait_us=0, name="dis-dec",
                        role="decode")
    pre = DecodeBatcher(pre_eng, max_wait_us=0, name="dis-pre",
                        role="prefill")
    dec.start()
    lanes = []

    def sink(req, last, produced, lane, t0):
        lanes.append(lane)
        dec.adopt(req, last, produced, lane, t0)
        return True

    pre.set_handoff(sink)
    pre.start()
    try:
        if lose:
            with faultinject.inject(kv_handoff={}):
                futs = [pre.submit(p, max_new_tokens=m)
                        for p, m in zip(prompts, budgets)]
                streams = [f.result(timeout=120) for f in futs]
                assert faultinject.fired("kv_handoff") >= len(prompts)
        else:
            futs = [pre.submit(p, max_new_tokens=m)
                    for p, m in zip(prompts, budgets)]
            streams = [f.result(timeout=120) for f in futs]
    finally:
        pre.stop()
        dec.stop()
    return streams, pre.report(), dec.report(), lanes


@pytest.mark.chaos
def test_kv_handoff_fault_reprefills_zero_dropped():
    prompts = make_prompts(6)
    budgets = [7, 5, 9, 6, 8, 4]
    solo = solo_streams(prompts, budgets, name="spechandref")
    streams, rp, rd, lanes = _disagg(make_plain("spechandpre", slots=3),
                                     make_plain("spechanddec", slots=4),
                                     prompts, budgets, lose=True)
    assert streams == solo
    assert all(lane is None for lane in lanes)
    assert rp["handoffs"] == len(prompts)
    assert rd["adopted"] == len(prompts)
    assert rp["shed_requests"] == 0
    assert rd["cancelled"] == 0


def test_disagg_streams_equal_unified():
    mixed = loadgen.mixed_prompts({4: 3, 8: 2, 16: 1}, vocab_size=64, n=8,
                                  seed=3)
    budgets = [6] * len(mixed)
    uni_eng = make_plain("specuni", slots=3, seq_buckets=(8, 16))
    with DecodeBatcher(uni_eng, max_wait_us=0, name="specuni") as bat:
        unified = [f.result(timeout=120) for f in
                   [bat.submit(p, max_new_tokens=6) for p in mixed]]
        run = loadgen.token_closed_loop(bat, mixed, 4, 2, max_new_tokens=6)
    assert run["gave_up"] == 0 and run["tokens"] == 48
    assert sum(b["streams"] for b in run["by_length"].values()) == 8
    assert set(run["by_length"]) == {4, 8, 16}
    streams, rp, rd, lanes = _disagg(
        make_plain("specdispre", slots=3, seq_buckets=(8, 16)),
        make_plain("specdisdec", slots=3, seq_buckets=(8, 16)),
        mixed, budgets)
    assert streams == unified
    assert rp["handoffs"] == rd["adopted"] == len(mixed)
    assert all(lane is not None and lane["bytes"] > 0 for lane in lanes)
    assert rd["handoff_p50_ms"] is not None
    assert loadgen.client_report()["gave_up"] == 0
