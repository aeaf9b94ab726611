"""The port's trace spans and per-program memory rows against the JAX
package's, on the CPU; modelled on ``tests/test_trace_memory.py``.

- Tracing (``telemetry/trace.py``): a ``fit()`` exports Chrome
  trace-event JSON under ``MXTPU_TRACE_DIR`` whose spans form the pinned
  tree (``fit:<symbol>`` -> ``step`` -> phases, the data pipeline's
  stage spans on the run's trace), and the JAX package's ``fit`` of the
  same model gives the same span names, categories and nesting; the file
  round-trips through ``tools/telemetry.py trace`` and the JAX package's
  ``read_trace``; the ring stays bounded; with tracing off nothing is
  recorded. Serving: request -> batch -> bucket across three threads;
  the shed and deadline events carry the request's trace id. Decode:
  ``decode:prefill`` / ``decode:step`` spans, ``serving_generation``
  events, the ``ttft_ms`` histogram and the KV-cache's ``decode_state``
  row.
- Memory (``telemetry/memory.py``): a captured program's row is derived
  from the allocator readings around its capture (checked here on a
  stand-in, since a CUDA graph is captured only on the card); nothing
  is captured on the CPU, so ``analyze`` gives ``{}``, ``step_memory``
  and ``program_memory`` give ``{}`` and no row is recorded; the fused
  step's ``step_cost`` is ``{}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.telemetry import export as jexp
from mxnet_tpu.telemetry import trace as jtrace

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.telemetry import export as texp
from mxnet_tpu_torch.telemetry import memory as tmem
from mxnet_tpu_torch.telemetry import registry as treg
from mxnet_tpu_torch.telemetry import trace
from torch_decode_helpers import make_engine, make_prompts
from torch_threads import one_torch_thread  # noqa: F401

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")

_PH_REQUIRED = {
    "X": ("name", "cat", "ph", "ts", "dur", "pid", "tid"),
    "M": ("name", "ph", "pid"),
}
FEAT = (8, 4, 4)


@pytest.fixture(autouse=True)
def _clean_trace():
    trace.reset()
    jtrace.reset()
    yield
    trace.reset()
    jtrace.reset()


def _validate_chrome_trace(path):
    with open(path) as f:
        tree = json.load(f)
    events = tree["traceEvents"]
    assert isinstance(events, list) and events
    for e in events:
        assert e.get("ph") in _PH_REQUIRED, e
        for field in _PH_REQUIRED[e["ph"]]:
            assert field in e, (field, e)
    spans = [e for e in events if e["ph"] == "X"]
    assert spans
    last = -1.0
    for e in spans:
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0, e
        assert e["dur"] >= 0, e
        assert e["ts"] >= last
        last = e["ts"]
        assert "trace_id" in e["args"], e
    return spans


def _fit(pkg):
    np.random.seed(0)
    x = np.random.rand(160, 128).astype(np.float32)
    y = (x.sum(1) * 2).astype(np.int32).astype(np.float32) % 10
    it = pkg.io.NDArrayIter(x, y, batch_size=32)
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=64,
                                 name="fc1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=10, name="fc2")
    net = pkg.sym.SoftmaxOutput(net, name="softmax")
    ctx = "cpu" if pkg is tmx else jmx.cpu()
    mod = pkg.mod.Module(context=ctx, symbol=net, fused=True)
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=pkg.init.Xavier())
    return mod


def _fit_traced(pkg, trace_dir):
    _fit(pkg)
    mod_trace = trace if pkg is tmx else jtrace
    files = mod_trace.trace_files(trace_dir)
    assert files, f"fit exported no trace file under {trace_dir}"
    return _validate_chrome_trace(files[-1]), files[-1]


def test_fit_trace_schema_and_step_nesting(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_TRACE_DIR", str(tmp_path))
    spans, _path = _fit_traced(tmx, str(tmp_path))
    roots = [e for e in spans if e["cat"] == "train"]
    assert len(roots) == 1 and roots[0]["name"] == "fit:softmax"
    root_id = roots[0]["args"]["span_id"]
    trace_id = roots[0]["args"]["trace_id"]
    steps = [e for e in spans if e["cat"] == "step" and e["name"] == "step"]
    assert len(steps) == 10
    step_ids = set()
    for e in steps:
        assert e["args"]["parent_id"] == root_id
        assert e["args"]["trace_id"] == trace_id
        step_ids.add(e["args"]["span_id"])
    phases = [e for e in spans if e["cat"] == "step" and e["name"] != "step"]
    assert {"data_wait", "h2d_stage", "compile", "device_step",
            "metric_ft_sync"} <= {e["name"] for e in phases}
    phase_ids = {e["args"]["span_id"] for e in phases
                 if "span_id" in e["args"]}
    for e in phases:
        assert e["args"]["trace_id"] == trace_id
        assert e["args"]["parent_id"] in step_ids | phase_ids | {root_id}
    by_id = {e["args"]["span_id"]: e for e in spans
             if "span_id" in e["args"]}
    nested = 0
    for e in phases:
        p = by_id.get(e["args"]["parent_id"])
        if p is None or p["name"] != "step":
            continue
        assert p["ts"] - 5 <= e["ts"]
        assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 5
        nested += 1
    assert nested > 0
    data = [e for e in spans if e["cat"] == "data"]
    assert {e["name"] for e in data} >= {"data:source", "data:decode",
                                         "data:stage"}
    for e in data:
        assert e["args"]["trace_id"] == trace_id
        assert e["args"]["parent_id"] == root_id


def _tree_shape(spans):
    """``{(cat, name, parent name, parent cat): count}`` of a trace."""
    by_id = {e["args"]["span_id"]: e for e in spans
             if "span_id" in e["args"]}
    out = {}
    for e in spans:
        p = by_id.get(e["args"].get("parent_id"))
        key = (e["cat"], e["name"], p["name"] if p else None,
               p["cat"] if p else None)
        out[key] = out.get(key, 0) + 1
    return out


def test_fit_trace_tree_matches_the_jax_package(tmp_path, monkeypatch):
    """The same fused ``fit`` through both packages: the same span names
    and categories, each under a parent of the same name, as many of
    each, and the same ``args`` keys per span name."""
    shapes, keys = {}, {}
    for pkg in (jmx, tmx):
        d = str(tmp_path / pkg.__name__)
        monkeypatch.setenv("MXTPU_TRACE_DIR", d)
        spans, _ = _fit_traced(pkg, d)
        shapes[pkg] = _tree_shape(spans)
        keys[pkg] = {}
        for e in spans:
            keys[pkg].setdefault(e["name"], set()).update(e["args"])
    assert shapes[tmx] == shapes[jmx]
    assert keys[tmx] == keys[jmx]


def test_trace_cli_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_TRACE_DIR", str(tmp_path))
    with trace.span("outer", cat="t"):
        with trace.span("inner", cat="t"):
            pass
    path = trace.export_trace()
    assert path and os.path.exists(path)
    r = subprocess.run(
        [sys.executable, os.path.join(_TOOLS, "telemetry.py"),
         "trace", path, "--json"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert out["spans"] == 2
    assert out["by_cat"]["t"]["spans"] == 2
    events = jtrace.read_trace(path)
    assert events == trace.read_trace(path)
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    assert spans["inner"]["args"]["parent_id"] == \
        spans["outer"]["args"]["span_id"]
    assert spans["inner"]["args"]["trace_id"] == \
        spans["outer"]["args"]["trace_id"]


def test_ring_stays_bounded_and_counts_drops(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("MXTPU_TRACE_RING", "64")
    trace.reset()
    t0 = time.perf_counter()
    for i in range(200):
        trace.record_span(f"s{i}", "bench", t0, 1e-6)
    live = trace.spans()
    assert len(live) == 64
    assert live[-1]["name"] == "s199"
    assert trace.dropped() == 136
    path = trace.export_trace()
    with open(path) as f:
        tree = json.load(f)
    assert tree["otherData"]["dropped_spans"] == 136


def test_disabled_tracing_records_nothing(monkeypatch):
    monkeypatch.delenv("MXTPU_TRACE_DIR", raising=False)
    assert not trace.enabled()
    with trace.span("x", cat="t"):
        assert trace.current() is None
    assert trace.export_trace() is None
    _fit(tmx)                       # a whole fit with tracing off
    assert trace.spans() == [] and trace.dropped() == 0


def _predictor(buckets=(2, 4)):
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(tmx.sym.Flatten(data), num_hidden=6,
                                name="fc")
    net = tmx.sym.SoftmaxOutput(fc, name="softmax")
    rng = np.random.RandomState(0)
    args = {"fc_weight": rng.randn(6, 128).astype(np.float32) * 0.1,
            "fc_bias": np.zeros(6, np.float32)}
    return serving.Predictor(net, args, {}, data_shapes={"data": FEAT},
                             buckets=buckets, device="cpu")


def test_serving_trace_request_batch_bucket_nesting(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_TRACE_DIR", str(tmp_path))
    pred = _predictor()
    b = serving.DynamicBatcher(pred, max_wait_us=3000, max_queue=10_000,
                               name="traced")
    b.start()
    futs = []
    try:
        for _ in range(6):
            futs.append(b.submit(np.random.rand(2, *FEAT)
                                 .astype(np.float32)))
        for f in futs:
            f.result(timeout=60)
        assert all(f.trace_id for f in futs)
    finally:
        b.stop()
    files = trace.trace_files(str(tmp_path))
    assert files, "batcher stop exported no trace"
    spans = _validate_chrome_trace(files[-1])
    requests = [e for e in spans if e["name"] == "serving:request"
                and "error" not in e["args"]]
    batches = [e for e in spans if e["name"] == "serving:batch"]
    buckets = [e for e in spans if e["name"].startswith("serving:bucket")]
    assert len(requests) == 6 and batches and buckets
    batch_ids = {e["args"]["span_id"] for e in batches}
    member_ids = set()
    for e in batches:
        member_ids.update(e["args"]["trace_ids"])
    assert {f.trace_id for f in futs} <= member_ids
    nested = [e for e in buckets if "parent_id" in e["args"]]
    assert nested
    by_id = {e["args"]["span_id"]: e for e in spans
             if "span_id" in e["args"]}
    for e in nested:
        assert e["args"]["parent_id"] in batch_ids, e
        p = by_id[e["args"]["parent_id"]]
        assert p["ts"] - 5 <= e["ts"]
        assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 5
    for e in requests:
        assert e["args"]["batch_span"] in batch_ids
    # the warmup buckets ran outside any batch: roots
    assert any("parent_id" not in e["args"] for e in buckets)


def test_shed_and_deadline_events_carry_trace_id(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", str(tmp_path / "tel"))
    texp.reset_exporter()
    pred = _predictor()
    b = serving.DynamicBatcher(pred, max_wait_us=200_000, max_queue=4,
                               name="shedtrace")
    b.start()
    try:
        held = [b.submit(np.zeros((2,) + FEAT, np.float32))
                for _ in range(2)]
        with pytest.raises(serving.Overloaded):
            b.submit(np.zeros((2,) + FEAT, np.float32))
        for f in held:
            f.result(timeout=60)
    finally:
        b.stop()
    b2 = serving.DynamicBatcher(pred, max_wait_us=300_000,
                                max_queue=10_000, name="dltrace")
    b2.start()
    try:
        doomed = b2.submit(np.zeros((1,) + FEAT, np.float32),
                           deadline_ms=0)
        time.sleep(0.05)
        ok = b2.submit(np.zeros((1,) + FEAT, np.float32))
        with pytest.raises(serving.DeadlineExceeded):
            doomed.result(timeout=60)
        ok.result(timeout=60)
    finally:
        b2.stop()
    events, _torn = jexp.read_events(str(tmp_path / "tel"))
    texp.reset_exporter()
    shed = [e for e in events if e.get("kind") == "serving_overloaded"]
    dl = [e for e in events if e.get("kind") == "serving_deadline"]
    assert shed and shed[0]["trace_id"] and shed[0]["rows"] == 2
    assert dl and dl[0]["trace_id"] == doomed.trace_id
    batch_evts = [e for e in events if e.get("kind") == "serving_batch"]
    assert batch_evts and all(e.get("trace_ids") for e in batch_evts)
    assert set(batch_evts[0]) == {"ts", "kind", "batcher", "predictor",
                                  "bucket", "rows", "requests",
                                  "trace_ids", "max_latency_ms"}


def test_decode_spans_events_and_kv_cache_row(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_TRACE_DIR", str(tmp_path / "tr"))
    monkeypatch.setenv("MXTPU_TELEMETRY_DIR", str(tmp_path / "tel"))
    texp.reset_exporter()
    eng = make_engine("teldec", slots=2)
    rows = [r for r in tmx.memory_report()["programs"]
            if r["kind"] == "decode_state"
            and r["name"] == f"decode:{eng.telemetry_id}:kv_cache"]
    assert rows and rows[0]["peak_bytes"] == eng.kv_cache_bytes() > 0
    prompts = make_prompts(3)
    with serving.decode.DecodeBatcher(eng, max_wait_us=0,
                                      name="teldec") as bat:
        futs = [bat.submit(p, max_new_tokens=4) for p in prompts]
        outs = [f.result(timeout=120) for f in futs]
    assert all(len(o) == 4 for o in outs)
    events, torn = jexp.read_events(str(tmp_path / "tel"))
    texp.reset_exporter()
    gens = [e for e in events if e["kind"] == "serving_generation"]
    assert sorted(e["trace_id"] for e in gens) == \
        sorted(f.trace_id for f in futs)
    assert all(e["tokens"] == 4 for e in gens)
    spans = _validate_chrome_trace(trace.trace_files(
        str(tmp_path / "tr"))[-1])
    names = {e["name"] for e in spans}
    assert {"decode:prefill", "decode:step", "serving:request"} <= names
    pre = {e["args"]["trace_id"] for e in spans
           if e["name"] == "decode:prefill"}
    assert pre == {f.trace_id for f in futs}
    pid = eng.telemetry_id
    snap = treg.snapshot(prefix=f"serving::{pid}::")
    assert snap[f"serving::{pid}::ttft_ms"]["count"] == 3
    assert snap[f"serving::{pid}::generations"]["value"] == 3
    assert snap[f"serving::{pid}::tokens"]["value"] >= 12
    rep = tmx.serving_report()
    assert any(d["id"] == pid for d in rep["decoders"])


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------
class _Captured:
    """A stand-in for a captured ``CapturedProgram``: the allocator
    readings around its capture, its static inputs, outputs and the
    tensors it reads in place."""

    captured = True

    def __init__(self):
        self.pool_before = 2 * 1024 * 1024
        self.pool_after = 8 * 1024 * 1024
        self.static = {"data": torch.zeros(16, 8),
                       "label": torch.zeros(16)}
        flat = torch.zeros(1000)
        self.arguments = (flat, flat[:10], flat[10:], torch.zeros(3))
        self.outputs = (torch.zeros(()), [torch.zeros(16, 10)])


def test_memory_row_of_a_captured_program():
    row = tmem.analyze(_Captured())
    arg = 16 * 8 * 4 + 16 * 4 + 1000 * 4 + 3 * 4   # views count once
    out = 4 + 16 * 10 * 4
    pool = 8 * 1024 * 1024
    assert row == {"argument_bytes": arg, "output_bytes": out,
                   "temp_bytes": pool - out, "pool_bytes": pool,
                   "pool_gained_bytes": 6 * 1024 * 1024,
                   "peak_bytes": arg + pool}


def test_memory_record_gauges_and_reset():
    tmem.reset()
    stats = tmem.record("unit_a", "fused_step", "d" * 40, _Captured())
    tmem.record("unit_b", "predictor", "e" * 40,
                {"argument_bytes": 5, "peak_bytes": 7})
    rep = tmx.memory_report()
    assert [r["name"] for r in rep["programs"]] == ["unit_a", "unit_b"]
    assert rep["process"]["peak_bytes"] == stats["peak_bytes"]
    snap = treg.snapshot(prefix="mem::")
    assert snap["mem::process_peak_bytes"]["value"] == stats["peak_bytes"]
    assert snap["mem::programs"]["value"] == 2
    assert snap["mem::unit_b::peak_bytes"]["value"] == 7
    tmem.reset()
    assert tmx.memory_report()["programs"] == []
    assert not treg.snapshot(prefix="mem::unit")


def test_nothing_is_captured_or_recorded_on_the_cpu():
    """On the CPU no program is captured: ``analyze`` gives ``{}`` as
    the JAX package's does without ``memory_analysis``, the fused step's
    ``step_memory`` and a bucket's ``program_memory`` answer empty, no row is recorded, and
    ``step_cost`` is ``{}`` with no cost gauge set."""
    tmem.reset()
    mod = _fit(tmx)
    fused = mod._fused
    x = torch.zeros(32, 128)
    feed = {"data": x, "softmax_label": torch.zeros(32)}
    prog = fused._program_of(feed)
    assert prog is not None and not prog.captured
    assert tmem.analyze(prog) == {}
    assert fused.step_memory(feed) == {}
    assert fused.step_cost(feed) == {}
    pred = _predictor()
    pred.warmup()
    assert pred.program_memory(2) == {} and pred.program_memory() == {}
    assert tmx.memory_report()["programs"] == []
    assert "step::bytes_accessed" not in treg.snapshot(prefix="step::")
