"""The port's telemetry layer (``mxnet_tpu_torch/telemetry/``) against the
JAX package's, on the CPU; modelled case for case on
``tests/test_telemetry.py`` where the case applies to the port.

- The unified report is a superset of every report view (``fault``,
  ``compile``, ``serving``, ``data``, ``memory``, ``sparse``,
  ``profiler``); reset semantics, atomic ``fault_report(reset=True)``.
- Profiler hardening: no ``inf``, a stable sort, counters that are
  registry gauges.
- StepTimeline: nested phases subtract, ``current()`` is pinned to its
  thread, a ``fit()`` attributes at least 90% of each step's wall time
  to named phases, records no cost gauges (the port has no cost
  analysis), and closes its timeline when training raises; the
  ``slow_step`` fault site stretches the step.
- Durable export: the event log of the same small ``fit`` has the same
  event kinds and fields in both packages; the port's log is read by
  the JAX package's ``read_events`` and summarised by
  ``tools/telemetry.py``; the exporter follows a repointed directory,
  recovers after a failed rotation (``telemetry_write``), skips and
  repairs a torn final line, and a writer killed mid-rotation leaves a
  log that tails cleanly.
- ``render_prometheus`` of one snapshot is the same text in both
  packages.
- Serving: per-predictor series, dropped with their predictor; one reset
  clears the registry histograms.

No test here bounds a wall-clock overhead: the telemetry's cost is
measured on the card (``chip_smoke.py``'s ``telemetry`` phase).
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.telemetry import export as jexp

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.telemetry import export as texp
from mxnet_tpu_torch.telemetry import registry as treg
from mxnet_tpu_torch.telemetry import trace as ttrace
from torch_threads import one_torch_thread  # noqa: F401

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
sys.path.insert(0, os.path.join(_ROOT, "tools"))

import telemetry as telemetry_cli  # noqa: E402  (tools/telemetry.py)


@pytest.fixture
def tdir(tmp_path):
    """MXTPU_TELEMETRY_DIR on a fresh directory, both packages' exporter
    singletons dropped on both sides."""
    d = str(tmp_path / "telem")
    texp.reset_exporter()
    jexp.reset_exporter()
    with tmx.config.override("MXTPU_TELEMETRY_DIR", d):
        yield d
    texp.reset_exporter()
    jexp.reset_exporter()


# ---------------------------------------------------------------------------
# the unified report
# ---------------------------------------------------------------------------
def test_report_is_superset_of_every_report_view():
    tmx.fault.count("ckpt.saves")
    tmx.profiler.Counter(tmx.profiler.Domain("ft"), "skipped_steps", 3)
    tree = telemetry.report()
    views = {
        "serving": tmx.serving_report(),
        "data": tmx.data_report(),
        "fault": tmx.fault_report(),
        "compile": tmx.compile_report(),
        "memory": tmx.memory_report(),
        "sparse": tmx.sparse.sparse_report(),
        "profiler": {"counters": tmx.profiler.counters()},
    }
    for name, rep in views.items():
        assert name in tree["subsystems"], name
        missing = set(rep) - set(tree["subsystems"][name])
        assert not missing, (name, missing)
    assert tree["metrics"]["fault::ckpt.saves"]["value"] >= 1
    assert tmx.fault_report() == telemetry.collect("fault")
    assert tmx.compile_report()["cache"] == \
        telemetry.collect("compile")["cache"]
    # the JAX package's subsystems the port has are all there
    jtree = jmx.telemetry.report()
    ported = {"serving", "data", "fault", "compile", "memory", "profiler"}
    assert ported <= set(jtree["subsystems"]) & set(tree["subsystems"])


def test_report_reset_clears_counters_keeps_gauges():
    telemetry.counter("tw::resets").inc(7)
    telemetry.gauge("tw::level").set(4.5)
    first = telemetry.report(reset=True)
    assert first["metrics"]["tw::resets"]["value"] == 7
    second = telemetry.report()
    assert second["metrics"]["tw::resets"]["value"] == 0
    assert second["metrics"]["tw::level"]["value"] == 4.5


def test_report_reset_metrics_layer_carries_collector_series():
    tmx.fault.count("twr.window_probe")
    tree = telemetry.report(reset=True)
    assert tree["metrics"]["fault::twr.window_probe"]["value"] == 1
    after = telemetry.report()
    assert after["metrics"].get("fault::twr.window_probe",
                                {"value": 0})["value"] == 0


def test_fault_report_reset_is_atomic():
    """A concurrent ``fault.count`` writer against ``fault_report(reset=
    True)`` readers: every increment lands in exactly one window."""
    total = 5000
    key = "injected.telemetry_test"
    tmx.fault_report(reset=True)

    def writer():
        for _ in range(total):
            tmx.fault.count(key)

    taken = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            rep = tmx.fault_report(reset=True)
            taken.append(rep["injected"].get("telemetry_test", 0))

    wt = threading.Thread(target=writer)
    rt = threading.Thread(target=reader)
    rt.start()
    wt.start()
    wt.join()
    stop.set()
    rt.join()
    final = tmx.fault_report(reset=True)
    assert sum(taken) + final["injected"].get("telemetry_test", 0) == total


# ---------------------------------------------------------------------------
# profiler hardening / one store
# ---------------------------------------------------------------------------
def test_profiler_dumps_no_inf_and_stable_sort():
    tmx.profiler.dumps(reset=True)
    treg.timer("prof::zz_empty_row")
    for name in ("bb_op", "aa_op", "cc_op"):
        treg.timer("prof::" + name).record(0.001)
    stats = json.loads(tmx.profiler.dumps(format="json"))
    assert "zz_empty_row" not in stats
    assert "inf" not in tmx.profiler.dumps().lower()
    snap = treg.snapshot(prefix="prof::zz_empty_row")
    assert snap["prof::zz_empty_row"]["min"] == 0.0
    rows = [n for n in stats if n.endswith("_op")]
    assert rows == sorted(rows)
    tmx.profiler.dumps(reset=True)
    assert json.loads(tmx.profiler.dumps(format="json")) == {}


def test_profiler_counters_are_registry_gauges():
    c = tmx.profiler.Counter(tmx.profiler.Domain("twx"), "depth", 2)
    assert telemetry.gauge("twx::depth").get() == 2
    telemetry.gauge("twx::depth").set(9)
    assert c.value == 9
    assert tmx.profiler.counters()["twx::depth"] == 9


def test_profiler_counter_facade_never_clobbers_shared_gauge():
    telemetry.gauge("twc::shared").set(7)
    c = tmx.profiler.Counter("twc", "shared")
    assert c.value == 7
    assert telemetry.gauge("twc::shared").get() == 7


def test_data_and_fault_reports_mirror_profiler_counters():
    tmx.data_report()
    tmx.fault_report()
    cs = tmx.profiler.counters()
    assert "data::wait_s" in cs and "data::starvation_fraction" in cs
    assert cs["data::wait_s"] == telemetry.gauge("data::wait_s").get()
    assert "ft::skipped_steps" in cs


# ---------------------------------------------------------------------------
# StepTimeline
# ---------------------------------------------------------------------------
def test_timeline_nested_phases_subtract():
    tl = telemetry.StepTimeline(name="unit")
    tl.step_start()
    with tl.phase("device_step"):
        time.sleep(0.02)
        with tl.phase("compile"):
            time.sleep(0.03)
    wall = tl.step_end()
    acc = tl._acc
    assert acc["compile"] >= 0.025
    assert acc["device_step"] < 0.03
    assert sum(acc.values()) <= wall + 1e-6


def test_timeline_current_is_thread_pinned():
    tl = telemetry.StepTimeline(name="twt").activate()
    try:
        assert telemetry.current() is tl
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            telemetry.current()))
        t.start()
        t.join()
        assert seen == [None]
    finally:
        tl.close()
    assert telemetry.current() is None


def test_time_between_phases_is_unattributed():
    """A phase starts when it is entered, as in the JAX package: host
    time spent between two phases is no phase's and shows as the step's
    ``unattributed`` time."""
    treg.snapshot(reset=True, prefix="step::")
    tl = telemetry.StepTimeline(name="twg")
    tl.step_start()
    with tl.phase("device_step"):
        pass
    time.sleep(0.02)
    with tl.phase("metric_ft_sync"):
        pass
    wall = tl.step_end()
    assert wall >= 0.019
    assert sum(tl._acc.values()) < 0.01
    snap = treg.snapshot(prefix="step::")
    assert snap["step::phase::unattributed_s"]["total"] >= 0.019
    assert snap["step::phase::metric_ft_sync_s"]["total"] < 0.01


def test_step_start_noop_while_open_keeps_prestep_wait():
    treg.snapshot(reset=True, prefix="step::")
    tl = telemetry.StepTimeline(name="tws")
    tl.step_start()
    with tl.phase("data_wait"):
        time.sleep(0.01)
    tl.step_start()
    wall = tl.step_end()
    assert wall >= 0.009
    snap = treg.snapshot(prefix="step::")
    assert snap["step::phase::data_wait_s"]["total"] >= 0.009


def test_peak_hbm_table_knows_the_card_and_guesses_nothing():
    from mxnet_tpu_torch.telemetry import timeline
    assert timeline.peak_hbm_bytes_s("NVIDIA H100 80GB HBM3") == 3350e9
    assert timeline.peak_hbm_bytes_s("cpu") == 0.0
    assert timeline.peak_hbm_bytes_s("an unknown card") == 0.0
    tl = telemetry.StepTimeline(name="twp")
    telemetry.set_step_cost(bytes_accessed=1e9)
    tl.step_start()
    tl.step_end()
    assert "step::roofline_fraction" not in treg.snapshot(
        prefix="step::roofline")
    treg.remove("step::bytes_accessed")


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    return pkg.sym.SoftmaxOutput(fc, name="softmax")


def _fit_mlp(pkg, num_epoch=2, batch=16, n=64, **fit_kw):
    rng = np.random.RandomState(0)
    X = rng.rand(n, 10).astype(np.float32)
    Y = np.random.RandomState(1).randint(0, 8, (n,)).astype(np.float32)
    it = pkg.io.NDArrayIter(X, Y, batch, label_name="softmax_label")
    ctx = "cpu" if pkg is tmx else jmx.cpu()
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    mod.fit(it, num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1}, **fit_kw)
    return mod


def test_fit_step_timeline_phase_sums_within_10pct(tdir):
    telemetry.reset(prefix="step::")
    treg.remove("step::bytes_accessed")
    treg.remove("step::flops")
    _fit_mlp(tmx)
    snap = treg.snapshot(prefix="step::")
    assert snap["step::steps"]["value"] == 2 * 4
    wall = snap["step::wall_s"]["total"]
    named = sum(m["total"] for k, m in snap.items()
                if k.startswith("step::phase::")
                and k != "step::phase::unattributed_s")
    assert wall > 0
    assert named >= 0.9 * wall, \
        f"phases attribute only {named / wall:.1%} of step wall time"
    assert named <= wall * 1.001 + 1e-6
    for name in ("data_wait", "h2d_stage", "compile", "device_step",
                 "metric_ft_sync"):
        assert snap[f"step::phase::{name}_s"]["count"] > 0, name
    # no cost analysis of the hand-written kernels: no cost gauges
    assert "step::bytes_accessed" not in snap
    assert "step::flops" not in snap
    events, torn = texp.read_events(tdir)
    assert torn == 0
    kinds = {e["kind"] for e in events}
    assert {"train_step", "epoch", "timeline_close"} <= kinds
    ts = [e for e in events if e["kind"] == "train_step"]
    assert ts and "phases" in ts[0] and "wall_s" in ts[0]
    assert ts[0]["bytes_accessed"] is None
    assert texp.snapshot_files(tdir)


def test_trace_gaps_are_the_unattributed_time(tdir, tmp_path,
                                             monkeypatch):
    """``profile_timeline.step_gaps`` reads a traced fit's steps: their
    gaps between top-level phases sum to each step's ``unattributed_s``
    in the event log, and the named share to its phases over wall."""
    import torch
    from mxnet_tpu_torch import profile_timeline as ptl
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    mod = tmx.mod.Module(_mlp(tmx), context="cpu")
    mod.bind(data_shapes=[("data", (16, 10))],
             label_shapes=[("softmax_label", (16,))])
    mod.init_params()
    mod.init_optimizer(optimizer="sgd")
    rng = np.random.RandomState(0)
    batches = [tmx.io.DataBatch(
        [torch.from_numpy(rng.rand(16, 10).astype(np.float32))],
        [torch.from_numpy(rng.randint(0, 8, (16,)).astype(np.float32))])
        for _ in range(2)]
    trace_dir = str(tmp_path / "trace")
    ptl._fit(mod, batches, 5, (tdir, trace_dir), True, True)
    steps = ptl.step_gaps(trace_dir, [])
    events = {e["step"]: e for e in texp.read_events(tdir)[0]
              if e["kind"] == "train_step"}
    assert sorted(s["step"] for s in steps) == sorted(events) == \
        [1, 2, 3, 4, 5]
    for s in steps:
        e = events[s["step"]]
        gaps_s = sum(g["us"] for g in s["gaps"]) / 1e6
        assert gaps_s == pytest.approx(e["unattributed_s"], abs=5e-6)
        assert s["named"] == pytest.approx(
            sum(e["phases"].values()) / e["wall_s"], abs=0.02)


def test_fit_closes_the_timeline_and_flushes_on_error(tdir):
    """A fit that raises mid-epoch still closes its timeline: the
    ``timeline_close`` event and the final snapshot land and no timeline
    stays current."""
    class Boom(Exception):
        pass

    def cb(param):
        if param.nbatch == 1:
            raise Boom()

    with pytest.raises(Boom):
        _fit_mlp(tmx, num_epoch=1, batch_end_callback=cb)
    assert telemetry.current() is None
    events, _ = texp.read_events(tdir)
    closes = [e for e in events if e["kind"] == "timeline_close"]
    assert closes and closes[-1]["steps"] == 1
    assert texp.snapshot_files(tdir)


def _schema(events):
    out = {}
    for e in events:
        out.setdefault(e["kind"], set()).update(e)
    return out


def test_event_kinds_and_fields_match_the_jax_package(tmp_path):
    """The same small ``fit`` (with a CheckpointManager) through both
    packages writes the same event kinds, each with the same fields, and
    the same number of each."""
    logs = {}
    for pkg in (jmx, tmx):
        d = str(tmp_path / pkg.__name__)
        texp.reset_exporter()
        jexp.reset_exporter()
        with tmx.config.override("MXTPU_TELEMETRY_DIR", d + "/tel"):
            _fit_mlp(pkg, checkpoint_manager=d + "/ck")
        logs[pkg] = jexp.read_events(d + "/tel")[0]
    texp.reset_exporter()
    jexp.reset_exporter()
    tj, tt = _schema(logs[jmx]), _schema(logs[tmx])
    assert set(tj) == set(tt) == {"train_step", "epoch", "checkpoint",
                                  "timeline_close"}
    for kind in tj:
        assert tj[kind] == tt[kind], kind
    count = {pkg: sorted((e["kind"], e.get("step"), e.get("epoch"))
                         for e in logs[pkg]) for pkg in logs}
    assert count[jmx] == count[tmx]
    ph = {pkg: sorted(next(e for e in logs[pkg]
                           if e["kind"] == "train_step")["phases"])
          for pkg in logs}
    assert ph[jmx] == ph[tmx]


def test_port_event_log_roundtrips_through_jax_reader_and_cli(tdir, capsys):
    telemetry.reset(prefix="step::")
    _fit_mlp(tmx, num_epoch=1)
    events, torn = jexp.read_events(tdir)
    assert torn == 0 and events == texp.read_events(tdir)[0]
    rc = telemetry_cli.main(["summary", "--dir", tdir, "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["events"] >= 2
    assert out["torn_lines"] == 0
    assert out["by_kind"]["train_step"] >= 1
    assert out["train"]["mean_wall_s"] > 0
    assert out["snapshot"]["headline"]["step::wall_s.count"] >= 4
    rc = telemetry_cli.main(["tail", "--dir", tdir, "-n", "5",
                             "--kind", "train_step", "--json"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert lines and all(
        json.loads(ln)["kind"] == "train_step" for ln in lines)


def test_slow_step_fault_site_stretches_the_step(tdir):
    """``slow_step:action=sleep:ms=N`` sleeps at the top of every fused
    step: each step's wall grows by at least N ms, and the timeline's
    ``train_step`` events show it."""
    telemetry.reset(prefix="step::")
    with tmx.faultinject.inject("slow_step:action=sleep:ms=60"):
        _fit_mlp(tmx, num_epoch=1)
    snap = treg.snapshot(prefix="step::")
    assert snap["step::wall_s"]["count"] == 4
    assert snap["step::wall_s"]["min"] >= 0.06
    assert tmx.faultinject.fired("slow_step") == 4
    ev = [e for e in texp.read_events(tdir)[0] if e["kind"] == "train_step"]
    assert ev and ev[0]["wall_s"] >= 0.06


# ---------------------------------------------------------------------------
# durable export
# ---------------------------------------------------------------------------
def test_exporter_follows_dir_repoint(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    texp.reset_exporter()
    with tmx.config.override("MXTPU_TELEMETRY_DIR", a):
        assert texp.emit_event("unit", n=1)
    with tmx.config.override("MXTPU_TELEMETRY_DIR", b):
        assert texp.emit_event("unit", n=2)
    assert [e["n"] for e in texp.read_events(a)[0]] == [1]
    assert [e["n"] for e in texp.read_events(b)[0]] == [2]
    texp.reset_exporter()


def test_timeline_close_releases_the_event_log(tdir):
    """A timeline's close leaves no event-log file open (turning export
    off afterwards leaks no handle); the next event reopens the same
    segment and appends."""
    tl = telemetry.StepTimeline(name="twr").activate()
    tl.step_start()
    tl.step_end()
    tl.close()
    assert texp._log is not None and texp._log._f is None
    assert texp.emit_event("unit", n=1)
    events, torn = texp.read_events(tdir)
    assert torn == 0 and len(texp.event_files(tdir)) == 1
    assert [e["kind"] for e in events][-2:] == ["timeline_close", "unit"]
    texp.release()
    assert texp._log._f is None


def test_exporter_recovers_after_failed_rotation(tdir):
    """A raise at a rotation (``telemetry_write:rotation=2``, the ENOSPC
    shape) drops that one event, counts it, and the next emit reopens
    the advanced segment: the stream stays contiguous."""
    from mxnet_tpu_torch import faultinject
    with tmx.config.override("MXTPU_TELEMETRY_ROTATE_BYTES", 80):
        texp.reset_exporter()
        pad = "x" * 60
        with faultinject.inject("telemetry_write:rotation=2"):
            assert texp.emit_event("unit", n=0, pad=pad)
            assert not texp.emit_event("unit", n=1, pad=pad)
        assert tmx.fault.counters().get("telemetry.write_errors", 0) >= 1
        assert texp.emit_event("unit", n=2, pad=pad)
        assert texp.emit_event("unit", n=3)
    events, torn = texp.read_events(tdir)
    assert torn == 0
    assert [e["n"] for e in events if e["kind"] == "unit"] == [0, 2, 3]
    assert len(texp.event_files(tdir)) >= 2
    texp.reset_exporter()


def test_torn_final_line_is_skipped_and_repaired(tdir):
    texp.emit_event("unit", n=1)
    texp.emit_event("unit", n=2)
    seg = texp.event_files(tdir)[-1]
    with open(seg, "a") as f:
        f.write('{"ts": 1.0, "kind": "torn", "pa')
    events, torn = texp.read_events(tdir)
    assert torn == 1
    assert [e["n"] for e in events] == [1, 2]
    texp.reset_exporter()
    texp.emit_event("unit", n=3)
    events, torn = texp.read_events(tdir)
    assert torn == 1
    assert [e.get("n") for e in events] == [1, 2, 3]
    # the JAX package's reader agrees on the repaired log
    assert jexp.read_events(tdir) == (events, torn)


@pytest.mark.chaos
def test_chaos_sigkill_mid_rotation_log_stays_tailable(tmp_path):
    d = str(tmp_path / "telem")
    child = (
        "from mxnet_tpu_torch.telemetry import export as texp\n"
        "for i in range(1000):\n"
        "    assert texp.emit_event('ping', n=i)\n"
        "print('UNREACHED')\n"
    )
    env = dict(os.environ, MXTPU_TELEMETRY_DIR=d,
               MXTPU_TELEMETRY_ROTATE_BYTES="600",
               MXTPU_FAULT_INJECT="telemetry_write:rotation=3:action=kill",
               PYTHONPATH=_ROOT)
    r = subprocess.run([sys.executable, "-c", child], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=_ROOT)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr)
    assert "UNREACHED" not in r.stdout
    events, torn = texp.read_events(d)
    assert torn == 0
    ns = [e["n"] for e in events if e["kind"] == "ping"]
    assert ns == list(range(len(ns))) and len(ns) >= 2
    assert len(texp.event_files(d)) >= 2
    env.pop("MXTPU_FAULT_INJECT")
    child2 = ("from mxnet_tpu_torch.telemetry import export as texp\n"
              "assert texp.emit_event('ping', n=-1)\n")
    r2 = subprocess.run([sys.executable, "-c", child2], env=env,
                        capture_output=True, text=True, timeout=300,
                        cwd=_ROOT)
    assert r2.returncode == 0, r2.stderr
    events2, torn2 = jexp.read_events(d)
    assert torn2 == 0
    assert len(events2) == len(events) + 1


# ---------------------------------------------------------------------------
# prometheus rendering
# ---------------------------------------------------------------------------
def test_prometheus_rendering():
    telemetry.counter("twp::hits").inc(3)
    telemetry.histogram("twp::lat").observe(1.5)
    text = telemetry.render_prometheus()
    assert "# TYPE mxtpu_twp__hits counter" in text
    assert "mxtpu_twp__hits 3" in text
    assert 'mxtpu_twp__lat{quantile="0.5"} 1.5' in text
    assert "mxtpu_twp__lat_count 1" in text


def test_prometheus_text_of_one_snapshot_matches_the_jax_package():
    """The same snapshot (the port's registry after a fit, serving
    histograms and gauges) renders to the same text in both packages."""
    telemetry.counter("twq::hits").inc(5)
    telemetry.gauge("twq::level").set(2.25)
    for v in (1.0, 4.0, 9.5):
        telemetry.histogram("twq::lat_ms").observe(v)
    telemetry.timer("twq::t").record(0.125)
    _fit_mlp(tmx, num_epoch=1)
    snap = treg.snapshot()
    text = texp.render_prometheus(snap)
    assert text == jexp.render_prometheus(snap)
    assert "mxtpu_step__wall_s_count" in text


# ---------------------------------------------------------------------------
# serving: per-predictor identity and cleanup
# ---------------------------------------------------------------------------
def _small_predictor(buckets=(2, 4)):
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(tmx.sym.Flatten(data), num_hidden=6,
                                name="fc")
    net = tmx.sym.SoftmaxOutput(fc, name="softmax")
    rng = np.random.RandomState(0)
    args = {"fc_weight": rng.randn(6, 128).astype(np.float32) * 0.1,
            "fc_bias": np.zeros(6, np.float32)}
    return tmx.serving.Predictor(net, args, {}, data_shapes={
        "data": (8, 4, 4)}, buckets=buckets, device="cpu")


def _batcher(pred):
    return tmx.serving.DynamicBatcher(pred, max_wait_us=100, name="tw")


def test_predictor_churn_does_not_leak_registry_series():
    import gc
    p = _small_predictor()
    pid = p.telemetry_id
    b = _batcher(p)
    x = np.random.RandomState(0).rand(2, 8, 4, 4).astype(np.float32)
    with b:
        b.predict(x)
    assert treg.snapshot(prefix=f"serving::{pid}::")
    del b, p
    gc.collect()
    assert not treg.snapshot(prefix=f"serving::{pid}::")


def test_serving_report_reset_clears_registry_histograms():
    p = _small_predictor()
    x = np.random.RandomState(0).rand(2, 8, 4, 4).astype(np.float32)
    with _batcher(p) as b:
        b.predict(x)
        prefix = f"serving::{p.telemetry_id}::"
        assert any(m["count"] > 0
                   for m in treg.snapshot(prefix=prefix).values()
                   if m["kind"] == "histogram")
        tmx.serving_report(reset=True)
        assert all(m["count"] == 0
                   for m in treg.snapshot(prefix=prefix).values()
                   if m["kind"] == "histogram")


def test_serving_report_tags_by_predictor_id():
    p1 = _small_predictor()
    p2 = _small_predictor()
    assert p1.telemetry_id != p2.telemetry_id
    x = np.random.RandomState(0).rand(2, 8, 4, 4).astype(np.float32)
    p1.predict(x)
    p2.predict(x)
    rep = tmx.serving_report()
    ids = [r["id"] for r in rep["predictors"]]
    assert p1.telemetry_id in ids and p2.telemetry_id in ids
    assert ids == sorted(ids)
    with _batcher(p1) as bat:
        bat.predict(x)
        rep = tmx.serving_report()
        mine = [b for b in rep["batchers"] if b["id"] == bat.telemetry_id]
        assert mine and mine[0]["predictor_id"] == p1.telemetry_id
        assert mine[0]["per_bucket"][2]["p50_ms"] is not None
    snap = treg.snapshot(prefix=f"serving::{p1.telemetry_id}::")
    assert any(k.endswith("latency_ms") and m["count"] > 0
               for k, m in snap.items())
    snap2 = treg.snapshot(prefix=f"serving::{p2.telemetry_id}::")
    assert all(m["count"] == 0 for k, m in snap2.items()
               if k.endswith("latency_ms"))
