"""The port's profiler facade (``mxnet_tpu_torch/profiler.py``, on
``torch.profiler``) on the CPU; modelled on ``tests/test_profiler.py``
(its ``nd.random.shuffle`` case has no counterpart: the port's
``nd.random`` draws without the op dispatch).

- ``set_state("run")`` / ``dump()`` write a Chrome trace into
  ``<filename minus .json>_trace/``, holding the ops that ran and the
  ``Domain`` tasks and trace spans mirrored as ``record_function``
  ranges;
- the aggregate op table counts the ``nd`` op dispatch, with pause /
  resume, the same rows as the JAX package's for the same ops;
- ``Domain`` / ``Task`` / ``Counter`` / ``Marker`` and the deprecated
  aliases;
- a profiler that fails to start raises and leaves the state stopped;
- ``MXNET_PROFILER_AUTOSTART`` starts it at import.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd, profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.telemetry import trace as ttrace
from torch_threads import one_torch_thread  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_profiler_state():
    yield
    if profiler.state() == "run":
        profiler.set_state("stop")
    profiler.dumps(reset=True)
    profiler.resume()


def _trace_names(path):
    with open(path) as f:
        tree = json.load(f)
    return {e.get("name") for e in tree["traceEvents"]}


def test_trace_dump_writes_files(tmp_path):
    profiler.set_config(filename=str(tmp_path / "profile.json"),
                        aggregate_stats=True)
    profiler.set_state("run")
    with tmx.cpu():
        x = nd.ones((32, 32))
        nd.dot(x, x).wait_to_read()
    profiler.dump(finished=True)
    assert profiler.state() == "stop"
    tdir = profiler.trace_dir()
    assert tdir == str(tmp_path / "profile_trace") and os.path.isdir(tdir)
    files = profiler.trace_files()
    assert len(files) == 1 and os.path.dirname(files[0]) == tdir
    names = _trace_names(files[0])
    assert any("mm" in (n or "") for n in names), sorted(
        n for n in names if n)[:40]


def test_tasks_and_trace_spans_mirror_into_the_trace(tmp_path,
                                                      monkeypatch):
    """While the profiler runs, a Domain task and a telemetry trace span
    enter ``record_function`` under ``<domain>::<name>``; outside a run
    they record into the aggregate table only."""
    monkeypatch.setenv("MXTPU_TRACE_DIR", str(tmp_path / "spans"))
    ttrace.reset()
    profiler.set_config(filename=str(tmp_path / "p.json"))
    profiler.set_state("run")
    with profiler.Domain("unit").new_task("work"):
        torch.ones(4) * 2
    with ttrace.span("request", cat="serving"):
        torch.ones(4) + 1
    profiler.set_state("stop")
    names = _trace_names(profiler.trace_files()[-1])
    assert {"unit::work", "serving::request"} <= names
    with profiler.Domain("unit").new_task("quiet"):
        pass
    stats = json.loads(profiler.dumps(format="json"))
    assert stats["unit::work"]["count"] == 1
    assert stats["unit::quiet"]["count"] == 1
    ttrace.reset()


def test_aggregate_table(tmp_path):
    profiler.set_config(filename=str(tmp_path / "p.json"),
                        aggregate_stats=True)
    profiler.set_state("run")
    with tmx.cpu():
        a = nd.ones((8, 8))
        for _ in range(3):
            a = a + 1.0
        b = nd.dot(a, a)
        (b * 2).wait_to_read()
    profiler.set_state("stop")
    table = profiler.dumps()
    assert "_plus_scalar" in table
    stats = json.loads(profiler.dumps(format="json"))
    assert stats["_plus_scalar"]["count"] == 3
    assert stats["_plus_scalar"]["total_ms"] >= 0
    assert stats["dot"]["count"] == 1


def test_aggregate_rows_match_the_jax_package(tmp_path):
    """The same ops through both packages' dispatch: the same table rows
    with the same counts."""
    counts = {}
    for pkg in (jmx, tmx):
        pkg.profiler.set_config(filename=str(tmp_path / "p.json"),
                                aggregate_stats=True)
        pkg.profiler.dumps(reset=True)
        pkg.profiler.set_state("run")
        ctx = tmx.cpu() if pkg is tmx else jmx.cpu()
        with ctx:
            a = pkg.nd.ones((4, 4))
            for _ in range(2):
                a = (a * 3.0).exp()
            pkg.nd.dot(a, a).wait_to_read()
        pkg.profiler.set_state("stop")
        stats = json.loads(pkg.profiler.dumps(format="json", reset=True))
        counts[pkg] = {n: s["count"] for n, s in stats.items()}
    assert counts[tmx] == counts[jmx]
    assert counts[tmx]["_mul_scalar"] == 2


def test_pause_resume(tmp_path):
    profiler.set_config(filename=str(tmp_path / "p.json"),
                        aggregate_stats=True)
    profiler.set_state("run")
    profiler.pause()
    with tmx.cpu():
        x = nd.ones((4, 4)) * 3
        x.wait_to_read()
        profiler.resume()
        y = nd.ones((4, 4)).exp()
        y.wait_to_read()
    profiler.set_state("stop")
    stats = json.loads(profiler.dumps(format="json"))
    assert "_mul_scalar" not in stats
    assert "exp" in stats


def test_domain_task_counter_marker():
    dom = profiler.Domain("mydomain")
    task = dom.new_task("work")
    with task:
        torch.ones(4, 4).sum()
    stats = json.loads(profiler.dumps(format="json"))
    assert "mydomain::work" in stats
    c = dom.new_counter("steps", 10)
    c += 5
    c.decrement(3)
    assert c.value == 12
    assert profiler.counters()["mydomain::steps"] == 12
    dom.new_marker("tick").mark()
    dom.new_frame("f").start().stop()
    profiler.Event("ev").start().stop()
    stats = json.loads(profiler.dumps(format="json"))
    assert stats["mydomain::tick::marks"]["count"] == 1
    assert "mydomain::f" in stats and "event::ev" in stats


def test_deprecated_aliases(tmp_path):
    profiler.profiler_set_config(mode="all",
                                 filename=str(tmp_path / "old.json"))
    assert profiler._config["profile_all"]
    profiler.profiler_set_state("run")
    assert profiler.state() == "run"
    profiler.dump_profile()
    assert profiler.state() == "stop"
    assert profiler.trace_files(str(tmp_path / "old_trace"))
    profiler.set_config(profile_all=False, profile_symbolic=False)


def test_failed_start_raises_and_stays_stopped(tmp_path, monkeypatch):
    """No fallback: a torch profiler that cannot start raises, and the
    facade does not claim to be running."""
    def broken_start(self):
        raise RuntimeError("profiler already active")

    monkeypatch.setattr(torch.profiler.profile, "start", broken_start)
    profiler.set_config(filename=str(tmp_path / "p.json"))
    with pytest.raises(MXNetError, match="failed to start"):
        profiler.set_state("run")
    assert profiler.state() == "stop"
    assert not profiler._annotating()


def test_unknown_config_key_and_state_raise():
    with pytest.raises(ValueError):
        profiler.set_config(bogus=True)
    with pytest.raises(ValueError):
        profiler.set_state("paused")


def test_autostart_starts_the_profiler_at_import(tmp_path):
    child = ("import mxnet_tpu_torch as tmx\n"
             "p = tmx.profiler\n"
             "print(p.state(), p._config['aggregate_stats'], "
             "p._config['profile_all'])\n"
             "p.set_state('stop')\n"
             "print(len(p.trace_files()))\n")
    env = dict(os.environ, MXNET_PROFILER_AUTOSTART="1",
               MXNET_PROFILER_MODE="all", PYTHONPATH=_ROOT)
    r = subprocess.run([sys.executable, "-c", child], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["run", "True", "True", "1"]
    assert os.path.isdir(tmp_path / "profile_trace")
