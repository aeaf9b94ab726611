"""Input-pipeline observability: ``data_report()`` (counterpart of
``mxnet_tpu/data/report.py``).

Every live :class:`~mxnet_tpu_torch.data.DataPipeline` registers here
(weak references); the report aggregates per-stage queue depths, busy
seconds, the decode rate and the headline: the consumer's wait time and
starvation fraction, how long and how often ``next()`` blocked because
no staged batch was ready. A starving consumer means the job is
input-bound (more workers or deeper queues, ``MXTPU_DATA_*``); near-zero
wait means the step is the bottleneck. Reading it syncs nothing.

The JAX package also mirrors the two headline figures into profiler
counters (``_mirror_prof``); that waits for ``profiler.py`` (ROADMAP.md
queue A, item 9).
"""
from __future__ import annotations

import threading
import weakref

from ..telemetry import registry as _treg

__all__ = ["data_report", "register_pipeline"]

_lock = threading.Lock()
_pipelines = []     # weakrefs to live DataPipeline instances


def register_pipeline(pipe):
    with _lock:
        _pipelines[:] = [wr for wr in _pipelines if wr() is not None]
        _pipelines.append(weakref.ref(pipe))


def _live():
    with _lock:
        return [p for p in (wr() for wr in _pipelines) if p is not None]


def _collect(reset=False):
    """Input-pipeline state over every live pipeline:

    - ``wait_s`` / ``waits`` / ``starvation_fraction``: total seconds,
      count and fraction of ``next()`` calls that blocked on the
      pipeline (the input-bound signal),
    - ``decode_items_s``: items transformed per worker-busy second,
    - ``pipelines``: per pipeline, its queue depths, per-stage busy
      seconds, worker count and bounds.

    ``reset=True`` zeroes the counters (cursors are untouched)."""
    per = {}
    tot_wait = tot_waits = tot_calls = 0.0
    tot_items = tot_busy = 0.0
    for p in _live():
        s = p.stats(reset=reset)
        name = s.pop("name")
        if name in per:  # two pipelines with one name: keep both
            name = f"{name}#{len(per)}"
        per[name] = s
        tot_wait += s["wait_s"]
        tot_waits += s["waits"]
        tot_calls += s["next_calls"]
        tot_items += s["items_decoded"]
        tot_busy += s["decode_busy_s"]
    return {
        "pipelines": per,
        "wait_s": round(tot_wait, 6),
        "waits": int(tot_waits),
        "next_calls": int(tot_calls),
        "starvation_fraction": round(tot_waits / tot_calls, 6)
        if tot_calls else 0.0,
        "decode_items_s": round(tot_items / tot_busy, 2)
        if tot_busy > 0 else None,
    }


data_report = _treg.collector_view("data", _collect)
