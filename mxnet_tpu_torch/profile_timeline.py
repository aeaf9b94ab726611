"""Where a traced ``fit`` step's unattributed time sits.

    python3 -m mxnet_tpu_torch.profile_timeline [--runs 3] [--steps 20]

Builds ``bench.py main()``'s configuration on the port (ResNet-50 ``s2d``,
bf16, batch 128, SGD, captured; ``profile_training.build_module``),
captures its step with one untraced ``fit``, then runs traced ``fit``\\ s
of ``--steps`` steps over batches already on the card, in turns over four
modes: the data pipeline on or off (``MXTPU_DATA_PIPELINE``) times a
batch-end callback or none. From each run's Chrome trace it takes every
step's top-level phase spans and the gaps between them (step start to
the first phase, phase to phase, the last phase to the step's end: the
step's ``unattributed`` time), and from ``gc.callbacks`` the collector's
passes that overlap a gap. Prints JSON lines:

- ``card``: the card's name and power limit (nvidia-smi);
- ``run``: per run, its mode, the named phases over the step walls (the
  run's sums), the lowest step's share, the collector's passes;
- ``gaps``: per mode and gap location, the count, median and largest
  gap in microseconds (host clock);
- ``lowest``: the steps with the lowest named share, with their gaps
  over 20 microseconds and any collector pass inside one.

A gap holds the loop's own code between two phases (with a callback:
its ``BatchEndParam`` and the callback), and any host stall that lands
there. Needs the card.
"""
from __future__ import annotations

import argparse
import gc
import json
import shutil
import statistics
import tempfile
import time

import torch

from . import config, io, metric, telemetry
from .profile_training import (SGD_PARAMS, build_module, card,
                               staged_batches)

MODES = (("pipeline", "callback"), ("no_pipeline", "callback"),
         ("pipeline", "no_callback"), ("no_pipeline", "no_callback"))


class _Staged(io.DataIter):
    """The staged batches in turn, ``steps`` an epoch."""

    def __init__(self, batches, steps):
        super().__init__(batch_size=int(batches[0].data[0].shape[0]))
        self._b, self._n, self._i = batches, steps, 0
        self.provide_data = [io.DataDesc(
            "data", tuple(batches[0].data[0].shape))]
        self.provide_label = [io.DataDesc(
            "softmax_label", tuple(batches[0].label[0].shape))]

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= self._n:
            raise StopIteration
        self._i += 1
        return self._b[self._i % len(self._b)]


def _fit(m, batches, steps, dirs, pipeline, callback):
    knobs = {"MXTPU_DATA_PIPELINE": "1" if pipeline else "0",
             "MXTPU_TELEMETRY_DIR": dirs[0] if dirs else None,
             "MXTPU_TRACE_DIR": dirs[1] if dirs else None,
             "MXTPU_TELEMETRY_EVENT_STEPS": 1 if dirs else None}
    overrides = [config.override(k, v) for k, v in knobs.items()]
    for o in overrides:
        o.__enter__()
    try:
        m.fit(_Staged(batches, steps), eval_metric=metric.create("acc"),
              kvstore=None, optimizer="sgd", optimizer_params=SGD_PARAMS,
              num_epoch=1,
              batch_end_callback=(lambda p: None) if callback else None)
    finally:
        for o in reversed(overrides):
            o.__exit__(None, None, None)
        telemetry.export.reset_exporter()
    torch.cuda.synchronize()


def step_gaps(trace_dir, gc_passes):
    """Per step of the run traced into ``trace_dir``: its wall and the
    gaps between its top-level phases (microseconds), each with the
    collector passes (``(start, end)`` on the trace's clock) inside."""
    spans = [e for e in telemetry.trace.read_trace(
        telemetry.trace.trace_files(trace_dir)[-1]) if e["ph"] == "X"]
    out = []
    for st in (e for e in spans if e["name"] == "step"):
        sid = st["args"]["span_id"]
        kids = sorted((e for e in spans
                       if e["args"].get("parent_id") == sid),
                      key=lambda e: e["ts"])
        edges, prev, name = [], st["ts"], "step_start"
        for k in kids:
            edges.append((f"{name}->{k['name']}", prev, k["ts"]))
            prev, name = k["ts"] + k["dur"], k["name"]
        edges.append((f"{name}->step_end", prev, st["ts"] + st["dur"]))
        gaps = [{"gap": g, "us": b - a,
                 "gc_us": [e - s for s, e in gc_passes if s < b and e > a]}
                for g, a, b in edges]
        out.append({"step": st["args"]["step"], "wall_us": st["dur"],
                    "named": 1 - sum(g["us"] for g in gaps) / st["dur"],
                    "gaps": gaps})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    print(json.dumps({"phase": "card", "nvidia_smi": card()}), flush=True)
    batches = staged_batches(args.batch, 4)
    m = build_module(args.batch)
    _fit(m, batches, 4, None, True, False)       # warm step and capture
    epoch = telemetry.trace._EPOCH
    marks = []

    def on_gc(phase, info):
        marks.append((phase, (time.perf_counter() - epoch) * 1e6))

    gc.callbacks.append(on_gc)
    steps = []
    try:
        for i in range(args.runs):
            for pipe, cb in MODES:
                dirs = (tempfile.mkdtemp(), tempfile.mkdtemp())
                marks.clear()
                try:
                    _fit(m, batches, args.steps, dirs, pipe == "pipeline",
                         cb == "callback")
                    passes = [(a[1], b[1]) for a, b in zip(marks, marks[1:])
                              if a[0] == "start" and b[0] == "stop"]
                    run = step_gaps(dirs[1], passes)
                finally:
                    for d in dirs:
                        shutil.rmtree(d, ignore_errors=True)
                mode = f"{pipe},{cb}"
                for s in run:
                    s["mode"], s["run"] = mode, i
                steps.extend(run)
                wall = sum(s["wall_us"] for s in run)
                print(json.dumps({
                    "phase": "run", "run": i, "mode": mode,
                    "named_over_wall": sum(s["named"] * s["wall_us"]
                                           for s in run) / wall,
                    "lowest_step": min(s["named"] for s in run),
                    "gc_passes_us": [e - s for s, e in passes]}),
                    flush=True)
    finally:
        gc.callbacks.remove(on_gc)
    by = {}
    for s in steps:
        for g in s["gaps"]:
            by.setdefault(f"{s['mode']}:{g['gap']}", []).append(g["us"])
    print(json.dumps({"phase": "gaps", "clock": "host, microseconds",
                      "gaps": {k: {"n": len(v),
                                   "median_us": statistics.median(v),
                                   "max_us": max(v)}
                               for k, v in sorted(by.items())}}),
          flush=True)
    steps.sort(key=lambda s: s["named"])
    for s in steps[:10]:
        s["gaps"] = [g for g in s["gaps"] if g["us"] > 20 or g["gc_us"]]
        print(json.dumps({"phase": "lowest", **s}), flush=True)


if __name__ == "__main__":
    main()
