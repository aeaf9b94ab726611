"""Where a served ResNet-50 batch spends its time on the card.

    python3 -m mxnet_tpu_torch.profile_serving [--batch 64] [--iters 10]
        [--eager]

Builds the same bf16 ResNet-50 ``Predictor`` as ``chip_smoke.py``
(random weights from seed 0, both rewrite passes on), warms it (on the
card that captures the bucket's CUDA graph), then prints JSON lines:

- ``split``: host-clock ms per call of the bucket's three steps, each
  ended by a device sync, and of the whole ``predict`` call. Captured:
  the input staged through the pinned buffer to the static input, the
  graph's replay, the output copy into the pinned buffer. ``--eager``:
  the pageable input copy to the card, the forward (graph walk +
  kernels), the output copy back;
- ``program`` (captured mode): the bucket program's captures, capture
  seconds and replays (``compile_report``), and device ms per replay
  (CUDA events around each replay);
- ``device``: one ``torch.profiler`` trace over ``--iters`` forwards
  (replays, or eager forwards): device time summed per kernel name (top
  entries), the device-busy share of the traced wall time, and the time
  of the port's own kernels (K1, K2) against everything else;
- ``request``: a trace over ``--iters`` whole ``predict`` calls: wall ms
  per request, the busy share, and the CPU events with the most self
  time (ms and calls per request).

Run it with and without ``--eager`` on one tree for an A/B of the
captured bucket. Needs a CUDA card; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from . import compile as compile_mod
from . import interop, serving
from .model_zoo.symbols import resnet
from .profile_training import busy_summary, card, device_trace


def _sync_ms(fn, iters):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3, out


def build_predictor(batch, seed=0, buckets=None):
    """``chip_smoke.py``'s served ResNet-50 (v2, ``stem="std"``, bf16,
    random weights from ``seed``) on ``cuda:0``."""
    sym = resnet.get_symbol(1000, 50, "3,224,224")
    args, aux = interop.init_params(sym, {"data": (batch, 3, 224, 224)},
                                    seed)
    return serving.Predictor(sym, args, aux,
                             data_shapes={"data": (3, 224, 224)},
                             buckets=buckets or (batch,),
                             compute_dtype="bfloat16",
                             device=torch.device("cuda:0"))


def captured_split(pred, x, iters):
    """Host ms per call of the captured bucket's three steps (each
    ended by a sync): staging in, replay, copy out."""
    rows = x.shape[0]
    prog = pred._programs[(pred.bucket_for(rows), (x.dtype.name,))]
    with pred._lock, torch.inference_mode():
        h2d, _ = _sync_ms(lambda: pred._copy_in(prog, [x], rows), iters)
        rep, _ = _sync_ms(prog.replay, iters)
        d2h, _ = _sync_ms(lambda: pred._copy_out(prog), iters)
    return {"h2d_ms": h2d, "replay_ms": rep, "d2h_ms": d2h}, prog


def eager_split(pred, x, iters):
    """Host ms per call of the eager bucket's three steps (each ended by
    a sync): pageable copy in, forward, copy out."""
    dev = pred.device
    xt = torch.from_numpy(x)
    h2d, xd = _sync_ms(lambda: xt.to(dev), iters)
    with torch.inference_mode():
        fwd, outs = _sync_ms(lambda: pred._forward([xd]), iters)
        d2h, _ = _sync_ms(lambda: outs[0].cpu(), iters)
    return {"h2d_ms": h2d, "forward_ms": fwd, "d2h_ms": d2h}


def replay_event_ms(prog, iters):
    """Median device ms of one replay (CUDA events around it)."""
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        prog.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eager", action="store_true",
                    help="run the eager forward (no CUDA graph)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    smi = card()
    mode = "eager" if a.eager else "captured"
    pred = build_predictor(a.batch, a.seed)
    pred.warmup()
    x = np.random.default_rng(a.seed).standard_normal(
        (a.batch, 3, 224, 224)).astype(np.float32)
    predict = pred.predict_eager if a.eager else pred.predict
    predict(x)
    if a.eager:
        parts = eager_split(pred, x, a.iters)
    else:
        parts, prog = captured_split(pred, x, a.iters)
    call_ms, _ = _sync_ms(lambda: predict(x), a.iters)
    print(json.dumps(dict({"phase": "split", "batch": a.batch,
                           "mode": mode, "card": smi,
                           "predict_ms": call_ms,
                           "img_per_s": a.batch / call_ms * 1e3},
                          **parts)), flush=True)
    if not a.eager:
        rec = prog.record
        with pred._lock, torch.inference_mode():
            dev_ms = replay_event_ms(prog, a.iters)
        print(json.dumps({
            "phase": "program", "card": smi, "name": rec.name,
            "captures": rec.captures, "capture_s": rec.capture_s,
            "replays": rec.replays, "launches_per_replay": rec.launches,
            "device_ms_per_replay": dev_ms,
            "cache": compile_mod.compile_report()["cache"]}), flush=True)

    if a.eager:
        xd = torch.from_numpy(x).to(pred.device)

        def fwd(_):
            with torch.inference_mode():
                pred._forward([xd])
    else:
        def fwd(_):
            with pred._lock, torch.inference_mode():
                prog.replay()
    trace = device_trace(fwd, a.iters)
    summ = busy_summary(trace, a.iters, what="forward")
    summ["port_kernels_ms_per_forward"] = {
        n: v for n, v in summ["port_kernels_ms_per_forward"].items()
        if n in ("K1", "K2")}
    print(json.dumps(dict({"phase": "device", "card": smi, "mode": mode,
                           "forwards": a.iters}, **summ)), flush=True)
    trace = device_trace(lambda _: predict(x), a.iters)
    cpu = sorted(trace["cpu"].items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "phase": "request", "card": smi, "mode": mode,
        "requests": a.iters, "wall_ms_per_request":
            trace["wall_ms"] / a.iters,
        "busy_share": busy_summary(trace, a.iters, what="request")[
            "device_busy_share"],
        "top_cpu_self_ms_per_request": [[k[:60], ms / a.iters, n / a.iters]
                                        for k, (ms, n) in cpu]}),
        flush=True)


if __name__ == "__main__":
    main()
