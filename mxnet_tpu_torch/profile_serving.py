"""Where a served ResNet-50 batch spends its time on the card.

    python3 -m mxnet_tpu_torch.profile_serving [--batch 64] [--iters 10]

Builds the same bf16 ResNet-50 ``Predictor`` as ``chip_smoke.py``
(random weights from seed 0, both rewrite passes on), warms it, then
prints JSON lines:

- ``split``: host-clock ms per call of the bucket's three steps, each
  ended by a device sync — input copy to the card, the forward (graph
  walk + kernels), output copy back — and the whole ``predict`` call;
- ``device``: one ``torch.profiler`` trace over ``--iters`` forwards:
  device time summed per kernel name (top entries), the device-busy
  share of the traced wall time, and the time of the port's own
  kernels (K1, K2) against everything else.

Needs a CUDA card; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import interop, serving
from .model_zoo.symbols import resnet
from .profile_training import PORT_KERNELS


def _sync_ms(fn, iters):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    dev = torch.device("cuda:0")
    sym = resnet.get_symbol(1000, 50, "3,224,224")
    args, aux = interop.init_params(sym, {"data": (a.batch, 3, 224, 224)},
                                    a.seed)
    pred = serving.Predictor(sym, args, aux,
                             data_shapes={"data": (3, 224, 224)},
                             buckets=(a.batch,), compute_dtype="bfloat16",
                             device=dev)
    pred.warmup()
    x = np.random.default_rng(a.seed).standard_normal(
        (a.batch, 3, 224, 224)).astype(np.float32)
    xt = torch.from_numpy(x)
    h2d_ms, xd = _sync_ms(lambda: xt.to(dev), a.iters)
    with torch.inference_mode():
        fwd_ms, outs = _sync_ms(lambda: pred._forward([xd]), a.iters)
        d2h_ms, _ = _sync_ms(lambda: outs[0].cpu(), a.iters)
    call_ms, _ = _sync_ms(lambda: pred.predict(x), a.iters)
    card = torch.cuda.get_device_name(0)
    print(json.dumps({"phase": "split", "batch": a.batch, "card": card,
                      "h2d_ms": h2d_ms, "forward_ms": fwd_ms,
                      "d2h_ms": d2h_ms, "predict_ms": call_ms,
                      "img_per_s": a.batch / call_ms * 1e3}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), torch.profiler.profile(activities=acts) \
            as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(a.iters):
            pred._forward([xd])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + dev_us
    total_ms = sum(per_kernel.values()) / 1e3
    subs = PORT_KERNELS["K1"] + PORT_KERNELS["K2"]
    ours = {k: v for k, v in per_kernel.items()
            if any(sub in k for sub in subs)}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "phase": "device", "card": card, "forwards": a.iters,
        "traced_wall_ms": wall_ms,
        "device_kernel_ms": total_ms if per_kernel else "not measured",
        "device_busy_share": total_ms / wall_ms if per_kernel
        else "not measured",
        "port_kernels_ms_per_forward": {
            k: v / 1e3 / a.iters for k, v in ours.items()},
        "other_kernels_ms_per_forward":
            (sum(per_kernel.values()) - sum(ours.values())) / 1e3 / a.iters,
        "top_kernels_ms_per_forward": [[k[:80], v / 1e3 / a.iters]
                                       for k, v in top]}), flush=True)


if __name__ == "__main__":
    main()
