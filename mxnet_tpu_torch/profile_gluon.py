"""Where a Gluon ResNet-50 v1 training step spends its time on the card.

    python3 -m mxnet_tpu_torch.profile_gluon [--batch 64] [--iters 5]

Builds the imperative path of ``__graft_entry__.entry()``'s model on the
port: ``get_resnet(1, 50, classes=1000)``, Xavier from seed 0 on
``cuda:0``, hybridized (its forward and backward run as captured CUDA
graphs, ``gluon/cached_op.py``), ``Trainer("sgd", lr 0.1, momentum 0.9,
wd 1e-4)``, ``SoftmaxCrossEntropyLoss``, fp32 with TF32 off; warms it
with 3 steps over one batch, then prints JSON lines:

- ``card``: the card's name and power limit (nvidia-smi);
- ``split``: host-clock ms per step of its three parts, each ended by a
  device sync — the forward and loss under ``autograd.record()``, the
  backward, ``Trainer.step`` — as the median and the mean over
  ``--iters`` steps, and of whole steps;
- ``memory``: ``torch.cuda.max_memory_allocated`` over one step;
- ``device``: one ``torch.profiler`` trace over ``--iters`` steps: device
  time per kernel name (top entries), kernels launched per step, and the
  device-busy share of the traced wall time.

Needs a CUDA card; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from . import autograd, gluon, initializer, nd, random
from .context import gpu
from .profile_training import card


def build(batch, seed=0):
    """(net, trainer, loss, data, label) of the Gluon path at ``batch``."""
    random.seed(seed)
    net = gluon.model_zoo.vision.get_resnet(1, 50, classes=1000)
    net.initialize(initializer.Xavier(), ctx=gpu(0))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    rng = np.random.default_rng(seed)
    x = nd.array(rng.standard_normal((batch, 3, 224, 224)).astype(
        np.float32), ctx=gpu(0))
    y = nd.array(rng.integers(0, 1000, batch).astype(np.float32),
                 ctx=gpu(0))
    return net, trainer, gluon.loss.SoftmaxCrossEntropyLoss(), x, y


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gluon needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(json.dumps({"phase": "card", "nvidia_smi": smi}), flush=True)
    net, trainer, loss_fn, x, y = build(a.batch, a.seed)

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(a.batch)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    parts = {"forward_ms": [], "backward_ms": [], "update_ms": []}
    for _ in range(a.iters):
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(x), y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(a.batch)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts["forward_ms"].append((t1 - t0) * 1e3)
        parts["backward_ms"].append((t2 - t1) * 1e3)
        parts["update_ms"].append((t3 - t2) * 1e3)
    t0 = time.perf_counter()
    for _ in range(a.iters):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / a.iters
    print(json.dumps(dict({"phase": "split", "batch": a.batch, "card": smi,
                           "step_ms": step_ms,
                           "img_per_s": a.batch / step_ms * 1e3},
                          **{k: statistics.median(v) for k, v in parts.items()},
                          **{"mean_" + k: statistics.fmean(v)
                             for k, v in parts.items()})),
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    print(json.dumps({"phase": "memory", "card": smi,
                      "max_memory_allocated_gb":
                      torch.cuda.max_memory_allocated() / 1e9}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(a.iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel, launches = {}, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + dev_us
            launches += ev.count
    total_ms = sum(per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:20]
    print(json.dumps({
        "phase": "device", "card": smi, "steps": a.iters,
        "traced_wall_ms": wall_ms,
        "device_kernel_ms_per_step": total_ms / a.iters if per_kernel
        else "not measured",
        "kernels_per_step": launches / a.iters if per_kernel
        else "not measured",
        "device_busy_share": total_ms / wall_ms if per_kernel
        else "not measured",
        "top_kernels_ms_per_step": [[k[:90], v / 1e3 / a.iters]
                                    for k, v in top]}), flush=True)


if __name__ == "__main__":
    main()
