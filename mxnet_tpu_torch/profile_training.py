"""Where a ResNet-50 training step spends its time on the card.

    python3 -m mxnet_tpu_torch.profile_training [--batch 128] [--iters 5]

Builds the configuration of ``bench.py main()`` on the port: ResNet-50
v2 with the ``s2d`` stem, ``Module(compute_dtype="bfloat16")``, Xavier
(gaussian, in, magnitude 2) from seed 0, SGD lr 0.1, momentum 0.9, wd
1e-4, both rewrite passes on; warms it with 3 steps, then prints JSON
lines:

- ``card``: the card's name and power limit (nvidia-smi);
- ``split``: host-clock ms per step of its three parts, each ended by a
  device sync — the forward and loss (graph walk + kernels), the
  backward (autograd), the update (SGD on the fp32 masters + the aux
  fold) — and of the whole ``forward``/``backward``/``update`` call;
- ``memory``: ``torch.cuda.max_memory_allocated`` over one step;
- ``device``: one ``torch.profiler`` trace over ``--iters`` steps: device
  time summed per kernel name (top entries), the device-busy share of
  the traced wall time, and the port's own kernels (K1, K2, B1, B2)
  against everything else.

Needs a CUDA card; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from . import initializer, io, mod
from .model_zoo.symbols import resnet

# substrings of the device-kernel names of the port's own kernels
PORT_KERNELS = {"K1": "bn_relu_conv1x1", "K2": "_bn_act",
                "K3": "bn_relu_matmul", "B1": "_bn_bwd_reduce",
                "B1 second stage": "_bn_bwd_sum_parts", "B2": "_bn_bwd_dx"}


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build_module(batch, seed=0, compute_dtype="bfloat16", device="cuda:0"):
    """``bench.py main()``'s Module on the port, bound at ``batch``."""
    sym = resnet.get_symbol(1000, 50, "3,224,224", stem="s2d")
    m = mod.Module(sym, context=device, compute_dtype=compute_dtype)
    m.bind(data_shapes=[("data", (batch, 3, 224, 224))],
           label_shapes=[("softmax_label", (batch,))])
    m.init_params(initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2),
                  generator=torch.Generator().manual_seed(seed))
    m.init_optimizer(kvstore=None, optimizer="sgd",
                     optimizer_params={"learning_rate": 0.1,
                                       "momentum": 0.9, "wd": 1e-4})
    return m


def staged_batches(batch, n, seed=0, device="cuda:0"):
    """``n`` random batches (uniform images, int32 labels) on the card."""
    rng = np.random.RandomState(seed)
    return [io.DataBatch(
        [torch.from_numpy(rng.rand(batch, 3, 224, 224).astype(np.float32))
         .to(device)],
        [torch.from_numpy(rng.randint(0, 1000, (batch,)).astype(np.int32))
         .to(device)]) for _ in range(n)]


def run_step(m, b):
    m.forward(b, is_train=True)
    m.backward()
    m.update()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")
    smi = card()
    print(json.dumps({"phase": "card", "nvidia_smi": smi}), flush=True)
    m = build_module(a.batch, a.seed)
    batches = staged_batches(a.batch, 4, a.seed)
    for i in range(3):
        run_step(m, batches[i % 4])
    torch.cuda.synchronize()

    fused = m._fused
    feed = m._batch_feed(batches[0])
    parts = {"forward_ms": 0.0, "backward_ms": 0.0, "update_ms": 0.0}
    for _ in range(a.iters):
        t0 = time.perf_counter()
        loss, _, aux_up = fused.forward_loss(feed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = fused.backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fused.apply(grads, aux_up, 0.1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del loss, grads
        parts["forward_ms"] += (t1 - t0) * 1e3 / a.iters
        parts["backward_ms"] += (t2 - t1) * 1e3 / a.iters
        parts["update_ms"] += (t3 - t2) * 1e3 / a.iters
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(a.iters):
        run_step(m, batches[i % 4])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / a.iters
    print(json.dumps(dict({"phase": "split", "batch": a.batch,
                           "card": smi, "step_ms": step_ms,
                           "img_per_s": a.batch / step_ms * 1e3},
                          **parts)), flush=True)

    torch.cuda.reset_peak_memory_stats()
    run_step(m, batches[0])
    torch.cuda.synchronize()
    print(json.dumps({"phase": "memory", "card": smi,
                      "max_memory_allocated_gb":
                      torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(a.iters):
            run_step(m, batches[i % 4])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + dev_us
    total_ms = sum(per_kernel.values()) / 1e3
    ours = {name: sum(v for k, v in per_kernel.items() if sub in k) / 1e3
            / a.iters for name, sub in PORT_KERNELS.items()}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:20]
    print(json.dumps({
        "phase": "device", "card": smi, "steps": a.iters,
        "traced_wall_ms": wall_ms,
        "device_kernel_ms_per_step": total_ms / a.iters if per_kernel
        else "not measured",
        "device_busy_share": total_ms / wall_ms if per_kernel
        else "not measured",
        "port_kernels_ms_per_step": ours,
        "other_kernels_ms_per_step":
            total_ms / a.iters - sum(ours.values()),
        "top_kernels_ms_per_step": [[k[:90], v / 1e3 / a.iters]
                                    for k, v in top]}), flush=True)


if __name__ == "__main__":
    main()
