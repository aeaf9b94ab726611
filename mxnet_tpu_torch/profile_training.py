"""Where a ResNet-50 training step spends its time on the card.

    python3 -m mxnet_tpu_torch.profile_training [--batch 128] [--iters 5]
        [--eager]

Builds the configuration of ``bench.py main()`` on the port: ResNet-50
v2 with the ``s2d`` stem, ``Module(compute_dtype="bfloat16")``, Xavier
(gaussian, in, magnitude 2) from seed 0, SGD lr 0.1, momentum 0.9, wd
1e-4, both rewrite passes on; warms it with 3 steps (on the card the
first runs eagerly, the second captures the step as a CUDA graph), then
prints JSON lines:

- ``card``: the card's name and power limit (nvidia-smi);
- ``split``: host-clock ms per step of the eager step's three parts,
  each ended by a device sync — the forward and loss (graph walk +
  kernels), the backward (autograd), the update (SGD on the fp32
  masters + the aux fold) — and of the whole
  ``forward``/``backward``/``update`` call in the mode run (captured,
  or with ``--eager`` the eager step);
- ``program`` (captured mode): the step program's captures, capture
  seconds and replays (``compile_report``), and device ms per replay
  (CUDA events around each step);
- ``host_split`` (``--eager``): where the eager step's host time goes,
  from ``torch.profiler``'s CPU events over ``--iters`` steps: CUDA
  launch calls, ATen operators (dispatch and their CPU code, self time),
  the autograd engine's own time, and the rest (Python: the graph walk,
  the wrappers, the optimizer loop);
- ``memory``: ``torch.cuda.max_memory_allocated`` over one step;
- ``device``: one ``torch.profiler`` trace over ``--iters`` steps: device
  time summed per kernel name (top entries), the device-busy share of
  the traced wall time, and the port's own kernels (K1, K2, B1, B2)
  against everything else.

Run it with and without ``--eager`` on one tree for an A/B of the
captured step. Needs a CUDA card; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from . import compile as compile_mod
from . import initializer, io, mod
from .model_zoo.symbols import resnet

# substrings of the device-kernel names of the port's own kernels (K1's
# and K3's wgmma core is bn_gemm_wgmma<mode, ...>: modes 1-2 K1, 3 K3)
PORT_KERNELS = {"K1": ("bn_relu_conv1x1", "bn_gemm_wgmma<1,",
                       "bn_gemm_wgmma<2,"),
                "K2": ("_bn_act",),
                "K3": ("bn_relu_matmul", "bn_gemm_wgmma<3,"),
                "B1": ("_bn_bwd_reduce",),
                "B1 second stage": ("_bn_bwd_sum_parts",),
                "B2": ("_bn_bwd_dx",),
                "D1": ("d1::decode_attention",),
                "L1": ("_lstm_cell_fwd", "_lstm_cell_bwd"),
                "L1 fused forward": ("ls::lstm_fwd_kernel",),
                "L1 fused backward": ("ls::lstm_bwd_kernel",)}
# CPU events of kernel launches (the cuda* and cu* launch calls)
LAUNCH_EVENTS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx")


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


SGD_PARAMS = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def build_module(batch, seed=0, compute_dtype="bfloat16", device="cuda:0",
                 optimizer="sgd", optimizer_params=None, fused=None):
    """``bench.py main()``'s Module on the port, bound at ``batch``
    (another ``optimizer`` or ``fused`` regime when given)."""
    sym = resnet.get_symbol(1000, 50, "3,224,224", stem="s2d")
    m = mod.Module(sym, context=device, compute_dtype=compute_dtype,
                   fused=fused)
    m.bind(data_shapes=[("data", (batch, 3, 224, 224))],
           label_shapes=[("softmax_label", (batch,))])
    m.init_params(initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2),
                  generator=torch.Generator().manual_seed(seed))
    m.init_optimizer(kvstore=None, optimizer=optimizer,
                     optimizer_params=dict(optimizer_params or SGD_PARAMS))
    return m


def staged_batches(batch, n, seed=0, device="cuda:0"):
    """``n`` random batches (uniform images, int32 labels) on the card."""
    rng = np.random.RandomState(seed)
    return [io.DataBatch(
        [torch.from_numpy(rng.rand(batch, 3, 224, 224).astype(np.float32))
         .to(device)],
        [torch.from_numpy(rng.randint(0, 1000, (batch,)).astype(np.int32))
         .to(device)]) for _ in range(n)]


def run_step(m, b, eager=False):
    """One ``forward``/``backward``/``update`` of Module ``m`` on batch
    ``b``: the captured step, or with ``eager`` the same ``update``
    (schedule, lr write, step counters) around
    ``FusedSymbolStep.step_eager`` in place of the graph."""
    m.forward(b, is_train=True)
    m.backward()
    m._update(eager)


def step_program(m):
    """The compile-registry record of ``m``'s captured step (None before
    a capture)."""
    progs = [p for p in m._fused._programs.values() if p.captured]
    return progs[0].record if progs else None


def device_trace(fn, iters):
    """One ``torch.profiler`` trace of ``iters`` calls of ``fn`` (ended
    by a sync): {"wall_ms", "per_kernel": {name: device ms}, "cpu":
    {name: (self CPU ms, calls)}}. The per-kernel sums are empty where
    the profiler shows no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel, cpu = {}, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + dev_us / 1e3
        elif ev.device_type == torch.autograd.DeviceType.CPU:
            ms, n = cpu.get(ev.key, (0.0, 0))
            cpu[ev.key] = (ms + ev.self_cpu_time_total / 1e3,
                           n + ev.count)
    return {"wall_ms": wall_ms, "per_kernel": per_kernel, "cpu": cpu}


def busy_summary(trace, iters, what="step"):
    """Device ms per ``what``, busy share of the traced wall, the port's
    kernels and the top kernels, from ``device_trace``'s result."""
    per_kernel = trace["per_kernel"]
    total = sum(per_kernel.values())
    ours = {name: sum(v for k, v in per_kernel.items()
                      if any(sub in k for sub in subs)) / iters
            for name, subs in PORT_KERNELS.items()}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:20]
    return {
        "traced_wall_ms": trace["wall_ms"],
        f"device_kernel_ms_per_{what}": total / iters if per_kernel
        else "not measured",
        "device_busy_share": total / trace["wall_ms"] if per_kernel
        else "not measured",
        f"port_kernels_ms_per_{what}": ours,
        f"other_kernels_ms_per_{what}": total / iters - sum(ours.values()),
        f"top_kernels_ms_per_{what}": [[k[:90], v / iters] for k, v in top]}


def host_split(trace, iters):
    """ms per step of the traced host time: kernel-launch calls, ATen
    operators' self time, the autograd engine's own time, and the rest
    (Python), from ``device_trace``'s CPU events."""
    cpu = trace["cpu"]
    launch = sum(ms for k, (ms, _) in cpu.items() if k in LAUNCH_EVENTS)
    aten = sum(ms for k, (ms, _) in cpu.items() if k.startswith("aten::"))
    engine = sum(ms for k, (ms, _) in cpu.items()
                 if k.startswith("autograd::"))
    launches = sum(n for k, (_, n) in cpu.items() if k in LAUNCH_EVENTS)
    return {"wall_ms_per_step": trace["wall_ms"] / iters,
            "launch_calls_ms_per_step": launch / iters,
            "launch_calls_per_step": launches / iters,
            "aten_ops_self_ms_per_step": aten / iters,
            "autograd_engine_ms_per_step": engine / iters,
            "python_and_rest_ms_per_step":
                (trace["wall_ms"] - launch - aten - engine) / iters,
            "how": "torch.profiler CPU events over the traced steps: "
                   "launch calls (cudaLaunchKernel / cuLaunchKernel self "
                   "time), aten:: operators' self time, autograd:: "
                   "engine events' self time; the rest of the wall is "
                   "Python (graph walk, wrappers, optimizer loop)"}


def step_event_ms(m, batches, iters, eager):
    """Median device ms per step: CUDA events around each step, on the
    device clock (for a replay, about the graph's run time)."""
    times = []
    for i in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run_step(m, batches[i % len(batches)], eager)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eager", action="store_true",
                    help="run the eager step (no CUDA graph)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")
    smi = card()
    mode = "eager" if a.eager else "captured"
    print(json.dumps({"phase": "card", "nvidia_smi": smi, "mode": mode}),
          flush=True)
    m = build_module(a.batch, a.seed)
    batches = staged_batches(a.batch, 4, a.seed)
    for i in range(3):
        run_step(m, batches[i % 4], a.eager)
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
        run_step(m, batches[i % 4], a.eager)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / a.iters
    print(json.dumps(dict({"phase": "split", "batch": a.batch, "mode": mode,
                           "card": smi, "step_ms": step_ms,
                           "img_per_s": a.batch / step_ms * 1e3,
                           "parts_of": "the eager step"}, **parts)),
          flush=True)
    if not a.eager:
        rec = step_program(m)
        print(json.dumps({
            "phase": "program", "card": smi, "name": rec.name,
            "captures": rec.captures, "capture_s": rec.capture_s,
            "replays": rec.replays, "launches_per_replay": rec.launches,
            "device_ms_per_replay": step_event_ms(m, batches, a.iters,
                                                  False),
            "cache": compile_mod.compile_report()["cache"]}), flush=True)

    torch.cuda.reset_peak_memory_stats()
    run_step(m, batches[0], a.eager)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "memory", "card": smi, "mode": mode,
                      "max_memory_allocated_gb":
                      torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)

    trace = device_trace(lambda i: run_step(m, batches[i % 4], a.eager),
                         a.iters)
    if a.eager:
        print(json.dumps(dict({"phase": "host_split", "card": smi,
                               "steps": a.iters},
                              **host_split(trace, a.iters))), flush=True)
    print(json.dumps(dict({"phase": "device", "card": smi, "mode": mode,
                           "steps": a.iters},
                          **busy_summary(trace, a.iters))), flush=True)


if __name__ == "__main__":
    main()
