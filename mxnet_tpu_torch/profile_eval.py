"""What a Module's eval forward costs on the card.

    python3 -m mxnet_tpu_torch.profile_eval [--batch 128] [--iters 20]

Builds the configuration of ``bench.py main()`` on the port through
``profile_training.build_module`` (ResNet-50 v2, ``s2d`` stem,
``Module(compute_dtype="bfloat16")``, Xavier from seed 0, SGD), takes
one training step so the Module is in its training state, warms
``Module.forward(batch, is_train=False)`` with 3 calls, then prints
JSON lines:

- ``card``: the card's name and power limit (nvidia-smi);
- ``eval_forward``: ms per ``forward(is_train=False)`` with its output
  read back to the host (``get_outputs()[0]``): host clock and CUDA
  events around each call, median and the range over ``--iters``
  calls; peak memory allocated over one call.

It uses nothing but ``build_module``, ``staged_batches``, ``run_step``
and the Module's ``forward`` / ``get_outputs``, so the same file times
another tree of the port: copy it into that tree's ``mxnet_tpu_torch/``
and run it there, in turns with this one. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from . import profile_training as pt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs a CUDA device")
    smi = pt.card()
    print(json.dumps({"phase": "card", "nvidia_smi": smi}), flush=True)
    m = pt.build_module(a.batch, a.seed)
    batches = pt.staged_batches(a.batch, 4, a.seed)
    pt.run_step(m, batches[0])

    def call(i):
        m.forward(batches[i % 4], is_train=False)
        out = m.get_outputs()[0]
        return getattr(out, "_data", out).cpu()

    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    host, event = [], []
    for i in range(a.iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        call(i)
        e.record()
        e.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        event.append(s.elapsed_time(e))
    torch.cuda.reset_peak_memory_stats()
    call(0)
    torch.cuda.synchronize()
    print(json.dumps({
        "phase": "eval_forward", "card": smi, "batch": a.batch,
        "iters": a.iters,
        "host_ms": {"median": statistics.median(host), "min": min(host),
                    "max": max(host)},
        "event_ms": {"median": statistics.median(event),
                     "min": min(event), "max": max(event)},
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "per": "Module.forward(is_train=False) + get_outputs()[0] to the "
               "host"}), flush=True)


if __name__ == "__main__":
    main()
