"""Where D1, the decode-attention kernel, spends its time on the card.

    python3 -m mxnet_tpu_torch.profile_decode_attention [--rows 64]

At the decode path's shapes (16 lanes of a 1024-row cache, 12 heads of
64: GPT-2 small's widths), f32 and int8 cache, W = 1 and 5, it prints the
card's name and power limit, then one JSON line for each position set of
``POSITION_SETS`` and ``PROBE_SETS``:

- ``ms``: device ms a call, cold: CUDA events over calls that rotate over
  cache buffers (``cold_turns``), the counters' memset and the launch
  gaps included;
- ``kernel_us``, ``memset_us``: the kernel's and the memset's device time
  a call from one ``torch.profiler`` trace; ``triton_us``: the first,
  Triton form's kernel on the same inputs;
- ``blocks``: from a build of D1 with ``D1_TRACE`` (per-block clocks,
  ns): the launch's span; when the blocks that have rows start (p50, p90,
  max); per such block the wait for K, then for V (the first token's
  scores and softmax under it), the rest of its tokens, and for the
  blocks of lanes with more than one chunk the ticket; the last block's
  combine (mean and max, us).

``empty`` (positions -16: no block has a row) and ``zero`` (every lane
at position 0: one row, one chunk) give the launch's fixed costs.
``chip_smoke.py`` times D1 at ``POSITION_SETS`` over ``cache_buffers``.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from .kernels import build, decode_attention_triton
from .ops import decode_attention as da
from .profile_training import card
from .serving.decode import model as dm

LANES, MAX_SEQ, HEADS, HEAD_DIM = 16, 1024, 12, 64
# mixed positions with inactive lanes at 0; decode_serving's step (16
# lanes at 512); one long lane and 15 inactive ones
POSITION_SETS = {
    "mixed": (0, 1, 17, 511, 1023, 0, 0, 0, 300, 1000, 64, 5, 700, 900,
              128, 33),
    "serving_512": (512,) * 16,
    "one_long": (1023,) + (0,) * 15}
PROBE_SETS = {"empty": (-16,) * 16, "zero": (0,) * 16}
# a cold call finds no row in L2: the calls rotate over at least a decode
# step's 12 layers' buffers, and over enough that twice the L2 passes
# between two calls on one buffer
LAYERS = 12
L2_BYTES = 50 * 2 ** 20
SPIN_CYCLES = 20_000_000         # ~10 ms of GPU clock: covers queuing


def cache_buffers(kv, count, generator, device="cuda"):
    """``count`` random (k, v, k_scale, v_scale) cache buffers of the
    decode path's shape; f32 (scales None) or int8 quantized as the
    decode model writes its rows."""
    shape = (LANES, MAX_SEQ, HEADS, HEAD_DIM)
    out = []
    for _ in range(count):
        k = torch.randn(shape, device=device, generator=generator)
        v = torch.randn(shape, device=device, generator=generator)
        if kv == "int8":
            (k, ks), (v, vs) = dm._kv_quant_rows(k), dm._kv_quant_rows(v)
            out.append((k, v, ks, vs))
        else:
            out.append((k, v, None, None))
    return out


def needed_bytes(positions, width, kv):
    """Bytes a call must move: q read and out written, the positions, and
    the K and V rows (with int8 scales) the positions need."""
    rows = sum(min(max(p + width, 0), MAX_SEQ) for p in positions)
    row = HEADS * HEAD_DIM * (1 if kv == "int8" else 4) \
        + (4 * HEADS if kv == "int8" else 0)
    return 2 * LANES * width * HEADS * HEAD_DIM * 4 + LANES * 4 \
        + 2 * rows * row


def cold_turns(nbytes, available):
    """Buffers a cold timing rotates over: at least LAYERS, and enough
    that twice L2_BYTES pass between two calls on one buffer."""
    return min(available, max(LAYERS, -(-2 * L2_BYTES // max(nbytes, 1))
                              + 1))


def rotating(fn, arg_sets):
    """``fn`` over ``arg_sets`` in turn, one argument tuple a call."""
    turn = [0]

    def call():
        args = arg_sets[turn[0] % len(arg_sets)]
        turn[0] += 1
        return fn(*args)
    return call


def event_ms(fn, inner, reps=5, warmup=3):
    """Device ms per ``fn()``: median over ``reps`` runs of ``inner``
    calls between CUDA events, each queued behind a spin kernel so the
    host's launch cost does not count."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def triton_form(q, k, v, positions, k_scale=None, v_scale=None):
    """The first, Triton form of D1 (reached by no path of the package),
    counted nowhere: the yardstick D1 is timed against."""
    out = torch.empty_like(q)
    decode_attention_triton.launch(q, k, v, k_scale, v_scale, positions,
                                   out)
    return out


def _profile_us(fn, calls):
    """Device us a call of each kernel name in one profiler trace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total",
                     getattr(ev, "cuda_time_total", 0.0))
        if us:
            out[ev.key] = out.get(ev.key, 0.0) + us / calls
    return out


def _stats(x):
    return [float(x.mean()) / 1e3, float(x.max()) / 1e3] if x.size \
        else None


def block_phases(clocks, grid):
    """The launch's per-block phases (us) from D1_TRACE's clocks (one row
    of 8 u64 a block, 0 where not reached)."""
    t = clocks.reshape(-1, 8)[:int(np.prod(grid))].astype(np.int64)
    t0 = t[t[:, 0] > 0, 0].min()
    rel = np.where(t > 0, t - t0, -1)
    work = rel[:, 1] >= 0
    multi = rel[:, 4] >= 0
    last = rel[:, 5] >= 0
    start = rel[work, 0]
    return {
        "span_us": float(rel.max()) / 1e3,
        "blocks": int(t.shape[0]), "blocks_with_rows": int(work.sum()),
        "start_us_p50_p90_max": [float(np.percentile(start, p)) / 1e3
                                 for p in (50, 90, 100)]
        if start.size else None,
        "k_wait_us": _stats(rel[work, 1] - rel[work, 0]),
        "v_wait_first_token_us": _stats(rel[work, 2] - rel[work, 1]),
        "rest_of_tokens_us": _stats(rel[work, 3] - rel[work, 2]),
        "ticket_us": _stats(rel[multi, 4] - rel[multi, 3]),
        "combine_us": _stats(rel[last, 5] - rel[last, 4]),
        "last_end_us": float(rel.max()) / 1e3}


def profile_case(kv, width, where, positions, buffers, rows, generator):
    """One JSON-able row: ms, per-kernel us and block phases at one
    position set (see the module docstring)."""
    q = torch.randn(LANES, width, HEADS, HEAD_DIM, device="cuda",
                    generator=generator)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    nbytes = needed_bytes(positions, width, kv)
    turns = cold_turns(nbytes, len(buffers))
    sets = [(q, k, v, pos, ks, vs) for k, v, ks, vs in buffers[:turns]]
    plan = da._d1_plan(LANES, width, MAX_SEQ, HEADS, HEAD_DIM,
                       kv == "int8", rows)

    def d1(q, k, v, p, ks, vs, defines=()):
        return da._d1_run(q, k, v, p, ks, vs, plan, defines)
    row = {"kv_dtype": kv, "width": width, "positions_set": where,
           "rows": rows, "grid": list(plan.grid), "bytes_needed": nbytes,
           "turns": turns, "ms": event_ms(rotating(d1, sets), turns)}
    per = _profile_us(rotating(d1, sets), 4 * turns)
    row["kernel_us"] = sum(v for k, v in per.items()
                           if "decode_attention" in k)
    row["memset_us"] = sum(v for k, v in per.items() if "emset" in k)
    if where != "empty":
        tri = _profile_us(rotating(triton_form, sets), 4 * turns)
        row["triton_us"] = sum(tri.values())
    # the traced build: a cold call on the buffer the others left
    for args in sets[1:]:
        d1(*args, defines=("D1_TRACE",))
    torch.cuda.synchronize()
    read = build.load("decode_attention", ("D1_TRACE",)) \
        .mxtt_decode_attention_trace
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    clocks = np.zeros(8 << 14, np.uint64)
    read(clocks.ctypes.data)                         # and clears them
    d1(*sets[0], defines=("D1_TRACE",))
    torch.cuda.synchronize()
    if read(clocks.ctypes.data):
        raise RuntimeError("reading D1's trace clocks failed")
    row["blocks"] = block_phases(clocks, plan.grid)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=da.D1_ROWS,
                    help="rows a chunk (32, 64 or 128)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode_attention needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _profile_us(lambda: torch.empty(1, device="cuda").zero_(), 1)
    sets = dict(POSITION_SETS, **PROBE_SETS)
    for kv in ("float32", "int8"):
        buffers = cache_buffers(kv, 64 if kv == "int8" else 24, gen)
        for where, positions in sets.items():
            for width in (1, 5):
                print(json.dumps(profile_case(kv, width, where, positions,
                                              buffers, args.rows, gen)),
                      flush=True)
        del buffers
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
