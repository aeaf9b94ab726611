#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME``, ``PATH`` or
``/usr/local/cuda``) and ``triton``; imports nothing of JAX or of the JAX
package. Every phase prints one JSON line; any failure raises, so the
script exits non-zero and prints no result. Phases:

1. device: the card's name and power limit; TF32 off for fp32 references.
2. build: compiles the CUDA kernels from the sources in this checkout.
3. kernels: each kernel against its plain PyTorch version at the shapes
   ResNet-50 serving gives it (batch 64), with errors, tolerances, median
   times (CUDA events) beside the plain version's, a PyTorch library
   call's (a yardstick the port never calls) and the data-sheet bound;
   plus ragged edge shapes.
4. serving: ResNet-50 (random weights from seed 0) behind a bf16
   ``Predictor`` and a ``DynamicBatcher`` on ``cuda:0``; concurrent
   requests of 1, 5, 37 and 64 rows; launch counts per bucket call;
   top-1 agreement (on the rows the fp32 graph decides by a margin) and
   logit error against the fp32 plain graph on the card, and a probe
   that plants a fault at one K1 site and expects these checks to
   reject it; img/s and request latency.
5. the kernels line, then the result line.
"""
import json
import statistics
import subprocess
import sys
import threading
import time

# data-sheet peaks of one H100 SXM (dense): bytes/s, and flop/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SEED = 0
SPIN_CYCLES = 20_000_000   # ~10 ms of GPU clock: covers queuing a run
# Random ResNet-50 weights give near-ties between the top two classes
# (fp32 logit gaps down to 1e-5), where bf16 rounding alone flips top-1
# whether or not a kernel runs (the plain bf16 graph, with no kernel, is
# printed beside the served path). So top-1 is held at >= 0.98 on the
# rows whose fp32 gap exceeds this margin (about 8 bf16 steps).
TOP1_MARGIN = 0.03
# The served path's logits against the fp32 plain graph's, each row's
# log-probabilities less their mean (the logits up to a constant), as
# RMS error over RMS value: over all classes, and over the part that
# depends on the row's input (each class's mean over the rows taken
# away). Limits: about twice what the plain bf16 graph, with no kernel,
# read on an H100 (0.0112 and 0.0927; PERF.md).
MAX_LOGIT_REL_ERR = 0.02
MAX_INPUT_PART_REL_ERR = 0.18
# The K1 call of a forward that the fault probe breaks: the 27th, the
# one whose fault the top-1 check alone did not see (PERF.md).
FAULT_SITE = 27


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps=5, inner=10, warmup=3):
    """Device milliseconds per ``fn()`` call: the median over ``reps``
    runs of ``inner`` back-to-back calls, each run between one pair of
    CUDA events, after ``warmup`` calls. A spin kernel holds the stream
    while the host queues each run, so the launches reach the card back
    to back and host launch cost does not count."""
    import torch
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
    return statistics.median(times)


def bound_ms(nbytes, flops, dtype):
    """(least time on the card in ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare_to_fp32(ref, got, plain16):
    """How the served path's probabilities ``got`` (and the plain bf16
    graph's) differ from the fp32 plain graph's ``ref``."""
    import numpy as np

    def centred(p):
        z = np.log(np.maximum(p.astype(np.float64), 1e-30))
        return z - z.mean(axis=1, keepdims=True)

    def rms(a):
        return float(np.sqrt((a ** 2).mean()))

    c_ref, c_got, c_p16 = centred(ref), centred(got), centred(plain16)
    i_ref, i_got, i_p16 = (c - c.mean(axis=0) for c in (c_ref, c_got, c_p16))
    top_ref = ref.argmax(1)
    srt = np.sort(c_ref, axis=1)
    decisive = srt[:, -1] - srt[:, -2] > TOP1_MARGIN
    agree = got.argmax(1) == top_ref
    return {
        "top1_agreement": float(agree.mean()),
        "decisive_rows": int(decisive.sum()),
        "top1_agreement_decisive": float(agree[decisive].mean()),
        "top1_agreement_plain_bf16": float((plain16.argmax(1) == top_ref)
                                           .mean()),
        "ref_distinct_top1": int(len(set(top_ref))),
        "ref_top_prob_mean": float(ref.max(1).mean()),
        "ref_top_prob_max": float(ref.max()),
        "max_abs_prob_diff": float(np.abs(got - ref).max()),
        "logit_rms": rms(c_ref),
        "input_part_rms": rms(i_ref),
        "max_abs_logit_err": float(np.abs(c_got - c_ref).max()),
        "logit_rel_err": rms(c_got - c_ref) / rms(c_ref),
        "logit_rel_err_plain_bf16": rms(c_p16 - c_ref) / rms(c_ref),
        "input_part_rel_err": rms(i_got - i_ref) / rms(i_ref),
        "input_part_rel_err_plain_bf16": rms(i_p16 - i_ref) / rms(i_ref),
        "required": f"decisive rows (fp32 logit gap > {TOP1_MARGIN}) >= 32 "
                    "with top-1 agreement >= 0.98; logit_rel_err <= "
                    f"{MAX_LOGIT_REL_ERR}; input_part_rel_err <= "
                    f"{MAX_INPUT_PART_REL_ERR}"}


def served_path_failures(cmp):
    """The served-path checks that ``cmp`` fails (empty when it passes)."""
    fails = []
    if cmp["decisive_rows"] < 32:
        fails.append("fewer than 32 decisive rows")
    if cmp["top1_agreement_decisive"] < 0.98:
        fails.append(f"top-1 agreement {cmp['top1_agreement_decisive']} "
                     "< 0.98 on decisive rows")
    if cmp["logit_rel_err"] > MAX_LOGIT_REL_ERR:
        fails.append(f"logit error {cmp['logit_rel_err']} > "
                     f"{MAX_LOGIT_REL_ERR}")
    if cmp["input_part_rel_err"] > MAX_INPUT_PART_REL_ERR:
        fails.append(f"input-dependent logit error "
                     f"{cmp['input_part_rel_err']} > "
                     f"{MAX_INPUT_PART_REL_ERR}")
    return fails


def site_shapes(mt, sym, batch):
    """{(op, data shape, weight shape, relu): count} over the fused
    sites of the served graph at ``batch``."""
    from mxnet_tpu_torch.symbol import passes
    import torch
    a, _, x = sym.infer_shape(data=(batch, 3, 224, 224))
    shapes = dict(zip(sym.list_arguments(), a))
    shapes.update(zip(sym.list_auxiliary_states(), x))
    fused, _ = passes.apply_pipeline(sym, shapes, tag="chip_smoke",
                                     device=torch.device("cuda"))
    _, node_shapes = fused._propagate_shapes(shapes)
    counts = {}
    for n in fused._topo_nodes():
        if n.op in ("_FusedBNReLUConv", "_FusedBNReLUConvK"):
            d = node_shapes[(id(n.inputs[0][0]), n.inputs[0][1])]
            w = node_shapes[(id(n.inputs[5][0]), n.inputs[5][1])]
            key = (n.op, tuple(d), tuple(w),
                   n.op_attrs().get("act_type") == "relu")
            counts[key] = counts.get(key, 0) + 1
    return counts


def k1_case(mt, torch, F, gen, b, c, h, w, o, relu, dtype, timed=True,
            misalign=False):
    """K1 at one shape: error against the fp32 plain version, times.
    ``misalign`` starts x one element into its buffer, so the kernel
    must fall back to its narrowest access."""
    fb = mt.ops.fused_bn_conv
    dt = getattr(torch, dtype)
    dev = "cuda"
    x = torch.randn(b, c, h, w, generator=gen, device=dev).to(dt)
    if misalign:
        buf = torch.empty(x.numel() + 1, device=dev, dtype=dt)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(b, c, h, w)
    wt = (torch.randn(o, c, generator=gen, device=dev) / c ** 0.5).to(dt)
    sc = (0.5 + torch.rand(c, generator=gen, device=dev)).to(dt)
    sh = (0.2 * torch.randn(c, generator=gen, device=dev)).to(dt)
    out = fb.bn_relu_conv_nchw(x, wt, sc, sh, relu=relu)
    torch.cuda.synchronize()
    ref = fb.bn_relu_conv_nchw_plain(x.float(), wt.float(), sc.float(),
                                     sh.float(), relu=relu)
    err = (out.float() - ref).abs()
    scale = ref.abs().max().item()
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    ok = bool((err <= tol * scale + tol * ref.abs()).all())
    row = {"phase": "kernel", "kernel": "bn_relu_conv1x1", "dtype": dtype,
           "x": [b, c, h, w], "O": o, "relu": relu, "misalign": misalign,
           "max_abs_err": err.max().item(),
           "max_rel_err": (err / ref.abs().clamp_min(1e-3 * scale))
           .max().item(),
           "out_scale": scale,
           "tolerance": f"|err| <= {tol}*max|ref| + {tol}*|ref| "
                        "(ref: plain version in fp32 on the same inputs)",
           "ok": ok}
    if timed:
        s = h * w
        e = torch.finfo(dt).bits // 8
        nbytes = (b * c * s + o * c + 2 * c + b * o * s) * e
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes,
                                                    2 * b * o * c * s,
                                                    dtype)
        row["ms"] = time_ms(lambda: fb.bn_relu_conv_nchw(x, wt, sc, sh,
                                                         relu))
        row["plain_ms"] = time_ms(lambda: fb.bn_relu_conv_nchw_plain(
            x, wt, sc, sh, relu))
        xhat = fb.bn_act_prologue_plain(x, sc, sh, relu)
        w4 = wt.reshape(o, c, 1, 1)
        row["library_ms"] = time_ms(lambda: F.conv2d(xhat, w4))
        row["library_call"] = "F.conv2d 1x1 on the normalised input"
    emit(row)
    check(ok, f"K1 disagrees with its plain version: {row}")
    return row


def k2_case(mt, torch, F, gen, b, c, h, w, relu, dtype, timed=True):
    """K2 at one shape: error against the fp32 plain version, times."""
    fb = mt.ops.fused_bn_conv
    dt = getattr(torch, dtype)
    dev = "cuda"
    x = torch.randn(b, c, h, w, generator=gen, device=dev).to(dt)
    sc = (0.5 + torch.rand(c, generator=gen, device=dev)).to(dt)
    sh = (0.2 * torch.randn(c, generator=gen, device=dev)).to(dt)
    out = fb.bn_act_prologue(x, sc, sh, relu=relu)
    torch.cuda.synchronize()
    ref = fb.bn_act_prologue_plain(x.float(), sc.float(), sh.float(),
                                   relu=relu)
    err = (out.float() - ref).abs()
    scale = ref.abs().max().item()
    tol = 1e-2 if dtype == "bfloat16" else 1e-6
    ok = bool((err <= tol * ref.abs() + 1e-6 * scale).all())
    row = {"phase": "kernel", "kernel": "bn_prologue", "dtype": dtype,
           "x": [b, c, h, w], "relu": relu,
           "max_abs_err": err.max().item(),
           "max_rel_err": (err / ref.abs().clamp_min(1e-3 * scale))
           .max().item(),
           "tolerance": f"|err| <= {tol}*|ref| + 1e-6*max|ref| (one "
                        "rounding to the output type)",
           "ok": ok}
    if timed:
        e = torch.finfo(dt).bits // 8
        n = b * c * h * w
        row["bound_ms"], row["bound_by"] = bound_ms((2 * n + 2 * c) * e,
                                                    2 * n, "float32")
        row["ms"] = time_ms(lambda: fb.bn_act_prologue(x, sc, sh, relu))
        row["plain_ms"] = time_ms(lambda: fb.bn_act_prologue_plain(
            x, sc, sh, relu))
        mean = torch.zeros(c, device=dev)
        var = torch.ones(c, device=dev)
        scf, shf = sc.float(), sh.float()
        row["library_ms"] = time_ms(lambda: F.batch_norm(
            x, mean, var, scf, shf, training=False, eps=1e-5))
        row["library_call"] = "F.batch_norm eval (without the ReLU)"
    emit(row)
    check(ok, f"K2 disagrees with its plain version: {row}")
    return row


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; run it on the GPU "
              "machine", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.kernels import build
    from mxnet_tpu_torch.model_zoo.symbols import resnet
    fb = mt.ops.fused_bn_conv
    t_start = time.perf_counter()

    # 1. device --------------------------------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    ptxas = [ln.strip() for name in libs for ln in
             build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libs, "ptxas": ptxas})

    # 3. kernels against their plain versions --------------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sym = resnet.get_symbol(1000, 50, "3,224,224")
    batch = 64
    sites = site_shapes(mt, sym, batch)
    per_fwd = {"bn_relu_conv1x1": {}, "bn_prologue": {}}
    for (op, d, w, relu), count in sorted(sites.items()):
        b, c, h, wd = d
        if op == "_FusedBNReLUConv":
            for dtype in ("bfloat16", "float32"):
                row = k1_case(mt, torch, F, gen, b, c, h, wd, w[0], relu,
                              dtype)
                if dtype == "bfloat16":
                    per_fwd["bn_relu_conv1x1"][(d, w)] = (count, row)
        else:
            row = k2_case(mt, torch, F, gen, b, c, h, wd, relu, "bfloat16")
            per_fwd["bn_prologue"][(d, relu)] = (count, row)
    # ragged edges: odd channels, odd and even spatial extents (every
    # vector width of the bf16 kernel), tiny batches, a misaligned x
    for b, c, h, wd, o in ((2, 3, 1, 7, 5), (3, 33, 9, 13, 65),
                           (1, 100, 7, 7, 130), (3, 33, 4, 6, 65),
                           (2, 17, 4, 5, 9), (5, 40, 1, 2, 70)):
        for dtype in ("bfloat16", "float32"):
            k1_case(mt, torch, F, gen, b, c, h, wd, o, True, dtype,
                    timed=False)
            k1_case(mt, torch, F, gen, b, c, h, wd, o, False, dtype,
                    timed=False)
        k2_case(mt, torch, F, gen, b, c, h, wd, False, "bfloat16",
                timed=False)
        k2_case(mt, torch, F, gen, b, c, h, wd, True, "float32",
                timed=False)
    k1_case(mt, torch, F, gen, 3, 16, 4, 8, 24, True, "bfloat16",
            timed=False, misalign=True)
    try:
        fb.bn_relu_conv_nchw(torch.zeros(1, 8, 2, 2, device="cuda",
                                         dtype=torch.float16),
                             torch.zeros(8, 8, device="cuda",
                                         dtype=torch.float16),
                             torch.ones(8, device="cuda",
                                        dtype=torch.float16),
                             torch.zeros(8, device="cuda",
                                         dtype=torch.float16))
        raise AssertionError("K1 accepted float16 on CUDA")
    except mt.MXNetError as e:
        emit({"phase": "kernel", "raises_on_unsupported_dtype": str(e)})

    # 4. serving -------------------------------------------------------------
    t0 = time.perf_counter()
    args, aux = mt.interop.init_params(sym, {"data": (batch, 3, 224, 224)},
                                       SEED)
    pred = mt.serving.Predictor(sym, args, aux, data_names=("data",),
                                data_shapes={"data": (3, 224, 224)},
                                buckets=(1, 8, 64),
                                compute_dtype="bfloat16", device="cuda:0")
    sites_applied = pred.report()["pass_sites"]
    check(sites_applied == {"pallas_fusion": 28, "residual_fusion": 17},
          f"pass sites {sites_applied}")
    batcher = mt.serving.DynamicBatcher(pred, max_wait_us=20000)
    batcher.start()                     # warms every bucket
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    reqs = {r: rng.standard_normal((r, 3, 224, 224)).astype(np.float32)
            for r in (1, 5, 37, 64)}

    def calls():
        return sum(v["calls"] for v in pred.report()["per_bucket"].values())

    results = {}
    gate = threading.Barrier(len(reqs))

    def client(rows):
        gate.wait()
        results[rows] = batcher.submit(reqs[rows]).result(timeout=300)

    fb.reset_launch_counts()
    calls0 = calls()
    threads = [threading.Thread(target=client, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    launches = fb.launch_counts()
    n_calls = calls() - calls0
    check(len(results) == len(reqs), "a request did not complete")
    emit({"phase": "serving_launches", "bucket_calls": n_calls,
          "launches": launches,
          "per_bucket_call": {k: v / max(n_calls, 1)
                              for k, v in launches.items()}})
    check(n_calls >= 1 and launches["bn_relu_conv_nchw"] == 28 * n_calls
          and launches["bn_act_prologue"] == 17 * n_calls,
          f"kernel launches {launches} over {n_calls} bucket calls")
    for rows, out in sorted(results.items()):
        sums = out.sum(axis=1)
        emit({"phase": "serving_request", "rows": rows,
              "shape": list(out.shape), "finite": bool(np.isfinite(out)
                                                       .all()),
              "max_row_sum_err": float(np.abs(sums - 1).max())})
        check(out.shape == (rows, 1000), f"shape {out.shape}")
        check(np.isfinite(out).all(), "non-finite probabilities")
        check(np.abs(sums - 1).max() <= 1e-2, "rows do not sum to 1")

    # the same graph without rewrite or kernel: fp32 (the reference) and
    # bf16 (the same dtype flow as the served path)
    with config.override("MXTPU_PASS_RESIDUAL_FUSION", "0"):
        ref_pred, plain16_pred = (mt.serving.Predictor(
            sym, args, aux, data_shapes={"data": (3, 224, 224)},
            buckets=(64,), apply_fusion=False, compute_dtype=cdt,
            device="cuda:0") for cdt in (None, "bfloat16"))
    check(ref_pred.report()["pass_sites"] == {}, "reference was rewritten")
    fb.reset_launch_counts()
    ref = ref_pred.predict(reqs[64])
    plain16 = plain16_pred.predict(reqs[64])
    check(sum(fb.launch_counts().values()) == 0, "reference hit a kernel")
    got = results[64]
    cmp = compare_to_fp32(ref, got, plain16)
    fails = served_path_failures(cmp)
    emit(dict({"phase": "serving_vs_fp32_plain", "rows": 64}, **cmp))
    check(not fails, f"served path against fp32: {fails}")

    # the same comparison with a fault planted at one K1 site (its first
    # 32 input channels dropped, as a kernel that skipped a chunk would):
    # the checks above must reject it
    real_k1 = fb.bn_relu_conv_nchw
    calls_k1 = [0]

    def faulty_k1(x, w, scale, shift, relu=True):
        calls_k1[0] += 1
        if calls_k1[0] % 28 == FAULT_SITE:
            w = w.clone()
            w[:, :32] = 0
        return real_k1(x, w, scale, shift, relu)

    faulty_k1.launches = 0   # the wrapper counts under the name it has
    fb.bn_relu_conv_nchw = faulty_k1
    try:
        faulty = pred.predict(reqs[64])
    finally:
        fb.bn_relu_conv_nchw = real_k1
    cmp_fault = compare_to_fp32(ref, faulty, plain16)
    fails = served_path_failures(cmp_fault)
    emit(dict({"phase": "serving_fault_probe", "fault": f"K1 site "
               f"{FAULT_SITE} of 28 without its first 32 input channels",
               "rejected_by": fails}, **cmp_fault))
    check(fails, "the served-path checks pass a planted fault")

    # throughput of the 64 bucket, and request latency under a closed loop
    x64 = reqs[64]
    pred.predict(x64)
    torch.cuda.synchronize()
    n_iter = 10
    t0 = time.perf_counter()
    for _ in range(n_iter):
        pred.predict(x64)
    dt = time.perf_counter() - t0
    lat = []
    lat_lock = threading.Lock()

    def loop_client(k):
        r = np.random.default_rng(SEED + k).standard_normal(
            (16, 3, 224, 224)).astype(np.float32)
        for _ in range(6):
            t = time.perf_counter()
            batcher.submit(r).result(timeout=300)
            with lat_lock:
                lat.append((time.perf_counter() - t) * 1e3)

    threads = [threading.Thread(target=loop_client, args=(k,))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    batcher.stop()
    emit({"phase": "serving_speed", "bucket": 64,
          "img_per_s": n_iter * 64 / dt, "ms_per_call": dt / n_iter * 1e3,
          "closed_loop": "4 clients x 6 requests of 16 rows",
          "p50_request_ms": float(np.percentile(lat, 50)),
          "p99_request_ms": float(np.percentile(lat, 99)),
          "batcher": batcher.report()["per_bucket"],
          "setup_s": setup_s,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": smi})

    # 5. the kernels line, then the result ------------------------------------
    def agg(name, source, replaces, route, launch_key):
        rows = per_fwd[name].values()
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches[launch_key],
                "launches_per_forward": launches[launch_key] / n_calls,
                "max_abs_err": max(r["max_abs_err"] for _, r in rows),
                "ms": sum(c * r["ms"] for c, r in rows),
                "plain_ms": sum(c * r["plain_ms"] for c, r in rows),
                "bound_ms": sum(c * r["bound_ms"] for c, r in rows),
                "bound_by": "bytes" if sum(
                    c * r["bound_ms"] for c, r in rows
                    if r["bound_by"] == "bytes") >= sum(
                    c * r["bound_ms"] for c, r in rows) / 2
                else "operations",
                "library_ms": sum(c * r["library_ms"] for c, r in rows),
                "dtype": "bfloat16", "batch": batch,
                "per": "one ResNet-50 forward at batch 64 (sum over sites)",
                "status": "ok"}

    emit({"kernels": [
        agg("bn_relu_conv1x1",
            "mxnet_tpu_torch/kernels/csrc/bn_relu_conv1x1.cu",
            "mxnet_tpu/ops/pallas_fused.py:234 (_make_nchw_kernel; "
            "pallas_call :420)", "cuda", "bn_relu_conv_nchw"),
        agg("bn_prologue", "mxnet_tpu_torch/kernels/bn_prologue_triton.py",
            "mxnet_tpu/ops/pallas_fused.py:250 (_make_prologue_kernel; "
            "pallas_call :390)", "triton", "bn_act_prologue"),
    ], "card": smi, "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
