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
5. training kernels: K3 (the fused BN-apply+ReLU+matrix product) forward
   and gradient, bf16 and fp32, at the bench tool's default shape and at
   ResNet-50's 1x1 shapes in NHWC at batch 128, plus ragged shapes; B1
   and B2 (the BN backward's reduction and dx assembly) at every
   distinct training-site shape of the batch-128 step, in both layouts;
   each against its plain version, with times beside the plain
   version's, a library call's and the bound.
6. the bn_relu_matmul path: K3 forward and backward at the default
   shape, with its launch counts.
7. training: ResNet-50 (``stem="s2d"``, bf16, batch 128, SGD) through
   the port's ``Module``: a one-step check of the fused fp32 step's
   gradients and moving statistics against the fp32 plain graph, and of
   the fused bf16 step's loss, head gradients (against the fp32 plain
   graph) and moving statistics (against the plain bf16 graph), limits
   from the plain graphs' readings; a fault probe for each (B2 in the
   fp32 backward, K1 in the bf16 forward) that the checks must reject;
   then 3 warm-up and 20 timed steps over 4 staged batches with the
   launches per step of every kernel, memory and each step's loss.
8. the kernels line, then the result line.
"""
import gc
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
# Training at batch 128: one step's gradients and new moving statistics
# of the fused step against the fp32 plain graph's (no rewrite, no
# kernel), as relative L2 errors: over all gradients as one vector, per
# parameter (median, worst), and of the moving statistics. fp32
# readings on an H100 (PERF.md): the fused fp32 step 0.0112 / 0.0107 /
# 0.0194 / 3.2e-7 (ReLU and max-pool masks that flip where fp32 sums
# round differently). fp32 limits: about 3x (all, median), 5x (worst)
# and 30x (moving statistics) the fused fp32 reading; the fault probe's
# worst parameter read 0.79.
FP32_TRAIN_LIMITS = {"grad_rel_err_all": 0.03, "grad_rel_err_median": 0.03,
                     "grad_rel_err_worst": 0.1, "aux_rel_err_worst": 1e-5}
# bf16: at random init the one-step gradients below the head are
# rounding noise. Readings on an H100 (PERF.md), relative L2 error of
# each gradient: the plain bf16 graph (no kernel) against the fp32 one
# 0.002 (fc1_bias), 0.10-0.11 (fc1_weight, bn1_gamma, bn1_beta), then
# 0.79 at the first parameter behind bn1's backward
# (stage4_unit3_conv3_weight) and about 1 further down; two bf16
# implementations, the fused step and the plain bf16 graph, differ from
# each other as much (0.60 at stage4_unit3_conv3_weight). So the bf16
# step is held where a bf16 result is above that noise: the loss and
# the head's gradients against the fp32 plain graph (limits about 2.5x
# the plain bf16 graph's reading), and every BatchNorm's new moving
# statistics (the forward's batch statistics, site by site) against
# the plain bf16 graph's (read 0.0059 at worst; limit 5x). The bf16
# backward kernels are held against their plain versions in phase 5,
# and the same kernel sources in fp32 by the fp32 step check above.
HEAD_PARAMS = ("fc1_bias", "fc1_weight", "bn1_gamma", "bn1_beta",
               "stage4_unit3_conv3_weight", "stage4_unit3_bn3_gamma",
               "stage4_unit3_bn3_beta", "stage4_unit3_conv2_weight")
BF16_TRAIN_LIMITS = {"loss_rel_err": 0.01,
                     "grad_rel_err_head": {"fc1_bias": 0.005,
                                           "fc1_weight": 0.25,
                                           "bn1_gamma": 0.25,
                                           "bn1_beta": 0.25}}
BF16_VS_PLAIN_BF16_LIMITS = {"aux_rel_err_worst": 0.03}
# The B2 call of a training backward that the fp32 fault probe breaks
# (c0 dropped), counted from the start of the backward; the bf16 probe
# breaks K1 call FAULT_SITE of the forward, as the serving probe does
FAULT_B2_CALL = 1
TRAIN_BATCH = 128


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


def site_shapes(mt, sym, batch, mode="serving"):
    """{(op, data shape, weight shape, relu): count} over the fused
    sites of the ``mode`` graph at ``batch``."""
    from mxnet_tpu_torch.symbol import passes
    import torch
    a, _, x = sym.infer_shape(data=(batch, 3, 224, 224))
    shapes = dict(zip(sym.list_arguments(), a))
    shapes.update(zip(sym.list_auxiliary_states(), x))
    fused, _ = passes.apply_pipeline(sym, shapes, tag="chip_smoke",
                                     mode=mode,
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


def rel_l2(a, b):
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def k3_case(mt, torch, gen, m, k, n, relu, dtype, timed=True):
    """K3 at one shape: forward against the fp32 plain version and the
    gradients of ``bn_relu_matmul`` (K3, K2, B1, B2 and torch.matmul)
    against fp32 autograd of the plain expression, times."""
    fb = mt.ops.fused_bn_conv
    dt = getattr(torch, dtype)
    dev = "cuda"
    x = torch.randn(m, k, generator=gen, device=dev).to(dt)
    w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(dt)
    sc = (0.5 + torch.rand(k, generator=gen, device=dev)).to(dt)
    sh = (0.2 * torch.randn(k, generator=gen, device=dev)).to(dt)
    out = fb.bn_relu_matmul_fwd(x, w, sc, sh, relu)
    torch.cuda.synchronize()
    ref = fb.bn_relu_matmul_fwd_plain(x.float(), w.float(), sc.float(),
                                      sh.float(), relu)
    err = (out.float() - ref).abs()
    scale = ref.abs().max().item()
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    ok = bool((err <= tol * scale + tol * ref.abs()).all())
    # gradients under one random cotangent
    cot = torch.randn(m, n, generator=gen, device=dev)
    ins = [t.clone().requires_grad_() for t in (x, w, sc, sh)]
    # whole-dimension tiles: the TPU tile rule takes any M, N that way
    got = torch.autograd.grad(fb.bn_relu_matmul(*ins, bm=m, bn=n,
                                                relu=relu), ins, cot.to(dt))
    rin = [t.float().requires_grad_() for t in (x, w, sc, sh)]
    z = rin[0] * rin[2] + rin[3]
    want = torch.autograd.grad((torch.relu(z) if relu else z) @ rin[1],
                               rin, cot)
    gerr = {nm: rel_l2(g.float(), wv) for nm, g, wv in
            zip(("x", "w", "scale", "shift"), got, want)}
    # fp32: the kernel path takes the ReLU mask from K2's xhat, the
    # reference from its own z; where z rounds to either side of 0 the
    # two masks differ, and one such element moves dx's relative L2 error
    # by about 1/sqrt(M*K) (4e-4 measured at (25088, 256, 1024))
    gtol = 2e-2 if dtype == "bfloat16" else 2e-3
    ok = ok and max(gerr.values()) <= gtol
    row = {"phase": "kernel", "kernel": "bn_relu_matmul", "dtype": dtype,
           "M": m, "K": k, "N": n, "relu": relu,
           "max_abs_err": err.max().item(), "out_scale": scale,
           "grad_rel_l2_err": gerr,
           "tolerance": f"|err| <= {tol}*max|ref| + {tol}*|ref| (ref: "
                        "plain version in fp32 on the same inputs); each "
                        f"gradient's relative L2 error <= {gtol} against "
                        "fp32 autograd of the plain expression",
           "ok": ok}
    if timed:
        e = torch.finfo(dt).bits // 8
        row["bound_ms"], row["bound_by"] = bound_ms(
            (m * k + k * n + 2 * k + m * n) * e, 2 * m * n * k, dtype)
        row["ms"] = time_ms(lambda: fb.bn_relu_matmul_fwd(x, w, sc, sh,
                                                          relu))
        row["plain_ms"] = time_ms(lambda: fb.bn_relu_matmul_fwd_plain(
            x, w, sc, sh, relu))
        xhat = fb.bn_relu_matmul_fwd_plain(
            x, torch.eye(k, device=dev, dtype=dt), sc, sh, relu)
        row["library_ms"] = time_ms(lambda: torch.matmul(xhat, w))
        row["library_call"] = "torch.matmul on the normalised input"
    emit(row)
    check(ok, f"K3 disagrees with its plain version: {row}")
    return row


def b12_case(mt, torch, gen, shape, relu, dtype, timed=True):
    """B1 and B2 at one shape (NCHW, or (M, K) for the NHWC layout):
    each against its plain version on the same inputs, times."""
    fb = mt.ops.fused_bn_conv
    dt = getattr(torch, dtype)
    dev = "cuda"
    dy, x, xh = (torch.randn(shape, generator=gen, device=dev).to(dt)
                 for _ in range(3))
    mask = xh if relu else None
    c = shape[1]
    sc, cx, c0 = (torch.randn(c, generator=gen, device=dev)
                  for _ in range(3))
    s = fb.bn_backward_reduce(dy, x, mask)
    dx = fb.bn_backward_dx(dy, x, mask, sc, cx, c0)
    torch.cuda.synchronize()
    s_ref = fb.bn_backward_reduce_plain(dy, x, mask)
    dx_ref = fb.bn_backward_dx_plain(dy.float(), x.float(),
                                     None if mask is None else mask.float(),
                                     sc, cx, c0)
    b1_abs = (s - s_ref).abs().max().item()
    b1_err = b1_abs / s_ref.abs().max().item()
    d_err = (dx.float() - dx_ref).abs()
    d_scale = dx_ref.abs().max().item()
    btol = 1e-2 if dtype == "bfloat16" else 1e-6
    ok = b1_err <= 1e-5 and bool(
        (d_err <= btol * dx_ref.abs() + 1e-6 * d_scale).all())
    row = {"phase": "kernel", "kernel": "bn_backward", "dtype": dtype,
           "shape": list(shape), "relu": relu, "b1_max_abs_err": b1_abs,
           "b1_rel_err": b1_err,
           "b2_max_abs_err": d_err.max().item(), "b2_scale": d_scale,
           "tolerance": "B1: max|err| <= 1e-5*max|ref| (fp32 sums, other "
                        f"order); B2: |err| <= {btol}*|ref| + "
                        "1e-6*max|ref| (one rounding to the output type)",
           "ok": ok}
    if timed:
        e = torch.finfo(dt).bits // 8
        n = dy.numel()
        n_in = 3 if relu else 2
        row["b1_bound_ms"], row["b1_bound_by"] = bound_ms(
            n_in * n * e + 8 * c, 4 * n, "float32")
        row["b2_bound_ms"], row["b2_bound_by"] = bound_ms(
            (n_in + 1) * n * e + 12 * c, 4 * n, "float32")
        row["b1_ms"] = time_ms(lambda: fb.bn_backward_reduce(dy, x, mask))
        row["b2_ms"] = time_ms(lambda: fb.bn_backward_dx(dy, x, mask, sc,
                                                         cx, c0))
        row["b1_plain_ms"] = time_ms(lambda: fb.bn_backward_reduce_plain(
            dy, x, mask))
        row["b2_plain_ms"] = time_ms(lambda: fb.bn_backward_dx_plain(
            dy, x, mask, sc, cx, c0))
        mean = torch.zeros(c, device=dev)
        invstd = torch.ones(c, device=dev)
        row["library_ms"] = time_ms(
            lambda: torch.ops.aten.native_batch_norm_backward(
                dy, x, sc, None, None, mean, invstd, True, 1e-5,
                [True, True, True]))
        row["library_call"] = ("aten.native_batch_norm_backward (B1 and "
                               "B2 together)")
    emit(row)
    check(ok, f"B1/B2 disagree with their plain versions: {row}")
    return row


def train_kernel_phase(mt, torch, gen):
    """Phase 5: K3, B1 and B2 against their plain versions at the
    training shapes; per-step sums over the sites of K1, K2, B1, B2."""
    from mxnet_tpu_torch.model_zoo.symbols import resnet
    fb = mt.ops.fused_bn_conv
    sym = resnet.get_symbol(1000, 50, "3,224,224", stem="s2d")
    sites = site_shapes(mt, sym, TRAIN_BATCH, mode="train")
    n_k1 = sum(c for (op, *_), c in sites.items()
               if op == "_FusedBNReLUConv")
    n_k = sum(c for (op, *_), c in sites.items()
              if op == "_FusedBNReLUConvK")
    check(n_k1 == 28 and n_k == 16, f"train-mode sites {n_k1}, {n_k}")
    import torch.nn.functional as F
    per_step = {"K1": [], "K2": [], "B1": [], "B2": []}
    k3_rows = []
    # K1 (training forward) and K2 (forward of the K sites, recompute in
    # every site's backward) at the batch-128 site shapes
    k2_calls = {}
    for (op, d, w, relu), count in sorted(sites.items()):
        b, c, h, wd = d
        if op == "_FusedBNReLUConv":
            row = k1_case(mt, torch, F, gen, b, c, h, wd, w[0], relu,
                          "bfloat16")
            per_step["K1"].append((count, row["ms"], row["plain_ms"],
                                   row["bound_ms"], row["library_ms"],
                                   row["max_abs_err"]))
            # the same 1x1 conv as K3's (M, K) @ (K, N) in NHWC
            k3_rows.append((b * h * wd, c, w[0], relu))
        fwd = 1 if op == "_FusedBNReLUConvK" else 0
        key = (d, relu)
        k2_calls[key] = k2_calls.get(key, 0) + count * (fwd + 1)
    for (d, relu), count in sorted(k2_calls.items()):
        row = k2_case(mt, torch, F, gen, *d, relu, "bfloat16")
        per_step["K2"].append((count, row["ms"], row["plain_ms"],
                               row["bound_ms"], row["library_ms"],
                               row["max_abs_err"]))
    b_calls = {}
    for (op, d, w, relu), count in sites.items():
        b_calls[(d, relu)] = b_calls.get((d, relu), 0) + count
    for (d, relu), count in sorted(b_calls.items()):
        for dtype in ("bfloat16", "float32"):
            row = b12_case(mt, torch, gen, d, relu, dtype,
                           timed=dtype == "bfloat16")
            if dtype == "bfloat16":
                per_step["B1"].append((count, row["b1_ms"],
                                       row["b1_plain_ms"],
                                       row["b1_bound_ms"],
                                       row["library_ms"],
                                       row["b1_max_abs_err"]))
                per_step["B2"].append((count, row["b2_ms"],
                                       row["b2_plain_ms"],
                                       row["b2_bound_ms"], None,
                                       row["b2_max_abs_err"]))
    # the NHWC layout: the 1x1 sites as (M, K) matrices, and ragged
    for m, k, _, relu in sorted(set(k3_rows)):
        b12_case(mt, torch, gen, (m, k), relu, "bfloat16", timed=False)
    for shape in ((37, 33), (1000, 24), (3, 5, 7, 7)):
        for dtype in ("bfloat16", "float32"):
            b12_case(mt, torch, gen, shape, True, dtype, timed=False)
            b12_case(mt, torch, gen, shape, False, dtype, timed=False)
    # K3 at the default shape of tools/pallas_fused_bn_bench.py, at the
    # 1x1 sites in NHWC, and ragged
    k3_default = {}
    for dtype in ("bfloat16", "float32"):
        k3_default[dtype] = k3_case(mt, torch, gen, 401408, 64, 256, True,
                                    dtype)
    for m, k, n, relu in sorted(set(k3_rows)):
        k3_case(mt, torch, gen, m, k, n, relu, "bfloat16")
        k3_case(mt, torch, gen, m, k, n, relu, "float32", timed=False)
    for m, k, n in ((5, 3, 7), (130, 33, 65), (1000, 24, 40),
                    (257, 63, 255)):
        for dtype in ("bfloat16", "float32"):
            for relu in (True, False):
                k3_case(mt, torch, gen, m, k, n, relu, dtype, timed=False)
    try:
        fb.bn_relu_matmul_fwd(*(torch.zeros(s, device="cuda",
                                            dtype=torch.float16)
                                for s in ((8, 8), (8, 8), (8,), (8,))))
        raise AssertionError("K3 accepted float16 on CUDA")
    except mt.MXNetError as e:
        emit({"phase": "kernel", "k3_raises_on_unsupported_dtype": str(e)})
    return per_step, k3_default


def k3_path(mt, torch, gen, steps=3):
    """Phase 6: bn_relu_matmul forward + backward at the default shape
    (bf16), launches read from the counters around the run."""
    fb = mt.ops.fused_bn_conv
    dt = torch.bfloat16
    m, k, n = 401408, 64, 256
    ins = [torch.randn(m, k, generator=gen, device="cuda").to(dt),
           (torch.randn(k, n, generator=gen, device="cuda") / 8).to(dt),
           (0.5 + torch.rand(k, generator=gen, device="cuda")).to(dt),
           (0.2 * torch.randn(k, generator=gen, device="cuda")).to(dt)]
    ins = [t.requires_grad_() for t in ins]
    cot = torch.randn(m, n, generator=gen, device="cuda").to(dt)
    torch.cuda.synchronize()
    fb.reset_launch_counts()
    for _ in range(steps):
        out = fb.bn_relu_matmul(*ins)
        grads = torch.autograd.grad(out, ins, cot)
    torch.cuda.synchronize()
    launches = fb.launch_counts()
    ok = all(bool(torch.isfinite(g.float()).all()) for g in grads)
    emit({"phase": "bn_relu_matmul_path", "M": m, "K": k, "N": n,
          "calls": steps, "launches": launches, "finite": ok})
    check(ok and launches["bn_relu_matmul_fwd"] == steps
          and launches["bn_act_prologue"] == steps
          and launches["bn_backward_reduce"] == steps
          and launches["bn_backward_dx"] == steps
          and launches["bn_relu_conv_nchw"] == 0,
          f"bn_relu_matmul path launches {launches}")
    return launches


def grad_check_summary(loss, grads, aux, ref):
    """The training check's numbers against a reference step's ``ref``
    = (loss, grads, aux_updates): relative error of the loss,
    relative L2 error of each parameter's gradient (worst, 90th
    percentile, median, and those of ``HEAD_PARAMS``), of all the
    gradients as one vector, and of the new moving statistics (worst,
    and all of them as one vector)."""
    import torch
    errs = {n: rel_l2(grads[n].float(), ref[1][n].float()) for n in ref[1]}
    order = sorted(errs, key=errs.get)

    def whole(a, b):
        names = sorted(b)
        return rel_l2(torch.cat([a[n].float().reshape(-1) for n in names]),
                      torch.cat([b[n].float().reshape(-1) for n in names]))

    aux_err = {n: rel_l2(aux[n].float(), ref[2][n].float()) for n in ref[2]}
    aux_worst = max(aux_err, key=aux_err.get)
    return {"loss": float(loss), "loss_ref": float(ref[0]),
            "loss_rel_err": abs(float(loss) - float(ref[0]))
            / abs(float(ref[0])),
            "grad_rel_err_worst": errs[order[-1]],
            "grad_worst_param": order[-1],
            "grad_rel_err_p90": errs[order[int(0.9 * (len(order) - 1))]],
            "grad_rel_err_median": errs[order[len(order) // 2]],
            "grad_rel_err_all": whole(grads, ref[1]),
            "grad_rel_err_head": {n: errs[n] for n in HEAD_PARAMS},
            "aux_rel_err_worst": aux_err[aux_worst],
            "aux_worst": aux_worst,
            "aux_rel_err_all": whole(aux, ref[2])}


def training_failures(s, limits):
    """The limits of ``limits`` ({summary key: max}, or for
    "grad_rel_err_head" {parameter: max}) that ``s`` breaks."""
    fails = []
    for k, lim in limits.items():
        if isinstance(lim, dict):
            fails += [f"{n} {s[k][n]} > {v}" for n, v in lim.items()
                      if s[k][n] > v]
        elif s[k] > lim:
            fails.append(f"{k} {s[k]} > {lim}")
    return fails


def training_phase(mt, torch, np, smi):
    """Phase 7: the training path through the port's Module."""
    from mxnet_tpu_torch import config, profile_training as pt
    fb = mt.ops.fused_bn_conv
    batch = TRAIN_BATCH
    t0 = time.perf_counter()
    batches = pt.staged_batches(batch, 4, SEED)
    feed = {"data": batches[0].data[0], "softmax_label":
            batches[0].label[0]}

    def one_step_grads(module):
        """(loss, grads, aux updates, {max_memory_allocated, its part
        above the step's start, and the bytes the forward saved for the
        backward, in GB})."""
        saved = {}

        def pack(t):
            st = t.untyped_storage()
            saved[st.data_ptr()] = st.nbytes()
            return t

        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, grads, aux, _ = module._fused.gradients(feed)
        torch.cuda.synchronize()
        return loss, grads, aux, {
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9,
            "peak_above_start_gb": (torch.cuda.max_memory_allocated()
                                    - base) / 1e9,
            "saved_for_backward_gb": sum(saved.values()) / 1e9}

    # the fp32 and the bf16 plain graph (no rewrite, no kernel), from the
    # same initial params as the fused Modules
    with config.override("MXTPU_PALLAS_FUSION", "0"), \
            config.override("MXTPU_PASS_RESIDUAL_FUSION", "0"):
        fb.reset_launch_counts()
        ref_mod = pt.build_module(batch, SEED, compute_dtype=None)
        check(all(e["status"] == "disabled" for e in
                  ref_mod.pass_report["passes"]), "reference rewritten")
        ref = one_step_grads(ref_mod)
        del ref_mod
        p16_mod = pt.build_module(batch, SEED)
        p16 = one_step_grads(p16_mod)
        del p16_mod
        check(sum(fb.launch_counts().values()) == 0,
              "the plain graphs hit a kernel")
    f32_mod = pt.build_module(batch, SEED, compute_dtype=None)
    model = pt.build_module(batch, SEED)
    for m in (f32_mod, model):
        sites = {e["pass"]: len(e["sites"])
                 for e in m.pass_report["passes"]}
        check(sites["pallas_fusion"] == 28
              and sites["residual_fusion"] == 16,
              f"train-mode pass sites {sites}")
    f32 = one_step_grads(f32_mod)
    f16 = one_step_grads(model)
    summ = {"fused_fp32": grad_check_summary(*f32[:3], ref[:3]),
            "fused_bf16": grad_check_summary(*f16[:3], ref[:3]),
            "plain_bf16": grad_check_summary(*p16[:3], ref[:3]),
            "fused_bf16_vs_plain_bf16": grad_check_summary(*f16[:3],
                                                           p16[:3])}

    # fault probes: B2 without its c0 term at one call of the fp32
    # step's backward; K1 without its first 32 input channels at one
    # call of the bf16 step's forward
    real_dx, real_k1 = fb.bn_backward_dx, fb.bn_relu_conv_nchw
    calls = [0]

    def faulty_dx(dy, x, xhat, scale, cx=None, c0=None):
        calls[0] += 1
        if calls[0] == FAULT_B2_CALL and c0 is not None:
            c0 = torch.zeros_like(c0)
        return real_dx(dy, x, xhat, scale, cx, c0)

    def faulty_k1(x, w, scale, shift, relu=True):
        calls[0] += 1
        if calls[0] == FAULT_SITE:
            w = w.clone()
            w[:, :32] = 0
        return real_k1(x, w, scale, shift, relu)

    faulty_dx.launches = faulty_k1.launches = 0
    try:
        fb.bn_backward_dx = faulty_dx
        probe32 = one_step_grads(f32_mod)
        fb.bn_backward_dx = real_dx
        calls[0] = 0
        fb.bn_relu_conv_nchw = faulty_k1
        probe16 = one_step_grads(model)
    finally:
        fb.bn_backward_dx, fb.bn_relu_conv_nchw = real_dx, real_k1
    probe = {"fused_fp32": grad_check_summary(*probe32[:3], ref[:3]),
             "fused_bf16": grad_check_summary(*probe16[:3], ref[:3]),
             "fused_bf16_vs_plain_bf16": grad_check_summary(*probe16[:3],
                                                            p16[:3])}
    limits = {"fused_fp32": FP32_TRAIN_LIMITS,
              "fused_bf16": BF16_TRAIN_LIMITS,
              "plain_bf16": BF16_TRAIN_LIMITS,
              "fused_bf16_vs_plain_bf16": BF16_VS_PLAIN_BF16_LIMITS}
    fails = {k: training_failures(summ[k], lim) for k, lim in limits.items()}
    rejected = {k: training_failures(probe[k], limits[k]) for k in probe}
    emit({"phase": "training_grad_check", "batch": batch,
          "against": "the fp32 plain graph (no rewrite, no kernel), same "
                     "params and batch; fused_bf16_vs_plain_bf16: the "
                     "fused bf16 step against the plain bf16 graph",
          **summ,
          "one_step_memory": {
              "plain_fp32": ref[3], "plain_bf16": p16[3],
              "fused_fp32": f32[3], "fused_bf16": f16[3]},
          "limits": limits, "failures": fails})
    emit({"phase": "training_fault_probe",
          "fault": {"fused_fp32": f"B2 call {FAULT_B2_CALL} of the "
                                  "backward with c0 = 0",
                    "fused_bf16": f"K1 call {FAULT_SITE} of 28 in the "
                                  "forward without its first 32 input "
                                  "channels"},
          "rejected_by": rejected, **probe})
    check(not any(fails.values()), f"training step checks: {fails}")
    check(rejected["fused_fp32"],
          f"the fp32 training check passes a planted fault: {rejected}")
    check(rejected["fused_bf16"] or rejected["fused_bf16_vs_plain_bf16"],
          f"the bf16 training checks pass a planted fault: {rejected}")
    del ref, f32_mod, probe32, probe16
    gc.collect()
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated() / 1e9

    # speed: 3 warm-up steps, then 20 over 4 staged batches
    for i in range(3):
        pt.run_step(model, batches[i % 4])
    torch.cuda.synchronize()
    n_steps = 20
    fb.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t1 = time.perf_counter()
    for i in range(n_steps):
        pt.run_step(model, batches[i % 4])
        losses.append(model._fused.last_loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = fb.launch_counts()
    losses = [float(v) for v in losses]
    emit({"phase": "training_speed", "batch": batch, "steps": n_steps,
          "img_per_s": n_steps * batch / dt, "ms_per_step": dt / n_steps
          * 1e3, "launches": launches,
          "launches_per_step": {k: v / n_steps for k, v in launches.items()},
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
          / 1e9, "memory_allocated_before_gb": allocated_before,
          "one_step_memory": {"fused_bf16": f16[3], "plain_bf16": p16[3]},
          "losses": losses, "setup_s": t1 - t0, "card": smi})
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(launches["bn_relu_conv_nchw"] == 28 * n_steps
          and launches["bn_act_prologue"] == 60 * n_steps
          and launches["bn_backward_reduce"] == 44 * n_steps
          and launches["bn_backward_dx"] == 44 * n_steps
          and launches["bn_relu_matmul_fwd"] == 0,
          f"training launches {launches} over {n_steps} steps")
    return launches, n_steps


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

    # 5.-7. training -----------------------------------------------------------
    per_step, k3_default = train_kernel_phase(mt, torch, gen)
    k3_launches = k3_path(mt, torch, gen)
    train_launches, n_steps = training_phase(mt, torch, np, smi)

    # 8. the kernels line, then the result ------------------------------------
    def serving_agg(name):
        rows = per_fwd[name].values()
        return {"ms_per_forward": sum(c * r["ms"] for c, r in rows),
                "plain_ms_per_forward": sum(c * r["plain_ms"]
                                            for c, r in rows),
                "bound_ms_per_forward": sum(c * r["bound_ms"]
                                            for c, r in rows),
                "library_ms_per_forward": sum(c * r["library_ms"]
                                              for c, r in rows),
                "max_abs_err": max(r["max_abs_err"] for _, r in rows),
                "launches": launches, "bucket_calls": n_calls,
                "per": "one ResNet-50 forward at batch 64 (sum over "
                       "sites)"}

    def train_agg(key, name, source, replaces, route, launch_key, extra):
        rows = per_step[key]
        # rows: (calls per step, ms, plain ms, bound ms, library ms, err)
        lib = [row[0] * row[4] for row in rows] \
            if all(row[4] is not None for row in rows) else None
        return dict({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": train_launches[launch_key],
            "launches_per_step": train_launches[launch_key] / n_steps,
            "max_abs_err": max(row[5] for row in rows),
            "ms": sum(row[0] * row[1] for row in rows),
            "plain_ms": sum(row[0] * row[2] for row in rows),
            "bound_ms": sum(row[0] * row[3] for row in rows),
            "bound_by": "bytes",
            "library_ms": sum(lib) if lib is not None else None,
            "dtype": "bfloat16", "batch": TRAIN_BATCH,
            "per": "one ResNet-50 training step at batch 128 (sum over "
                   "the step's calls)", "status": "ok"}, **extra)

    pf = "mxnet_tpu/ops/pallas_fused.py"
    k3 = k3_default["bfloat16"]
    emit({"kernels": [
        train_agg("K1", "bn_relu_conv1x1",
                  "mxnet_tpu_torch/kernels/csrc/bn_relu_conv1x1.cu",
                  f"{pf}:234 (_make_nchw_kernel; pallas_call :420)", "cuda",
                  "bn_relu_conv_nchw",
                  {"serving": serving_agg("bn_relu_conv1x1")}),
        train_agg("K2", "bn_prologue",
                  "mxnet_tpu_torch/kernels/bn_prologue_triton.py",
                  f"{pf}:250 (_make_prologue_kernel; pallas_call :390)",
                  "triton", "bn_act_prologue",
                  {"serving": serving_agg("bn_prologue")}),
        {"name": "bn_relu_matmul", "route": "cuda",
         "source": "mxnet_tpu_torch/kernels/csrc/bn_relu_matmul.cu",
         "replaces": f"{pf}:219 (_make_kernel; pallas_call :280 in "
                     "_fused_matmul, public bn_relu_matmul :316)",
         "launches": k3_launches["bn_relu_matmul_fwd"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "dtype": "bfloat16", "shape": [k3["M"], k3["K"], k3["N"]],
         "per": "one call at the bench tool's default shape",
         "path": "bn_relu_matmul forward + backward", "status": "ok",
         "fp32": {"ms": k3_default["float32"]["ms"],
                  "bound_ms": k3_default["float32"]["bound_ms"]}},
        train_agg("B1", "bn_backward_reduce",
                  "mxnet_tpu_torch/kernels/bn_backward_triton.py",
                  f"{pf}:498 and :604 (the analytic fused BN backwards' "
                  "reduction, jnp there; under the K1/K2 sites' custom "
                  "VJPs, and _fused_matmul's f_bwd :299)", "triton",
                  "bn_backward_reduce",
                  {"library_covers": "B1 and B2 together"}),
        train_agg("B2", "bn_backward_dx",
                  "mxnet_tpu_torch/kernels/bn_backward_triton.py",
                  f"{pf}:529-537 (dx assembly of the fused BN backwards, "
                  "jnp there)", "triton", "bn_backward_dx", {}),
    ], "card": smi, "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
