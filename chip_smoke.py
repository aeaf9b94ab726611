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
   plus ragged edge shapes. Each K1 / K3 row names the route its plan
   took (``route_counts``): the bf16 site shapes must take the wgmma
   core (``wgmma_tma`` or ``wgmma_bulk``), the ragged and misaligned
   shapes the WMMA kernel, except ``K1_WGMMA_RAGGED``'s, which take the
   route each names. A timed wgmma row also times the first (WMMA)
   kernel it replaced on the same inputs (``wmma_ms``, checked against
   the same tolerance); ``k1_serving_sites`` sums up the per-site rows;
   ``k1_host_cost`` reads the host microseconds a K1 call costs.
3b. capture_smoke: one launch each of K1 (TMA and bulk routes), K2, B1
   and B2 captured in a CUDA graph through the compile registry,
   replayed twice and held bit for bit against the eager call; the
   launch counters count the replays and not the capture. Then a K2
   capture (``thread_local``, as a Predictor bucket first seen on a
   batcher thread captures) during which another thread launches K2 on
   its own stream: that launch counts once, the capture's at each
   replay.
4. serving: ResNet-50 (random weights from seed 0) behind a bf16
   ``Predictor`` and a ``DynamicBatcher`` on ``cuda:0``, every bucket
   captured as a CUDA graph at warm-up; concurrent requests of 1, 5, 37
   and 64 rows; launch counts per bucket call (counted from replays)
   and the compile registry's delta (replays only: no capture, no
   retrace after warm-up); top-1 agreement (on the rows the fp32 graph
   decides by a margin) and logit error against the fp32 plain graph on
   the card, and a probe that plants a fault at one K1 site of a
   bucket captured with it and expects these checks to reject it; img/s
   and request latency. The 28 K1 launches of every bucket call must
   have taken the wgmma core. Then ``serving_captured_check`` (every
   bucket's replay, and a 5-row request in bucket 8, against the eager
   forward: bit-identical or within twice the spread of two eager runs)
   and ``serving_ab`` (runs of 20 bucket-64 requests, eager and
   captured interleaved: host ms median and spread, CUDA-event ms, the
   H2D / forward / D2H split, memory, busy share).
5. training kernels: K3 (the fused BN-apply+ReLU+matrix product) forward
   and gradient, bf16 and fp32, at the bench tool's default shape and at
   ResNet-50's 1x1 shapes in NHWC at batch 128, plus ragged shapes; B1
   and B2 (the BN backward's reduction and dx assembly) at every
   distinct training-site shape of the batch-128 step, in both layouts;
   each against its plain version, with times beside the plain
   version's, a library call's and the bound. ``k1_training_sites``
   lists K1's rows per distinct training site (sites per step, route,
   ms, ``wmma_ms``, bound, plain and ``F.conv2d`` ms) and their sums per
   step.
6. the bn_relu_matmul path: K3 forward and backward at the default
   shape, with its launch counts and routes.
7. training: ResNet-50 (``stem="s2d"``, bf16, batch 128, SGD) through
   the port's ``Module``: a one-step check of the fused fp32 step's
   gradients and moving statistics against the fp32 plain graph, and of
   the fused bf16 step's loss, head gradients (against the fp32 plain
   graph) and moving statistics (against the plain bf16 graph), limits
   from the plain graphs' readings; a fault probe for each (B2 in the
   fp32 backward, K1 in the bf16 forward) that the checks must reject;
   then 3 warm-up steps (the first eager, the second captures the step
   as a CUDA graph) and 20 timed replays over 4 staged batches with the
   launches per step of every kernel (K1's 28 on the wgmma core, counted
   from replays), memory and each step's loss. Then
   ``training_captured_check`` (three eager steps against three
   replays from the same init at lr 0.1, 0.05, 0.025: losses, weights,
   momenta, aux, bit-identical or within twice the spread of two eager
   runs; a replay whose lr write is skipped and one whose batch-2 input
   copy is skipped must fail it), ``training_ab`` (runs of 20 steps,
   eager and captured interleaved, as ``serving_ab``) and the
   ``compile_report`` line (programs, captures, replays, retraces, the
   cache as not applicable).
7b. fit (``bench.py`` phase A2): the phase-7 configuration through
   ``Module.fit`` for 2 epochs of 40 batches (the 4 staged batches
   cycled by ``io.ResizeIter``) with ``CompositeEvalMetric([Accuracy(),
   TopKAccuracy(top_k=5)])`` counted inside the captured step and a
   ``Speedometer(128, 20)``: epoch-1 img/s and ms a step against phase
   7's captured median, the compile registry's delta (one capture and
   one retrace naming ``extra.metrics`` for the metric attach),
   K1/K2/B1/B2 launches a step from the replays (counts zeroed just
   before the fit), every step between two metric reads run under
   ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises), the
   counters held against the host path on the same outputs for 10 steps
   (accuracy exactly, top-5 within the rows tied at the 5th score), and
   the same fit with two host-path ``CustomMetric``s as the A/B.
7c. ft_guard (phase E, first half): guarded and unguarded captured
   steps interleaved (median, spread, overhead); a planted ``nan_grad``
   step that must leave params, momenta, aux and the metric counter
   bit-identical with no new capture, ``fault_report`` 1 / 1 then 1 / 0;
   its probe, a guard captured with its select bypassed, must fail; and
   ``MXTPU_FT_MAX_CONSEC_SKIPS=2`` with three poisoned steps must raise
   within 2K steps.
7d. checkpoint (phase E, second half): ``CheckpointManager`` sync save
   seconds and size, async submit and total seconds (3 steps run while
   the files land; the async snapshot must equal the sync one); a fresh
   Module restored from the checkpoint runs 3 steps that must be
   bit-identical to the uninterrupted module's (a restore without the
   momenta must fail); a truncated newest checkpoint falls back to the
   previous one.
8. rtc_build: the user's CUDA C++ kernels (K4, the user-kernel hook)
   compiled at run time through ``rtc.CudaModule``, with the ptxas
   report; the user's Triton kernel is compiled at its first launch.
9. K4 kernels: ``double``, ``scale3`` (CUDA and Triton) and the
   softmax cross-entropy forward and backward, each launched through
   ``operator.UserKernel`` and held against its plain version at the
   path's shapes and at a large shape, with times beside the plain
   version's, a library call's and the bound; then the same kernels
   through ``nd.<name>`` and ``autograd.record()`` / ``backward()``.
10. gluon_forward: the Gluon ResNet-50 v1 of ``__graft_entry__.entry()``
   (Xavier init from seed 0, hybridized) at batch 8 on the card, against
   the port's forward of the same weights on the CPU.
11. gluon_train_check: one training step at batch 64 whose loss is the
   user's softmax cross-entropy through K4, against the same step with
   ``gluon.loss.SoftmaxCrossEntropyLoss``: the loss, the logits'
   gradient and every parameter's gradient; a fault probe (the kernels'
   sums skip the last column) must fail the check.
12. gluon_trainer_check: two ``Trainer.step(64)`` with the K4 loss,
   every parameter and its momentum against the plain SGD rule (fp64,
   momentum carried by the rule) applied to the same gradients; two
   fault probes (a Trainer whose momentum was not carried over, one
   whose wd was dropped) must fail it.
13. gluon_train_speed: warm-up steps (the two checked ones included),
   then 10 timed steps of ``autograd.record()`` / ``backward()`` /
   ``Trainer.step(64)`` over one repeated batch, with the K4 loss: img/s,
   ms per step, memory, the losses (they must fall: the last below the
   first, all below the initial loss) and K4's launches per step (the
   loss's forward and backward).
14. decode_kernel: D1 (the decode-attention kernel, CUDA C++:
   ``kernels/csrc/decode_attention.cu``) at GPT-2 small's decode shapes
   (16 lanes, 12 heads of 64, max_seq 1024), f32 and int8 cache, W = 1
   (decode) and W = 5 (verify), at three position sets (``mixed``, with
   inactive lanes; ``serving_512``, decode_serving's step; ``one_long``,
   one lane at 1023): errors against the plain version (``D1_TOL``) and
   against ``decode_attention_split_plain``, the kernel's own chunk
   order (``D1_SPLIT_TOL``), two calls bit for bit, a lane alone bit for
   bit as in the batch; ms timed cold (the calls rotate over at least 12
   cache buffers, more where 12 would leave the rows in L2) beside the
   first, Triton form's (``kernels/decode_attention_triton.py``, the
   yardstick, reached by no path of the package), the plain version's,
   ``F.scaled_dot_product_attention``'s on the same cache and mask (f32;
   a yardstick the port never calls) and the bound of the rows the
   positions need; the warm ms (one buffer back to back) of D1 and the
   Triton form; the cold ms at R = 32, 64 and 128 rows a chunk. Then
   ``decode_kernel_contract``: every head_dim and R template, W up to
   16, ragged max_seq, against both plain versions.
15. decode_serving: ``DecodePredictor`` + ``DecodeBatcher`` at GPT-2
   small's widths (random weights from seed 0), slots 16, prompt buckets
   (64, 256, 1024), f32 then int8 cache: ``warmup()`` captures one
   program per bucket and the decode step, serving captures none;
   ``token_closed_loop`` at 1, 8 and 16 clients, 128 requests at each
   (``mixed_prompts``, seed 0, 16-512 tokens in equal shares, shuffled
   so every client draws from the whole mix; 64 new tokens): tokens/s,
   TTFT p50/p99 (also by prompt length),
   inter-token p99, D1 launches per decode step (== layers, counted
   from replays, counts set to 0 just before each run); the decode
   step's device ms (CUDA events over replays) and a 20-step decode
   loop's busy share; cache bytes, counted bytes per token against the
   cacheless re-prefill's, memory. Checks (prompts of 16, 60, 200 and
   600 tokens, so lanes span 1 to 10 of D1's 64-row chunks and every
   prefill bucket): 8 prompts batched equal to solo bit for bit, the
   captured decode step equal to the eager one bit for bit, and (f32) 4
   greedy streams equal to an f64 eager run of the plain functions on
   every step whose f64 top-2 gap exceeds 1e-3;
   int8's agreement with f32 is printed. A probe (D1 captured with its
   visible range one row too long) must fail these checks.
16. spec_decode: ``SpecDecodePredictor`` (a random 2-layer shrink-2
   draft, k = 4) streams bit for bit the plain ones; acceptance, the
   verify step's device ms, D1's W = 5 launches.
17. decode_disagg: a prefill-role batcher hands lanes to a decode-role
   one; streams equal the unified ones, and with every handoff lost
   (``kv_handoff``) the decode side re-prefills, no stream dropped.
17b. d1_step_ab: the captured f32 decode step (16 lanes at 512 and at
   1023) and verify step (at 512), with D1's launch swapped to the
   Triton form while they are captured, against the same programs on
   D1, in turns (Triton, D1, D1, Triton).
18. the kernels line (K1/K2/B1/B2 also with their ``fit`` launches, D1
   with its decode_serving launches), then the result line.

fp32 convolutions and matrix products run without TF32 throughout
(phase 1 turns it off), so the Gluon path's fp32 checks hold fp32.
"""
import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# The Gluon path (phases 10-12): the forward at batch 8 on the card
# against the CPU, max |error| over max |CPU logit|, fp32 without TF32
# (cuDNN and the CPU sum in other orders: expect ~1e-6). The training
# step at batch 64 with the K4 loss against SoftmaxCrossEntropyLoss, with
# deterministic cuDNN so both forwards are the same: the loss (max |err|
# over max |loss|), the logits' gradient and each parameter's gradient
# (relative L2; a parameter's floor is 1e-6 of the largest gradient's
# norm, for the conv biases in front of a BatchNorm, whose gradient is
# rounding noise about 0). Expected readings: ~1e-7 (the kernel's expf
# and its sum order against torch's); the fault probe (sums without the
# last of 1000 columns) moves the loss by about 1/1000 of a row's
# log-sum-exp scale, ~1.4e-4 relative.
GLUON_FWD_REL_LIMIT = 1e-4
GLUON_STEP_LIMITS = {"loss_rel_err": 1e-5, "logits_grad_rel_l2": 1e-5,
                     "param_grad_rel_l2_worst": 1e-4}
GLUON_BATCH = 64
GLUON_STEPS = 10
GLUON_HP = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# Trainer.step at batch 64 against the plain SGD rule in fp64 from the
# same weights and gradients, momentum carried by the rule itself:
# relative L2 per parameter of the new weights (fp32 storage rounds them
# by ~6e-8) and of the momenta (a few fp32 roundings of each term,
# ~1e-7). Dropping wd moves the weights by lr*wd = 1e-5 relative.
SGD_W_REL_LIMIT = 1e-6
SGD_MOM_REL_LIMIT = 1e-5
# warm-up steps before the timed ones (the 2 checked steps included): at
# lr 0.1 and momentum 0.9 from Xavier init, the loss on one batch of 64
# swings up to ~11 over the first ~12 steps and then falls step by step
# (three runs on an H100: 7.5, 5.5, 7.6 ... 10.8-11.8 ... then from
# step 13 on falling each step, to 1.7-2.7 at step 40)
GLUON_WARMUP = 15
NUM_CLASSES = 1000
LARGE_ELEMWISE = (64, 2048, 1024)
# K4's softmax CE against its plain version, logits 3*N(0,1) over 1000
# classes: losses of 5-15 within 1e-4 (1e-5 relative: expf and the sum
# order against torch's logsumexp); gradients (|g| <= |ct| ~ 3) within
# 4e-6
K4_CE_FWD_TOL = 1e-4
K4_CE_BWD_TOL = 4e-6
LARGE_CE_ROWS = 65536
# K1's and K3's routes on the wgmma core (ops/fused_bn_conv.py, KernelPlan)
WGMMA_ROUTES = ("wgmma_tma", "wgmma_bulk")
# ragged shapes the wgmma core takes, each with its route: together with
# ResNet-50's sites they launch every instantiation of the core. K1 (B,
# C, H, W, O): S at run time with several samples a tile (9, 16), a
# partial last sample tile and a partial output tile (7 samples of 25
# positions, 5 a tile; 264 outputs), 7x7 with fewer than 256 outputs,
# TMA with one partial position tile and with several (S = 400 over
# 128-row tiles). K3 (M, K, N): partial row and column tiles, both tile
# shapes.
K1_WGMMA_RAGGED = (((3, 64, 3, 3, 72), "wgmma_bulk"),
                   ((2, 64, 4, 4, 8), "wgmma_bulk"),
                   ((7, 128, 5, 5, 264), "wgmma_bulk"),
                   ((3, 64, 7, 7, 128), "wgmma_bulk"),
                   ((1, 64, 8, 12, 72), "wgmma_tma"),
                   ((2, 128, 20, 20, 264), "wgmma_tma"))
K3_WGMMA_RAGGED = ((1000, 64, 40), (257, 128, 72), (300, 128, 264))
K4_REPLACES = ("mxnet_tpu/operator.py:211-240 (PallasKernel._call_arrays; "
               "pallas_call :222), register_pallas :249-264, "
               "rtc.PallasModule mxnet_tpu/rtc.py:16-36")


# ---------------------------------------------------------------------------
# K4, the user-kernel hook: a user's own kernels. They belong to the
# user, not to the package, so they live here as the source strings a
# user would hand to rtc.CudaModule, each with its plain PyTorch version.
# NUM_CLASSES is compiled in (-DNUM_CLASSES=C): the hook's calling
# convention passes only the pointers and the output's element count.
# ---------------------------------------------------------------------------
USER_CUDA_SRC = r"""
#include <math.h>
#ifndef NUM_CLASSES
#define NUM_CLASSES 1000
#endif
#ifndef SKIP_LAST            // the fault probe: sums skip the last column
#define SKIP_LAST 0
#endif

extern "C" __global__ void double_kernel(const float* x, float* out,
                                         long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i] * 2.0f;
}

extern "C" __global__ void scale3_kernel(const float* x, float* out,
                                         long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i] * 3.0f;
}

__device__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// block-wide reductions (blockDim a multiple of 32, at most 1024):
// each warp reduces with shuffles, warp 0 reduces the warps' results
__device__ float block_max(float v) {
    __shared__ float sh[32];
    int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    v = warp_max(v);
    if (lane == 0) sh[w] = v;
    __syncthreads();
    if (w == 0) {
        v = lane < (int)(blockDim.x >> 5) ? sh[lane] : -INFINITY;
        v = warp_max(v);
        if (lane == 0) sh[0] = v;
    }
    __syncthreads();
    v = sh[0];
    __syncthreads();
    return v;
}

__device__ float block_sum(float v) {
    __shared__ float sh[32];
    int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) sh[w] = v;
    __syncthreads();
    if (w == 0) {
        v = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.0f;
        v = warp_sum(v);
        if (lane == 0) sh[0] = v;
    }
    __syncthreads();
    v = sh[0];
    __syncthreads();
    return v;
}

// the row's max and sum of exp(x - max), one block per row
__device__ void row_stats(const float* x, float* m_out, float* s_out) {
    float m = -INFINITY;
    for (int j = threadIdx.x; j < NUM_CLASSES; j += blockDim.x)
        m = fmaxf(m, x[j]);
    m = block_max(m);
    float s = 0.0f;
    for (int j = threadIdx.x; j < NUM_CLASSES - SKIP_LAST; j += blockDim.x)
        s += expf(x[j] - m);
    *m_out = m;
    *s_out = block_sum(s);
}

// loss[b] = logsumexp(logits[b]) - logits[b, label[b]]; n = B
extern "C" __global__ void softmax_ce_fwd(const float* logits,
                                          const float* label, float* loss,
                                          long long n) {
    long long row = blockIdx.x;
    if (row >= n) return;
    const float* x = logits + row * NUM_CLASSES;
    float m, s;
    row_stats(x, &m, &s);
    if (threadIdx.x == 0) loss[row] = m + logf(s) - x[(int)label[row]];
}

// dx[b, j] = ct[b] * (softmax(logits[b])[j] - (j == label[b])); n = B*C
extern "C" __global__ void softmax_ce_bwd(const float* logits,
                                          const float* label,
                                          const float* ct, float* dx,
                                          long long n) {
    long long row = blockIdx.x;
    if (row * NUM_CLASSES >= n) return;
    const float* x = logits + row * NUM_CLASSES;
    float m, s;
    row_stats(x, &m, &s);
    float g = ct[row], inv = 1.0f / s;
    int lab = (int)label[row];
    for (int j = threadIdx.x; j < NUM_CLASSES; j += blockDim.x)
        dx[row * NUM_CLASSES + j] =
            g * (expf(x[j] - m) * inv - (j == lab ? 1.0f : 0.0f));
}
"""
USER_CUDA_KERNELS = ("double_kernel", "scale3_kernel", "softmax_ce_fwd",
                     "softmax_ce_bwd")


def triton_scale3():
    """The user's Triton kernel: out = 3 * x, BLOCK elements a program."""
    import triton
    import triton.language
    globals()["tl"] = triton.language   # the kernel body reads tl

    @triton.jit
    def scale3_triton(x_ptr, out_ptr, n, BLOCK: tl.constexpr):  # noqa: F821
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)  # noqa: F821
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask)  # noqa: F821
        tl.store(out_ptr + offs, x * 3.0, mask=mask)  # noqa: F821

    return scale3_triton


def double_plain(x):
    return x * 2.0


def scale3_plain(x):
    return x * 3.0


def softmax_ce_plain(logits, label):
    """(B,) = logsumexp(row) - row[label], fp32."""
    import torch
    picked = logits.gather(1, label.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=1) - picked


def softmax_ce_bwd_plain(logits, label, ct):
    """(B, C) = ct[b] * (softmax - onehot)."""
    import torch
    p = torch.softmax(logits, dim=1)
    onehot = torch.zeros_like(p).scatter_(1, label.long()[:, None], 1.0)
    return ct[:, None] * (p - onehot)


def register_softmax_ce(mt, fwd_kernel, bwd_kernel, name="softmax_ce"):
    """The user's softmax cross-entropy as an op ``nd.<name>``: forward
    ``fwd_kernel`` (one block of 256 threads per row), backward
    ``bwd_kernel`` through a second UserKernel launched from the VJP.
    Returns (forward op, backward op)."""
    import torch
    bwd = mt.operator.UserKernel(
        bwd_kernel, out_shape=lambda s: s[0], name=name + "_bwd",
        grid=lambda s: s[0][0], block=256, plain=softmax_ce_bwd_plain)

    def vjp(ct, logits, label):
        return bwd(logits, label, ct.contiguous()), torch.zeros_like(label)

    fwd = mt.operator.register_kernel(
        name, fwd_kernel, out_shape=lambda s: (s[0][0],),
        grid=lambda s: s[0][0], block=256, vjp=vjp, plain=softmax_ce_plain)
    return fwd, bwd


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


def routed(fb, name, fn):
    """``fn()``'s result and the route (``route_counts`` key) of the one
    launch of wrapper ``name`` it made."""
    before = fb.route_counts()[name]
    out = fn()
    after = fb.route_counts()[name]
    hit = [r for r in after if after[r] != before[r]]
    check(len(hit) == 1 and after[hit[0]] == before[hit[0]] + 1,
          f"{name}: one launch expected, routes {before} -> {after}")
    return out, hit[0]


def check_route(name, route, expect, what):
    """``expect``: "wgmma" (either wgmma route), a route name, or None."""
    ok = expect is None or route == expect or (
        expect == "wgmma" and route in WGMMA_ROUTES)
    check(ok, f"{name} at {what} took route {route}, expected {expect}")


def k1_case(mt, torch, F, gen, b, c, h, w, o, relu, dtype, timed=True,
            misalign=False, expect=None):
    """K1 at one shape: error against the fp32 plain version, times, and
    the route the plan chose (held to ``expect``). ``misalign`` starts x
    one element into its buffer, so the kernel must fall back to its
    narrowest access."""
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
    out, route = routed(fb, "bn_relu_conv_nchw",
                        lambda: fb.bn_relu_conv_nchw(x, wt, sc, sh,
                                                     relu=relu))
    torch.cuda.synchronize()
    ref = fb.bn_relu_conv_nchw_plain(x.float(), wt.float(), sc.float(),
                                     sh.float(), relu=relu)
    err = (out.float() - ref).abs()
    scale = ref.abs().max().item()
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    ok = bool((err <= tol * scale + tol * ref.abs()).all())
    row = {"phase": "kernel", "kernel": "bn_relu_conv1x1", "dtype": dtype,
           "x": [b, c, h, w], "O": o, "relu": relu, "misalign": misalign,
           "route": route,
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
        if route in WGMMA_ROUTES:
            # the first (WMMA) kernel, which the wgmma core replaced at
            # this shape: its time and its agreement, same inputs
            plan = fb._k1_wmma_plan(b, c, o, s)

            def run():
                return fb._k1_run(x, wt, sc, sh, relu, plan)

            werr = (run().float() - ref).abs()
            row["wmma_max_abs_err"] = werr.max().item()
            row["ok"] = ok = ok and bool(
                (werr <= tol * scale + tol * ref.abs()).all())
            row["wmma_ms"] = time_ms(run)
    emit(row)
    check(ok, f"K1 disagrees with its plain version: {row}")
    check_route("K1", route, expect, row["x"])
    return row


def k1_host_cost(mt, torch, gen, calls=400, reps=5):
    """Host microseconds to issue one bf16 K1 call at batch 1, where the
    kernel takes a few microseconds and the host sets the rate: the
    public wrapper (checks, the memoised plan, the launch) and the
    launch alone (``_k1_run``) through the wgmma core and through the
    first (WMMA) kernel; medians of ``reps`` runs of ``calls`` calls."""
    fb = mt.ops.fused_bn_conv
    bf16 = torch.bfloat16
    rows = []
    for c, h, o in ((64, 56, 256), (512, 7, 2048)):
        x = torch.randn(1, c, h, h, generator=gen, device="cuda").to(bf16)
        wt = torch.randn(o, c, generator=gen, device="cuda").to(bf16)
        sc = torch.ones(c, device="cuda", dtype=bf16)
        sh = torch.zeros(c, device="cuda", dtype=bf16)
        plan = fb._k1_plan(1, c, o, h * h, bf16)
        wmma = fb._k1_wmma_plan(1, c, o, h * h)
        fns = {"wrapper": lambda: fb.bn_relu_conv_nchw(x, wt, sc, sh),
               "wgmma_launch": lambda: fb._k1_run(x, wt, sc, sh, True,
                                                  plan),
               "wmma_launch": lambda: fb._k1_run(x, wt, sc, sh, True,
                                                 wmma)}
        row = {"x": [1, c, h, h], "O": o, "route": plan.route}
        for name, fn in fns.items():
            times = []
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                times.append((time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize()
            row[name + "_us"] = statistics.median(times)
        rows.append(row)
    emit({"phase": "k1_host_cost", "calls": calls, "reps": reps,
          "rows": rows})


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


def k3_case(mt, torch, gen, m, k, n, relu, dtype, timed=True, expect=None):
    """K3 at one shape: forward against the fp32 plain version and the
    gradients of ``bn_relu_matmul`` (K3, K2, B1, B2 and torch.matmul)
    against fp32 autograd of the plain expression, times, and the route
    the plan chose (held to ``expect``)."""
    fb = mt.ops.fused_bn_conv
    dt = getattr(torch, dtype)
    dev = "cuda"
    x = torch.randn(m, k, generator=gen, device=dev).to(dt)
    w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(dt)
    sc = (0.5 + torch.rand(k, generator=gen, device=dev)).to(dt)
    sh = (0.2 * torch.randn(k, generator=gen, device=dev)).to(dt)
    out, route = routed(fb, "bn_relu_matmul_fwd",
                        lambda: fb.bn_relu_matmul_fwd(x, w, sc, sh, relu))
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
           "M": m, "K": k, "N": n, "relu": relu, "route": route,
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
        if route in WGMMA_ROUTES:
            # the first (WMMA) kernel at this shape, as in k1_case
            plan = fb._k3_wmma_plan(m, k, n)

            def run():
                return fb._k3_run(x, w, sc, sh, relu, plan)

            werr = (run().float() - ref).abs()
            row["wmma_max_abs_err"] = werr.max().item()
            row["ok"] = ok = ok and bool(
                (werr <= tol * scale + tol * ref.abs()).all())
            row["wmma_ms"] = time_ms(run)
    emit(row)
    check(ok, f"K3 disagrees with its plain version: {row}")
    check_route("K3", route, expect, [m, k, n])
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
    training shapes; per-step sums over the sites of K1, K2, B1, B2, and
    K1's row per distinct site."""
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
    k1_sites = []
    # K1 (training forward) and K2 (forward of the K sites, recompute in
    # every site's backward) at the batch-128 site shapes
    k2_calls = {}
    for (op, d, w, relu), count in sorted(sites.items()):
        b, c, h, wd = d
        if op == "_FusedBNReLUConv":
            row = k1_case(mt, torch, F, gen, b, c, h, wd, w[0], relu,
                          "bfloat16", expect="wgmma")
            per_step["K1"].append((count, row["ms"], row["plain_ms"],
                                   row["bound_ms"], row["library_ms"],
                                   row["max_abs_err"]))
            k1_sites.append({"x": row["x"], "O": row["O"],
                             "sites_per_step": count,
                             "route": row["route"], "ms": row["ms"],
                             "wmma_ms": row["wmma_ms"],
                             "bound_ms": row["bound_ms"],
                             "bound_by": row["bound_by"],
                             "plain_ms": row["plain_ms"],
                             "library_ms": row["library_ms"]})
            # the same 1x1 conv as K3's (M, K) @ (K, N) in NHWC
            k3_rows.append((b * h * wd, c, w[0], relu))
        fwd = 1 if op == "_FusedBNReLUConvK" else 0
        key = (d, relu)
        k2_calls[key] = k2_calls.get(key, 0) + count * (fwd + 1)
    emit({"phase": "k1_training_sites", "batch": TRAIN_BATCH,
          "sites": k1_sites,
          "per_step_ms": sum(r["sites_per_step"] * r["ms"] for r in k1_sites),
          "per_step_wmma_ms": sum(r["sites_per_step"] * r["wmma_ms"]
                                  for r in k1_sites),
          "per_step_bound_ms": sum(r["sites_per_step"] * r["bound_ms"]
                                   for r in k1_sites),
          "per_step_library_ms": sum(r["sites_per_step"] * r["library_ms"]
                                     for r in k1_sites)})
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
        k3_default[dtype] = k3_case(
            mt, torch, gen, 401408, 64, 256, True, dtype,
            expect="wgmma_tma" if dtype == "bfloat16" else "fp32")
    for m, k, n, relu in sorted(set(k3_rows)):
        k3_case(mt, torch, gen, m, k, n, relu, "bfloat16",
                expect="wgmma_tma")
        k3_case(mt, torch, gen, m, k, n, relu, "float32", timed=False)
    for m, k, n in ((5, 3, 7), (130, 33, 65), (1000, 24, 40),
                    (257, 63, 255)):
        for dtype in ("bfloat16", "float32"):
            for relu in (True, False):
                k3_case(mt, torch, gen, m, k, n, relu, dtype, timed=False,
                        expect="wmma" if dtype == "bfloat16" else "fp32")
    for m, k, n in K3_WGMMA_RAGGED:
        for relu in (True, False):
            k3_case(mt, torch, gen, m, k, n, relu, "bfloat16", timed=False,
                    expect="wgmma_tma")
    try:
        fb.bn_relu_matmul_fwd(*(torch.zeros(s, device="cuda",
                                            dtype=torch.float16)
                                for s in ((8, 8), (8, 8), (8,), (8,))))
        raise AssertionError("K3 accepted float16 on CUDA")
    except mt.MXNetError as e:
        emit({"phase": "kernel", "k3_raises_on_unsupported_dtype": str(e)})
    return per_step, k3_default, k1_sites


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
    routes = fb.route_counts()["bn_relu_matmul_fwd"]
    ok = all(bool(torch.isfinite(g.float()).all()) for g in grads)
    emit({"phase": "bn_relu_matmul_path", "M": m, "K": k, "N": n,
          "calls": steps, "launches": launches, "routes": routes,
          "finite": ok})
    check(routes["wgmma_tma"] == steps,
          f"bn_relu_matmul path routes {routes}")
    check(ok and launches["bn_relu_matmul_fwd"] == steps
          and launches["bn_act_prologue"] == steps
          and launches["bn_backward_reduce"] == steps
          and launches["bn_backward_dx"] == steps
          and launches["bn_relu_conv_nchw"] == 0,
          f"bn_relu_matmul path launches {launches}")
    return launches, routes


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
    totals0 = registry_totals(mt)
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
    routes = fb.route_counts()["bn_relu_conv_nchw"]
    registry = registry_delta(totals0, registry_totals(mt))
    losses = [float(v) for v in losses]
    emit({"phase": "training_speed", "batch": batch, "steps": n_steps,
          "img_per_s": n_steps * batch / dt, "ms_per_step": dt / n_steps
          * 1e3, "launches": launches,
          "launches_per_step": {k: v / n_steps for k, v in launches.items()},
          "k1_routes": routes,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
          / 1e9, "memory_allocated_before_gb": allocated_before,
          "one_step_memory": {"fused_bf16": f16[3], "plain_bf16": p16[3]},
          "losses": losses, "setup_s": t1 - t0,
          "counted_from": "CUDA graph replays (compile registry)",
          "compile_report_delta": registry,
          "program": pt.step_program(model).as_dict(), "card": smi})
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(len(set(losses)) > 1, f"every step read one loss {losses}")
    check(registry["replays"] == n_steps and registry["fresh_compiles"] == 0
          and registry["retraces"] == 0,
          f"after warm-up every step must be a replay of the captured "
          f"step: {registry} over {n_steps} steps")
    check(launches["bn_relu_conv_nchw"] == 28 * n_steps
          and launches["bn_act_prologue"] == 60 * n_steps
          and launches["bn_backward_reduce"] == 44 * n_steps
          and launches["bn_backward_dx"] == 44 * n_steps
          and launches["bn_relu_matmul_fwd"] == 0,
          f"training launches {launches} over {n_steps} steps")
    check(sum(routes[r] for r in WGMMA_ROUTES) == 28 * n_steps,
          f"training K1 routes {routes} over {n_steps} steps: the 28 K1 "
          "sites a step must take the wgmma core")
    return launches, n_steps, routes


# ---------------------------------------------------------------------------
# The captured programs (CUDA graphs): capture_smoke, the captured step's
# and the captured buckets' checks against the eager forms, and the
# interleaved eager / captured A/Bs of one tree
# ---------------------------------------------------------------------------
CAPTURE_SMOKE_BATCH = 8
# one eager step or request run, then one captured, in this order, each
# AB_STEPS steps (training) or bucket-64 requests (serving)
AB_RUNS = ("eager", "captured", "captured", "eager", "eager", "captured",
           "captured", "eager")
AB_STEPS = 20
AB_TRACE_STEPS = 5
# the learning rates of the three checked steps (a schedule, so a replay
# that reads a stale lr differs from the eager step)
CHECK_LRS = (0.1, 0.05, 0.025)
KERNEL_WRAPPERS = {"K1": "bn_relu_conv_nchw", "K2": "bn_act_prologue",
                   "B1": "bn_backward_reduce", "B2": "bn_backward_dx"}


def registry_totals(mt):
    return dict(mt.compile_report()["totals"])


def registry_delta(before, after):
    return {k: after[k] - before[k] for k in ("programs", "fresh_compiles",
                                               "replays", "retraces")}


def capture_smoke(mt, torch, gen):
    """Phase 3b: one launch of each kernel of the captured paths (K1 on
    the TMA and on the bulk route, K2, B1, B2; bf16, ResNet-50 site
    shapes at batch 8) captured in a CUDA graph through the compile
    registry, replayed twice and held bit for bit against the same call
    made eagerly; the launch counters must count the two replays and not
    the capture."""
    from mxnet_tpu_torch import compile as cm
    fb = mt.ops.fused_bn_conv
    bf = torch.bfloat16
    b = CAPTURE_SMOKE_BATCH

    def rnd(*shape, dtype=bf, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=gen,
                                            device="cuda")).to(dtype)

    def k1(c, hw, o):
        x, w = rnd(b, c, hw, hw), rnd(o, c, scale=c ** -0.5)
        sc, sh = rnd(c, scale=0.2, shift=1.0), rnd(c, scale=0.2)
        return [b, c, hw, hw, o], lambda: fb.bn_relu_conv_nchw(x, w, sc, sh)

    x2 = rnd(b, 256, 28, 28)
    sc2, sh2 = rnd(256, scale=0.2, shift=1.0), rnd(256, scale=0.2)
    dy, xb, xh = (rnd(b, 256, 14, 14) for _ in range(3))
    scb, cx, c0 = (rnd(256, dtype=torch.float32) for _ in range(3))
    cases = (("K1", "wgmma_tma") + k1(64, 56, 256),
             ("K1", "wgmma_bulk") + k1(256, 14, 1024),
             ("K2", None, list(x2.shape),
              lambda: fb.bn_act_prologue(x2, sc2, sh2)),
             ("B1", None, list(dy.shape),
              lambda: fb.bn_backward_reduce(dy, xb, xh)),
             ("B2", None, list(dy.shape),
              lambda: fb.bn_backward_dx(dy, xb, xh, scb, cx, c0)))
    for name, route, shape, fn in cases:
        want = fn()                  # eager: warms the kernel; reference
        torch.cuda.synchronize()
        before = fb.counter_state()
        prog = cm.CapturedProgram(cm.program_key(
            "capture_smoke", f"capture_smoke:{name}:{route}",
            input_sigs=(shape,), extra={"kernel": name, "route": route},
            device="cuda"))
        got = prog.capture(fn)
        at_capture = fb.counter_state()
        prog.replay()
        prog.replay()
        torch.cuda.synchronize()
        after = fb.counter_state()
        delta = {k: v - before[k] for k, v in after.items()
                 if v != before[k]}
        wrapper = KERNEL_WRAPPERS[name]
        expect = {wrapper: 2}
        if route:
            expect[f"{wrapper}/{route}"] = 2
        row = {"phase": "capture_smoke", "kernel": name, "route": route,
               "shape": shape, "bit_identical": bool(torch.equal(got, want)),
               "max_abs_diff": float((got.float() - want.float()).abs()
                                     .max()),
               "capture_counted": at_capture != before,
               "launches_after_two_replays": delta,
               "capture_s": prog.record.capture_s}
        emit(row)
        check(row["bit_identical"],
              f"capture_smoke {name}: the replay differs from the eager "
              f"call: {row}")
        check(not row["capture_counted"],
              f"capture_smoke {name}: the capture left launch counts")
        check(delta == expect, f"capture_smoke {name}: launches {delta}, "
                               f"expected {expect}")

    # another thread's launch during a capture counts once, as it ran
    x3 = rnd(*x2.shape)
    want_other = fb.bn_act_prologue(x3, sc2, sh2)
    other = torch.cuda.Stream()
    got_other = []

    def launch_elsewhere():
        with torch.cuda.stream(other):
            got_other.append(fb.bn_act_prologue(x3, sc2, sh2))
        other.synchronize()

    def with_other_thread():
        t = threading.Thread(target=launch_elsewhere)
        t.start()
        t.join()
        return fb.bn_act_prologue(x2, sc2, sh2)

    torch.cuda.synchronize()
    before = fb.counter_state()
    prog = cm.CapturedProgram(cm.program_key(
        "capture_smoke", "capture_smoke:K2:other_thread",
        input_sigs=(list(x2.shape),), extra={"kernel": "K2"},
        device="cuda"))
    got = prog.capture(with_other_thread, capture_error_mode="thread_local")
    at_capture = fb.counter_state()
    prog.replay()
    prog.replay()
    torch.cuda.synchronize()
    after = fb.counter_state()
    row = {"phase": "capture_smoke", "kernel": "K2",
           "route": "other_thread",
           "launches_at_capture": {k: v - before[k]
                                   for k, v in at_capture.items()
                                   if v != before[k]},
           "launches_after_two_replays": {k: v - before[k]
                                          for k, v in after.items()
                                          if v != before[k]},
           "bit_identical": bool(torch.equal(got, fb.bn_act_prologue(
               x2, sc2, sh2)) and torch.equal(got_other[0], want_other))}
    emit(row)
    check(row["bit_identical"], f"capture_smoke K2 other_thread: {row}")
    check(row["launches_at_capture"] == {"bn_act_prologue": 1}
          and row["launches_after_two_replays"] == {"bn_act_prologue": 3},
          f"capture_smoke K2 other_thread: launches {row}")


def train_state(f, losses):
    """The state a fused step leaves, grouped: each step's loss, the fp32
    masters, the momenta and the aux, as copies."""
    return {"loss": {f"step{i + 1}": v.detach().float().reshape(1).clone()
                     for i, v in enumerate(losses)},
            "weights": {n: p.detach().clone() for n, p in f._p.items()},
            "momentum": {n: s[0].clone() for n, s in f._state.items()},
            "aux": {n: v.clone() for n, v in f._aux.items()}}


def state_diff(torch, got, want):
    """Per group: whether every tensor is bit-identical, and the worst
    relative L2 difference over its tensors."""
    out = {}
    for g in want:
        errs = {n: rel_l2(got[g][n], want[g][n]) for n in want[g]}
        worst = max(errs, key=errs.get)
        out[g] = {"bit_identical": all(torch.equal(got[g][n], want[g][n])
                                       for n in want[g]),
                  "worst_rel_l2": errs[worst], "worst": worst}
    return out


def same_within(diff, spread):
    """Groups of ``diff`` that break the captured checks' rule: a group
    passes when bit-identical, or within twice the spread of two eager
    runs (``spread``, the same measure)."""
    return [g for g in diff if not diff[g]["bit_identical"]
            and diff[g]["worst_rel_l2"] > 2 * spread[g]["worst_rel_l2"]]


def training_captured_check(torch, batches):
    """Two Modules from the same init: three eager steps (twice, for the
    spread) against three captured steps (replays) at lr 0.1, 0.05 and
    0.025: each step's loss, every master weight, momentum and aux; then
    two planted faults the check must reject (replays whose lr write is
    skipped, and a replay whose batch-2 input copy is skipped)."""
    from mxnet_tpu_torch import profile_training as pt
    feeds = [{"data": b.data[0], "softmax_label": b.label[0]}
             for b in batches[:3]]
    fe = pt.build_module(TRAIN_BATCH, SEED)._fused
    fc = pt.build_module(TRAIN_BATCH, SEED)._fused
    init = [{n: t.clone() for n, t in d.items()} for d in fe.params()]

    def run(f, step, skip_lr=(), stale=()):
        f.load_params(*init)
        for s in f._state.values():
            s[0].zero_()
        losses = []
        for i, (feed, lr) in enumerate(zip(feeds, CHECK_LRS)):
            if i in stale:
                f._load_inputs = lambda prog, vals: None
            try:
                step(feed, None if i in skip_lr else lr)
            finally:
                f.__dict__.pop("_load_inputs", None)
            losses.append(f.last_loss)
        torch.cuda.synchronize()
        return train_state(f, losses)

    # the captured step's program: a warm-up step, then the capture
    fc.step(feeds[0], 0.1)
    fc.step(feeds[1], 0.1)
    (prog,) = fc._programs.values()
    check(prog.captured, "the fused step was not captured")
    eager1 = run(fe, fe.step_eager)
    eager2 = run(fe, fe.step_eager)
    replays0 = prog.record.replays
    captured = run(fc, fc.step)
    check(prog.record.replays - replays0 == 3 and prog.record.captures == 1,
          f"captured steps were not replays: {prog.record.as_dict()}")
    probes = {"lr_write_skipped": run(fc, fc.step, skip_lr=(1, 2)),
              "batch2_copy_skipped": run(fc, fc.step, stale=(1,))}
    spread = state_diff(torch, eager2, eager1)
    diff = state_diff(torch, captured, eager1)
    fails = same_within(diff, spread)
    rejected = {k: same_within(state_diff(torch, v, eager1), spread)
                for k, v in probes.items()}
    emit({"phase": "training_captured_check", "batch": TRAIN_BATCH,
          "lrs": list(CHECK_LRS),
          "against": "three eager steps of a Module from the same init "
                     "(FusedSymbolStep.step_eager); captured: three "
                     "replays of the step's CUDA graph",
          "captured_vs_eager": diff, "eager_spread": spread,
          "rule": "per group: bit-identical, or worst relative L2 <= 2 x "
                  "the eager spread (the same measure between two eager "
                  "runs from the same state)",
          "program": prog.record.as_dict(), "failures": fails,
          "probes_rejected_by": rejected})
    check(not fails, f"captured training step against eager: {fails}")
    for k, v in rejected.items():
        check(v, f"the captured-step check passes a planted fault ({k})")


def ab_summary(runs, key, modes=("eager", "captured")):
    """Per mode: the runs' values of ``key``, their median and their
    spread ((max - min) / median)."""
    out = {}
    for mode in modes:
        vals = [r[key] for r in runs if r["mode"] == mode]
        med = statistics.median(vals)
        out[mode] = {"runs": vals, "median": med,
                     "spread": (max(vals) - min(vals)) / med}
    return out


def timed_runs(torch, run_one, n):
    """``n`` calls of ``run_one(i)``: host-clock ms per call (ended by a
    sync) and the median of CUDA events around each call (device clock),
    max memory allocated and reserved."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    t0 = time.perf_counter()
    for i in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run_one(i)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / n
    return {"host_ms": host,
            "event_ms": statistics.median(a.elapsed_time(b)
                                          for a, b in events),
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "max_memory_reserved_gb":
                torch.cuda.max_memory_reserved() / 1e9}


def training_ab(torch, smi, batches):
    """Interleaved runs of the Module step on one tree, eager and
    captured (``AB_RUNS``, ``AB_STEPS`` steps each): host-clock ms per
    step (median, spread), device ms per step (CUDA events), memory, and
    per mode a ``torch.profiler`` window's busy share."""
    from mxnet_tpu_torch import profile_training as pt
    model = pt.build_module(TRAIN_BATCH, SEED)
    pt.run_step(model, batches[0])      # the warm-up step (eager)
    # a replay allocates nothing, so max_memory_allocated does not see
    # the graph's private pool: read the memory the capture reserved
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    pt.run_step(model, batches[1])      # the capture
    pool_gb = (torch.cuda.memory_reserved() - reserved0) / 1e9
    for i in range(3):
        pt.run_step(model, batches[i % 4])
        pt.run_step(model, batches[i % 4], eager=True)
    rec = pt.step_program(model)
    runs = []
    for mode in AB_RUNS:
        eager = mode == "eager"
        r = timed_runs(torch, lambda i: pt.run_step(
            model, batches[i % 4], eager), AB_STEPS)
        runs.append(dict(r, mode=mode))
    busy = {}
    for mode in ("eager", "captured"):
        tr = pt.device_trace(lambda i: pt.run_step(
            model, batches[i % 4], mode == "eager"), AB_TRACE_STEPS)
        s = pt.busy_summary(tr, AB_TRACE_STEPS)
        busy[mode] = {k: s[k] for k in ("device_busy_share",
                                        "device_kernel_ms_per_step",
                                        "traced_wall_ms")}
    row = {"phase": "training_ab", "batch": TRAIN_BATCH,
           "steps_per_run": AB_STEPS, "order": list(AB_RUNS),
           "host_ms_per_step": ab_summary(runs, "host_ms"),
           "event_ms_per_step": ab_summary(runs, "event_ms"),
           "memory": dict({m: {k: max(r[k] for r in runs
                                      if r["mode"] == m)
                               for k in ("max_memory_allocated_gb",
                                         "max_memory_reserved_gb")}
                           for m in ("eager", "captured")},
                          captured_graph_pool_reserved_gb=pool_gb),
           "busy": busy, "program": rec.as_dict(), "card": smi}
    emit(row)
    check(rec.captures == 1, f"the A/B's step was captured "
                             f"{rec.captures} times")
    return row


def serving_captured_check(np, pred, rng):
    """Every bucket's replayed forward against the eager forward of the
    same Predictor on the same request (two eager runs give the spread),
    and a 5-row request padded into bucket 8."""
    rows = []
    for b in pred.buckets + (5,):
        x = rng.standard_normal((b, 3, 224, 224)).astype(np.float32)
        e1, e2 = pred.predict_eager(x), pred.predict_eager(x)
        got = pred.predict(x)
        spread = float(np.abs(e2 - e1).max())
        diff = float(np.abs(got - e1).max())
        ok = bool(np.array_equal(got, e1)) or diff <= 2 * spread
        rows.append({"rows": b, "bucket": pred.bucket_for(b),
                     "shape": list(got.shape),
                     "bit_identical": bool(np.array_equal(got, e1)),
                     "max_abs_diff": diff, "eager_spread": spread,
                     "ok": ok})
    emit({"phase": "serving_captured_check",
          "rule": "bit-identical, or max |replay - eager| <= 2 x max "
                  "|eager - eager| (two eager runs of the request)",
          "requests": rows})
    check(all(r["ok"] for r in rows), f"captured buckets against eager: "
                                      f"{rows}")


def serving_ab(torch, smi, pred, x):
    """Interleaved runs of bucket-64 requests on one Predictor, eager
    (``predict_eager``) and captured (``predict``): host-clock ms per
    request (median, spread), device ms (CUDA events), the H2D /
    forward-or-replay / D2H split, memory, and per mode a profiler
    window's busy share."""
    from mxnet_tpu_torch import profile_serving as ps
    from mxnet_tpu_torch import profile_training as pt
    calls = {"eager": pred.predict_eager, "captured": pred.predict}
    for fn in calls.values():
        fn(x)
    runs = [dict(timed_runs(torch, lambda i: calls[mode](x), AB_STEPS),
                 mode=mode) for mode in AB_RUNS]
    split_captured, prog = ps.captured_split(pred, x, AB_STEPS)
    with pred._lock, torch.inference_mode():
        replay_ms = ps.replay_event_ms(prog, AB_STEPS)
    busy = {}
    for mode, fn in calls.items():
        tr = pt.device_trace(lambda i: fn(x), AB_STEPS)
        s = pt.busy_summary(tr, AB_STEPS, what="request")
        busy[mode] = {k: s[k] for k in ("device_busy_share",
                                        "device_kernel_ms_per_request",
                                        "traced_wall_ms")}
    row = {"phase": "serving_ab", "bucket": x.shape[0],
           "requests_per_run": AB_STEPS, "order": list(AB_RUNS),
           "host_ms_per_request": ab_summary(runs, "host_ms"),
           "event_ms_per_request": ab_summary(runs, "event_ms"),
           "split_ms": {"eager": ps.eager_split(pred, x, AB_STEPS),
                        "captured": split_captured},
           "device_ms_per_replay": replay_ms,
           "memory": {m: {k: max(r[k] for r in runs if r["mode"] == m)
                          for k in ("max_memory_allocated_gb",
                                    "max_memory_reserved_gb")}
                      for m in ("eager", "captured")},
           "busy": busy,
           "program": dict(prog.record.as_dict(),
                           launches_per_replay=prog.launches),
           "card": smi}
    emit(row)
    return row


def k4_build(mt):
    """Phase 8: compile the user's CUDA source through rtc.CudaModule,
    the real one and the fault probe's, one nvcc each, in parallel."""
    import concurrent.futures
    t0 = time.perf_counter()
    mods = {"main": mt.rtc.CudaModule(
                USER_CUDA_SRC, options=(f"-DNUM_CLASSES={NUM_CLASSES}",)),
            "probe": mt.rtc.CudaModule(
                USER_CUDA_SRC, options=(f"-DNUM_CLASSES={NUM_CLASSES}",
                                        "-DSKIP_LAST=1"))}
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as ex:
        list(ex.map(lambda m: m.compile(), mods.values()))
    fns = {k: {n: m.get_function(n) for n in USER_CUDA_KERNELS}
           for k, m in mods.items()}
    emit({"phase": "rtc_build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {k: m.compile_seconds for k, m in mods.items()},
          "cubins": {k: m.cubin for k, m in mods.items()},
          "ptxas": {k: [ln.strip() for ln in m.ptxas_log().splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling" in ln]
                    for k, m in mods.items()}})
    return fns


def k4_register(mt, fns, triton_kernel):
    """The user's ops: nd.user_double, nd.user_scale3 (CUDA),
    nd.user_scale3_triton, each differentiable through a VJP that
    launches the same kernel on the cotangent, and nd.softmax_ce (and its
    fault-probe twin nd.softmax_ce_probe)."""
    same = lambda s: s[0]  # noqa: E731
    ops = {}
    for name, kernel, plain in (
            ("user_double", fns["main"]["double_kernel"], double_plain),
            ("user_scale3", fns["main"]["scale3_kernel"], scale3_plain),
            ("user_scale3_triton", triton_kernel, scale3_plain)):
        def vjp(ct, x, _name=name):
            return (ops[_name](ct.contiguous()),)
        ops[name] = mt.operator.register_kernel(name, kernel, same, vjp=vjp,
                                                plain=plain)
    ops["softmax_ce"], ops["softmax_ce_bwd"] = register_softmax_ce(
        mt, fns["main"]["softmax_ce_fwd"], fns["main"]["softmax_ce_bwd"])
    ops["softmax_ce_probe"], ops["softmax_ce_probe_bwd"] = \
        register_softmax_ce(mt, fns["probe"]["softmax_ce_fwd"],
                            fns["probe"]["softmax_ce_bwd"],
                            name="softmax_ce_probe")
    return ops


def k4_case(torch, name, route, op, plain, library, ins, nbytes, tol,
            what):
    """One user kernel through the hook against its plain version:
    errors, device ms beside the plain version's and the library
    call's, and the bytes bound."""
    got = op(*ins)
    torch.cuda.synchronize()
    ref = plain(*ins)
    err = float((got - ref).abs().max())
    bound, by = bound_ms(nbytes, 0, "float32")
    row = {"phase": "kernel", "kernel": name, "route": route, "what": what,
           "shapes": [list(t.shape) for t in ins], "dtype": "float32",
           "max_abs_err": err, "tolerance": tol,
           "ms": time_ms(lambda: op(*ins)),
           "plain_ms": time_ms(lambda: plain(*ins)),
           "library_ms": time_ms(lambda: library(*ins))
           if library is not None else None,
           "bound_ms": bound, "bound_by": by, "bytes": nbytes}
    emit(row)
    check(err <= tol, f"{name} ({what}) against its plain version: {err}")
    return row


def k4_phase(mt, torch, np, ops):
    """Phase 9: each user kernel against its plain version, then through
    nd.<name> and autograd."""
    import torch.nn.functional as F
    from mxnet_tpu_torch import autograd, nd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    rows = {}
    for shape, what in (((2, 4), "test shape"),
                        (LARGE_ELEMWISE, "large elementwise")):
        x = randn(*shape)
        n = x.numel()
        for name, route, plain, lib in (
                ("user_double", "cuda", double_plain, lambda t: t * 2),
                ("user_scale3", "cuda", scale3_plain, lambda t: t * 3),
                ("user_scale3_triton", "triton", scale3_plain,
                 lambda t: t * 3)):
            rows[(name, what)] = k4_case(torch, name, route, ops[name],
                                         plain, lib, [x], 8 * n, 0.0, what)
        del x

    def ce_lib(logits, label):
        return F.cross_entropy(logits, label.long(), reduction="none")

    for rows_n, what in ((GLUON_BATCH, "path shape"),
                         (LARGE_CE_ROWS, "large")):
        logits = randn(rows_n, NUM_CLASSES) * 3
        label = torch.randint(0, NUM_CLASSES, (rows_n,), device="cuda",
                              generator=gen).float()
        ct = randn(rows_n)
        nb = rows_n * NUM_CLASSES * 4
        rows[("softmax_ce_fwd", what)] = k4_case(
            torch, "softmax_ce_fwd", "cuda", ops["softmax_ce"],
            softmax_ce_plain, ce_lib, [logits, label],
            nb + 8 * rows_n, K4_CE_FWD_TOL, what)
        rows[("softmax_ce_bwd", what)] = k4_case(
            torch, "softmax_ce_bwd", "cuda", ops["softmax_ce_bwd"],
            softmax_ce_bwd_plain, None, [logits, label, ct],
            2 * nb + 12 * rows_n, K4_CE_BWD_TOL, what)
        del logits, label, ct

    # through nd.<name> and autograd.record() / backward()
    counted = [ops[k] for k in ("user_double", "user_scale3",
                                "user_scale3_triton")]
    for op in counted:
        op.launches = 0
    xs = np.random.default_rng(SEED).standard_normal((64, 33)).astype(
        np.float32)
    w = np.random.default_rng(SEED + 1).standard_normal((64, 33)).astype(
        np.float32)
    with mt.gpu(0):
        x = nd.array(xs)
        doubled = nd.user_double(x).asnumpy()
        x.attach_grad()
        with autograd.record():
            loss = (nd.user_scale3(x) * nd.array(w)).sum() + \
                nd.user_double(nd.user_scale3_triton(x)).sum()
        loss.backward()
        grad = x.grad.asnumpy()
    torch.cuda.synchronize()
    launches = {op.name: op.launches for op in counted}
    want_grad = 3 * w + 6
    emit({"phase": "k4_path", "path": "nd.<name> and autograd.record() / "
          "backward() on cuda:0", "launches": launches,
          "max_abs_err_forward": float(np.abs(doubled - 2 * xs).max()),
          "max_abs_err_grad": float(np.abs(grad - want_grad).max()),
          "loss": float(loss.asscalar()),
          "want_loss": float((3 * xs * w).sum() + (6 * xs).sum())})
    check(np.array_equal(doubled, 2 * xs), "nd.user_double")
    check(np.abs(grad - want_grad).max() <= 1e-5, "the K4 VJPs' gradient")
    # user_double: 1 forward + 2 in the loss (forward, VJP); user_scale3:
    # forward + VJP; the Triton kernel: forward + VJP
    check(launches == {"user_double": 3, "user_scale3": 2,
                       "user_scale3_triton": 2},
          f"K4 launches through nd and autograd: {launches}")
    return rows, launches


def plain_sgd(w, g, mom, p):
    """One step of SGD with momentum in fp64 (the JAX package's
    ``sgd_mom_update``): ``g/batch + wd*w``, ``mom = momentum*mom -
    lr*g``, ``w + mom``, with the Parameter's lr and wd multipliers."""
    w = w.double()
    g = g.double() / GLUON_BATCH + GLUON_HP["wd"] * p.wd_mult * w
    mom = GLUON_HP["momentum"] * mom - \
        GLUON_HP["learning_rate"] * p.lr_mult * g
    return w + mom, mom


def sgd_check_phase(torch, nd, gluon, trainer, trained, forward_backward):
    """Phase 12: two training steps (``forward_backward``, then
    ``trainer.step``) with every parameter and its momentum held against
    ``plain_sgd`` on the same weights and gradients, the momentum carried
    by the plain rule. At the second step two probe Trainers redo the
    step from the same weights and gradients, one with fresh momenta
    (momentum not carried over), one without wd; the check must reject
    both. Returns the two steps' losses."""
    index = {p.name: i for i, p in enumerate(trainer._params)}

    def weights():
        return {n: p.data().data.detach().clone() for n, p in trained}

    def momenta(tr):
        return {n: tr._updaters[0].states[index[p.name]].data.clone()
                for n, p in trained}

    def set_weights(ws):
        with torch.no_grad():
            for n, p in trained:
                p.data().data.copy_(ws[n])

    def worst(got, want):
        per = {n: float((got[n].double() - w).norm()
                        / w.norm().clamp_min(1e-30)) for n, w in want.items()}
        n = max(per, key=per.get)
        return per[n], n

    def compare(w_got, m_got, expect):
        we, wn = worst(w_got, {n: e[0] for n, e in expect.items()})
        me, mn = worst(m_got, {n: e[1] for n, e in expect.items()})
        fails = (["weights"] if we > SGD_W_REL_LIMIT else []) + \
            (["momenta"] if me > SGD_MOM_REL_LIMIT else [])
        return {"weight_rel_l2_worst": we, "worst_weight": wn,
                "momentum_rel_l2_worst": me, "worst_momentum": mn}, fails

    mom = {n: torch.zeros_like(p.data().data, dtype=torch.float64)
           for n, p in trained}
    losses, steps, probes = [], [], {}
    for k in range(2):
        before = weights()
        carried = momenta(trainer) if k else None
        loss = forward_backward()
        grads = {n: p.grad().data.clone() for n, p in trained}
        trainer.step(GLUON_BATCH)
        expect = {n: plain_sgd(before[n], grads[n], mom[n], p)
                  for n, p in trained}
        after = weights()
        summ, fails = compare(after, momenta(trainer), expect)
        losses.append(float(loss.data.detach().mean()))
        steps.append({"step": k + 1, "loss": losses[-1], **summ,
                      "failures": fails, "grads_unchanged": all(
                          torch.equal(p.grad().data, grads[n])
                          for n, p in trained)})
        mom = {n: e[1] for n, e in expect.items()}
    # the probes redo step 2 from its weights and gradients (the Trainer
    # leaves the gradients as they were), then the weights go back
    for fault in ("momentum not carried over", "wd dropped"):
        probe = gluon.Trainer(trainer._params, "sgd", dict(
            GLUON_HP, wd=0.0) if fault == "wd dropped" else GLUON_HP)
        if fault == "wd dropped":
            for n, p in trained:
                probe._updaters[0].states[index[p.name]] = nd.NDArray(
                    carried[n].clone())
        set_weights(before)
        probe.step(GLUON_BATCH)
        psumm, rejected_by = compare(weights(), momenta(probe), expect)
        probes[fault] = {"rejected_by": rejected_by, **psumm}
        set_weights(after)
    del before, after, grads, expect, mom, carried
    emit({"phase": "gluon_trainer_check", "batch": GLUON_BATCH,
          "optimizer": GLUON_HP, "params": len(trained),
          "against": "the plain SGD-momentum rule in fp64 on the same "
                     "weights and gradients, momentum carried by the rule",
          "limits": {"weight_rel_l2": SGD_W_REL_LIMIT,
                     "momentum_rel_l2": SGD_MOM_REL_LIMIT},
          "steps": steps})
    emit({"phase": "gluon_trainer_fault_probe", "probes": probes})
    for st in steps:
        check(not st["failures"], f"Trainer.step {st['step']} against the "
              f"plain SGD rule: {st}")
        check(st["grads_unchanged"], f"Trainer.step {st['step']} changed "
              "the gradients")
    for fault, pr in probes.items():
        check(pr["rejected_by"], f"the Trainer check passes a planted "
              f"fault: {fault}")
    return losses


def gluon_phases(mt, torch, np, smi, ops):
    """Phases 10-13: the Gluon ResNet-50 v1 forward at batch 8 against
    the CPU, the batch-64 training step with the K4 loss against
    SoftmaxCrossEntropyLoss (and its fault probe), two Trainer steps
    against the plain SGD rule (and their fault probes), and 10 timed
    steps."""
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.name import NameManager
    fb = mt.ops.fused_bn_conv
    gpu = mt.gpu(0)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)

    # 10. the forward of __graft_entry__.entry()'s model, batch 8
    mt.random.seed(SEED)
    net = gluon.model_zoo.vision.get_resnet(1, 50, classes=1000)
    net.initialize(mt.init.Xavier(), ctx=gpu)
    net.hybridize()
    x8 = rng.standard_normal((8, 3, 224, 224)).astype(np.float32)
    out = net(nd.array(x8, ctx=gpu)).asnumpy()
    params = net.collect_params()
    n_params = sum(p.data().size for p in params.values()
                   if "running" not in p.name)
    with NameManager():
        cpu_net = gluon.model_zoo.vision.get_resnet(1, 50, classes=1000)
    mt.interop.gluon_params_from_jax(
        {n: p.data().asnumpy() for n, p in params.items()}, cpu_net, "cpu")
    t_cpu = time.perf_counter()
    with mt.cpu():
        ref = cpu_net(nd.array(x8)).asnumpy()
    t_cpu = time.perf_counter() - t_cpu
    rel = float(np.abs(out - ref).max() / np.abs(ref).max())
    emit({"phase": "gluon_forward", "model": "get_resnet(1, 50, "
          "classes=1000), Xavier, seed 0, hybridized", "batch": 8,
          "parameters": n_params, "shape": list(out.shape),
          "finite": bool(np.isfinite(out).all()),
          "max_abs_logit": float(np.abs(ref).max()), "rel_err": rel,
          "limit": GLUON_FWD_REL_LIMIT, "tf32": False,
          "cpu_forward_s": t_cpu,
          "top1_agreement": float((out.argmax(1) == ref.argmax(1)).mean())})
    check(out.shape == (8, 1000) and np.isfinite(out).all(),
          "gluon forward output")
    check(n_params == 25_575_912, f"ResNet-50 v1 has {n_params} weights")
    check(rel <= GLUON_FWD_REL_LIMIT, f"gluon forward against the CPU: "
          f"{rel}")
    del cpu_net

    # 11. one step at batch 64: the K4 loss against SoftmaxCrossEntropyLoss
    trainer = gluon.Trainer(params, "sgd", GLUON_HP)
    X = nd.array(rng.standard_normal((GLUON_BATCH, 3, 224, 224)).astype(
        np.float32), ctx=gpu)
    Y = nd.array(rng.integers(0, 1000, GLUON_BATCH).astype(np.float32),
                 ctx=gpu)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trained = [(n, p) for n, p in params.items() if p.grad_req != "null"]

    def step_grads(loss_fn):
        with autograd.record():
            logits = net(X)
            loss = loss_fn(logits, Y)
        g_logits = autograd.grad(loss, [logits], retain_graph=True)[0]
        loss.backward()
        torch.cuda.synchronize()
        return (loss.data.detach().clone(), g_logits.data.clone(),
                {n: p.grad().data.clone() for n, p in trained})

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def compare(got, want):
        floor = 1e-6 * max(float(g.norm()) for g in want[2].values())
        per = {n: float((got[2][n] - g).norm()) /
               max(float(g.norm()), 1e-30)
               for n, g in want[2].items()}
        over = {n: per[n] for n, g in want[2].items()
                if float((got[2][n] - g).norm()) >
                GLUON_STEP_LIMITS["param_grad_rel_l2_worst"]
                * float(g.norm()) + floor}
        above_floor = {n: v for n, v in per.items()
                       if float(want[2][n].norm()) > 1e3 * floor}
        worst = max(above_floor, key=above_floor.get)
        summ = {"loss_rel_err": float((got[0] - want[0]).abs().max()
                                      / want[0].abs().max()),
                "logits_grad_rel_l2": rel_l2(got[1], want[1]),
                "param_grad_rel_l2_worst": above_floor[worst],
                "worst_param": worst,
                "param_grad_rel_l2_median": float(np.median(
                    list(above_floor.values()))),
                "params_over_limit": sorted(over)[:5]}
        fails = [k for k in ("loss_rel_err", "logits_grad_rel_l2")
                 if summ[k] > GLUON_STEP_LIMITS[k]]
        if over:
            fails.append("param_grad_rel_l2")
        return summ, fails

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        ref_step = step_grads(ce)
        ref_again = step_grads(ce)
        k4_step = step_grads(nd.softmax_ce)
        probe_step = step_grads(nd.softmax_ce_probe)
    finally:
        torch.backends.cudnn.deterministic = False
    summ, fails = compare(k4_step, ref_step)
    noise, _ = compare(ref_again, ref_step)
    psumm, rejected_by = compare(probe_step, ref_step)
    emit({"phase": "gluon_train_check", "batch": GLUON_BATCH,
          "against": "the same step with gluon.loss.SoftmaxCrossEntropyLoss "
                     "(same params, same batch, deterministic cuDNN)",
          "loss_mean": float(ref_step[0].mean()), **summ,
          "limits": GLUON_STEP_LIMITS, "failures": fails,
          "same_step_twice": {k: noise[k] for k in (
              "loss_rel_err", "logits_grad_rel_l2",
              "param_grad_rel_l2_worst", "worst_param")}})
    emit({"phase": "gluon_train_fault_probe",
          "fault": "softmax_ce forward and backward whose sums skip the "
                   "last column", "rejected_by": rejected_by, **psumm})
    check(not fails, f"gluon training step with the K4 loss: {fails}")
    check(rejected_by, "the gluon step check passes a planted fault")
    del ref_step, ref_again, k4_step, probe_step

    # 13. speed: warm-up steps, then 10 timed, one repeated batch
    def forward_backward():
        with autograd.record():
            loss = nd.softmax_ce(net(X), Y)
        loss.backward()
        return loss

    def train_step():
        loss = forward_backward()
        trainer.step(GLUON_BATCH)
        return loss

    # 12. the first two warm-up steps: Trainer.step against the plain rule
    warmup = sgd_check_phase(torch, nd, gluon, trainer, trained,
                             forward_backward)
    warmup += [float(train_step().data.detach().mean())
               for _ in range(GLUON_WARMUP - len(warmup))]
    gc.collect()
    torch.cuda.synchronize()
    fwd, bwd = ops["softmax_ce"], ops["softmax_ce_bwd"]
    fwd.launches = bwd.launches = 0
    fb.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t1 = time.perf_counter()
    for _ in range(GLUON_STEPS):
        losses.append(train_step().data.detach().mean())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = {"softmax_ce_fwd": fwd.launches,
                "softmax_ce_bwd": bwd.launches}
    other = fb.launch_counts()
    losses = [float(v) for v in losses]
    emit({"phase": "gluon_train_speed", "batch": GLUON_BATCH,
          "steps": GLUON_STEPS, "img_per_s": GLUON_STEPS * GLUON_BATCH / dt,
          "ms_per_step": dt / GLUON_STEPS * 1e3, "dtype": "float32",
          "tf32": False, "launches": launches,
          "launches_per_step": {k: v / GLUON_STEPS
                                for k, v in launches.items()},
          "other_kernels_launched": other,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "warmup_losses": warmup, "losses": losses, "setup_s": t1 - t0,
          "card": smi})
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0] and max(losses) < warmup[0],
          f"the loss did not fall: {warmup} then {losses}")
    check(launches == {"softmax_ce_fwd": GLUON_STEPS,
                       "softmax_ce_bwd": GLUON_STEPS},
          f"K4 launches over {GLUON_STEPS} steps: {launches}")
    check(sum(other.values()) == 0, f"the Gluon path launched {other}")
    return launches


# ---------------------------------------------------------------------------
# bench.py main()'s phase A2 (fit with metrics and a Speedometer) and
# phase E (the non-finite step guard; checkpoints) on the port
# ---------------------------------------------------------------------------
FIT_EPOCHS = 2
FIT_BATCHES = 40          # an epoch: the 4 staged batches, cycled
SPEEDO_FREQUENT = 20
FIT_CHECK_STEPS = 10      # steps whose counters are held against the host
FIT_TOP_K = 5
# guarded and unguarded step runs, in this order, AB_STEPS steps each
GUARD_AB_RUNS = ("guarded", "unguarded", "unguarded", "guarded", "guarded",
                 "unguarded", "unguarded", "guarded")
ABORT_AFTER = 2           # MXTPU_FT_MAX_CONSEC_SKIPS in the abort check
RESUME_STEPS = 3


def four_batches(mt, batches):
    """A data iterator over the staged batches (on the card), one pass
    of them an epoch; ``io.ResizeIter`` cycles it to an epoch's length,
    as bench.py's phase A2 cycles its batches."""
    class _Staged(mt.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=TRAIN_BATCH)
            self.i = 0
            self.provide_data = [mt.io.DataDesc(
                "data", tuple(batches[0].data[0].shape))]
            self.provide_label = [mt.io.DataDesc(
                "softmax_label", tuple(batches[0].label[0].shape))]

        def reset(self):
            self.i = 0

        def next(self):
            if self.i >= len(batches):
                raise StopIteration
            self.i += 1
            return batches[self.i - 1]
    return _Staged()


def fit_run(mt, torch, batches, metric, sync_window):
    """One ``Module.fit`` of phase A2 on a fresh Module (the phase-7
    configuration): 2 epochs of 40 batches, ``metric``, a
    ``Speedometer(128, 20)``. With ``sync_window`` every step between two
    metric reads runs under ``torch.cuda.set_sync_debug_mode("error")``,
    so a host sync there raises. Returns (model, epoch end times, steps
    run in the window, registry delta, launches)."""
    from mxnet_tpu_torch import profile_training as pt
    fb = mt.ops.fused_bn_conv
    model = pt.build_module(TRAIN_BATCH, SEED)
    it = mt.io.ResizeIter(four_batches(mt, batches), FIT_BATCHES)
    speedo = mt.callback.Speedometer(TRAIN_BATCH, SPEEDO_FREQUENT)
    marks, window, events = [], [0], []

    def on_batch(param):
        last = param.nbatch == FIT_BATCHES - 1
        if torch.cuda.get_sync_debug_mode() == 2:
            window[0] += 1
        if param.epoch == FIT_EPOCHS - 1:
            # one event a step on the card's clock (no sync)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        # the metric is read at the Speedometer interval and (after the
        # last batch) by the epoch log: syncs are allowed there
        if last or param.nbatch % SPEEDO_FREQUENT == 0:
            torch.cuda.set_sync_debug_mode(0)
        speedo(param)
        if last:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        elif sync_window and (param.epoch, param.nbatch) >= \
                (0, SPEEDO_FREQUENT):
            torch.cuda.set_sync_debug_mode("error")

    torch.cuda.synchronize()
    # the retrace guard keys entry points by name, and every Module of
    # this symbol shares one: start this fit's report from nothing
    mt.compile_report(reset=True)
    totals0 = registry_totals(mt)
    fb.reset_launch_counts()
    try:
        model.fit(it, eval_metric=metric, batch_end_callback=on_batch,
                  kvstore=None, optimizer="sgd",
                  optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                    "wd": 1e-4},
                  num_epoch=FIT_EPOCHS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return (model, marks, window[0], registry_delta(
        totals0, registry_totals(mt)), fb.launch_counts(),
        statistics.median(gaps))


def top_k_rows(np, out, labels, k):
    """Per row of a step's outputs: the host path's top-k hit
    (``numpy.argsort``, as ``metric.TopKAccuracy``) and whether the row
    ties at its k-th score (where the two orders may differ)."""
    x = out.float().cpu().numpy()
    lab = labels.cpu().numpy().astype(np.int64)
    order = np.argsort(x, axis=-1)[:, ::-1]
    host_hit = (order[:, :k] == lab[:, None]).any(1)
    srt = -np.sort(-x, axis=1)
    return host_hit, srt[:, k - 1] == srt[:, k]


def fit_phase(mt, torch, np, smi, batches, bare):
    """Phase A2 of bench.py main() on the port: ``Module.fit`` with
    ``CompositeEvalMetric([Accuracy(), TopKAccuracy(5)])`` counted inside
    the captured step, against the same fit whose metrics are
    ``CustomMetric``s (the host path: every step's outputs are copied to
    the host). Then the in-step counters against the host path on the
    same step outputs for 10 steps. Returns the in-step fit's launches
    and steps."""
    from mxnet_tpu_torch import profile_training as pt
    from mxnet_tpu_torch.metric_device import top_k_hits

    def acc_fn(label, pred):
        return float((pred.argmax(1) == label.astype(np.int64)).sum()), \
            len(label)

    def top5_fn(label, pred):
        top = np.argsort(pred, axis=-1)[:, -FIT_TOP_K:]
        return float((top == label.astype(np.int64)[:, None]).any(1)
                     .sum()), len(label)

    def in_step():
        return mt.metric.CompositeEvalMetric(
            [mt.metric.Accuracy(), mt.metric.TopKAccuracy(top_k=FIT_TOP_K)])

    def host_path():
        return mt.metric.CompositeEvalMetric(
            [mt.metric.CustomMetric(acc_fn, name="accuracy"),
             mt.metric.CustomMetric(top5_fn, name="top_k_accuracy_5")])

    em = in_step()
    model, marks, window, delta, launches, event_ms = fit_run(
        mt, torch, batches, em, True)
    steps = FIT_EPOCHS * FIT_BATCHES
    ms = (marks[1] - marks[0]) * 1e3 / FIT_BATCHES
    name = next(iter(model._fused._programs.values())).key.name
    events = mt.compile_report()["retraces"].get(name, {}).get("events",
                                                               [])
    attach_event = events[-1] if events else None
    in_step_values = em.get()

    # the counters against the host path on the same outputs (copies).
    # After 80 steps over 4 batches the model has learnt their labels:
    # every other row gets another label, so about half the rows miss
    gen = torch.Generator(device=batches[0].label[0].device) \
        .manual_seed(SEED + 7)
    classes = model.output_shapes[0][1][1]
    check_batches = []
    for b in batches:
        lab = b.label[0].clone()
        lab[1::2] = (lab[1::2] + torch.randint(
            1, classes, lab[1::2].shape, generator=gen, device=lab.device,
            dtype=lab.dtype)) % classes
        check_batches.append(mt.io.DataBatch([b.data[0]], [lab]))
    em.reset()
    ref_acc = mt.metric.Accuracy()
    host_hits, tie_rows, mismatch_rows, dev_hits = 0, 0, [], 0
    for i in range(FIT_CHECK_STEPS):
        b = check_batches[i % 4]
        pt.run_step(model, b)
        model.update_metric(em, b.label)
        out = model.get_outputs()[0]
        ref_acc.update_dict({"softmax_label": b.label[0]},
                            {"softmax_output": out})
        host_hit, tie = top_k_rows(np, out, b.label[0], FIT_TOP_K)
        dev_hit = top_k_hits(out, b.label[0], FIT_TOP_K).cpu().numpy()
        host_hits += int(host_hit.sum())
        dev_hits += int(dev_hit.sum())
        tie_rows += int(tie.sum())
        differ = np.nonzero(host_hit != dev_hit)[0]
        mismatch_rows += [(i, int(r)) for r in differ]
        check(all(tie[differ]),
              f"top-{FIT_TOP_K} rows {differ} of step {i} disagree "
              "without a tie at the k-th score")
    acc_m, topk_m = em.metrics
    acc_m.get()
    topk_m.get()
    # the fit's own step (its program has the metric slots) outside fit
    same_module = timed_runs(torch, lambda i: pt.run_step(
        model, batches[i % 4]), AB_STEPS)
    counters = {"accuracy": {"in_step": acc_m.sum_metric,
                             "host": ref_acc.sum_metric,
                             "num_inst": acc_m.num_inst},
                f"top_{FIT_TOP_K}": {"in_step": topk_m.sum_metric,
                                     "host": host_hits,
                                     "rows_with_a_tie_at_k": tie_rows,
                                     "rows_that_differ": len(mismatch_rows),
                                     "num_inst": topk_m.num_inst}}
    del model, em
    gc.collect()
    torch.cuda.empty_cache()

    # the "before": the same fit with the metrics on the host path
    hm = host_path()
    model_h, marks_h, _, delta_h, _, event_ms_h = fit_run(
        mt, torch, batches, hm, False)
    ms_h = (marks_h[1] - marks_h[0]) * 1e3 / FIT_BATCHES
    host_values = hm.get()
    del model_h
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": "fit", "batch": TRAIN_BATCH, "epochs": FIT_EPOCHS,
           "batches_per_epoch": FIT_BATCHES,
           "metric": "CompositeEvalMetric([Accuracy(), "
                     f"TopKAccuracy(top_k={FIT_TOP_K})])",
           "callback": f"Speedometer({TRAIN_BATCH}, {SPEEDO_FREQUENT})",
           "epoch1_img_per_s": FIT_BATCHES * TRAIN_BATCH
           / (marks[1] - marks[0]),
           "epoch1_ms_per_step": ms,
           "epoch1_event_ms_between_steps": event_ms,
           "bare_replay_ms_per_step": bare,
           "vs_bare_replay": ms / bare - 1.0,
           "same_module_outside_fit": {
               k: same_module[k] for k in ("host_ms", "event_ms")},
           "metric_values": in_step_values,
           "compile_report_delta": delta,
           "metric_attach_event": attach_event,
           "launches": {k: launches[w] for k, w in KERNEL_WRAPPERS.items()},
           "launches_per_step": {k: launches[w] / steps
                                 for k, w in KERNEL_WRAPPERS.items()},
           "no_host_sync_window": {
               "steps": window,
               "how": "torch.cuda.set_sync_debug_mode('error') from the "
                      "first Speedometer read of epoch 0 on, lifted only "
                      "around each metric read (Speedometer every 20 "
                      "batches, the epoch log): a host sync inside "
                      "raises"},
           "counters_vs_host": counters,
           "host_path_fit": {
               "metric": "CompositeEvalMetric of two CustomMetrics "
                         "(accuracy, top-5) on the host",
               "epoch1_img_per_s": FIT_BATCHES * TRAIN_BATCH
               / (marks_h[1] - marks_h[0]),
               "epoch1_ms_per_step": ms_h,
               "epoch1_event_ms_between_steps": event_ms_h,
               "metric_values": host_values,
               "compile_report_delta": delta_h},
           "in_step_vs_host_path": ms / ms_h - 1.0,
           "card": smi}
    emit(row)
    check(delta["fresh_compiles"] == 1 and delta["retraces"] == 1
          and delta["replays"] == steps - 1,
          f"fit: one capture (with the metric slots), one retrace (the "
          f"attach) and replays after it expected: {delta}")
    check(attach_event is not None
          and attach_event.get("detail") == ["extra.metrics"],
          f"the retrace guard did not name the metric material: "
          f"{attach_event}")
    # epoch 0 from the step after its Speedometer read, every later
    # epoch from its second step (its first follows the epoch log)
    want_window = FIT_BATCHES - SPEEDO_FREQUENT - 1 + \
        (FIT_EPOCHS - 1) * (FIT_BATCHES - 1)
    check(window == want_window,
          f"{window} steps ran under the sync check, {want_window} due")
    for k, w in KERNEL_WRAPPERS.items():
        want = {"K1": 28, "K2": 60, "B1": 44, "B2": 44}[k] * steps
        check(launches[w] == want,
              f"fit launched {k} {launches[w]} times, {want} expected")
    check(counters["accuracy"]["in_step"] == counters["accuracy"]["host"]
          and acc_m.num_inst == FIT_CHECK_STEPS * TRAIN_BATCH,
          f"in-step accuracy against the host path: {counters}")
    check(abs(topk_m.sum_metric - host_hits) <= tie_rows
          and topk_m.sum_metric == dev_hits,
          f"in-step top-{FIT_TOP_K} against the host path: {counters}")
    check(delta_h["fresh_compiles"] == 1 and delta_h["retraces"] == 0,
          f"the host-path fit captured anew: {delta_h}")
    return launches, steps


def guard_state(f):
    """The state a guarded step must keep on a skip, as copies: the fp32
    masters, momenta, aux and the metric counters (when any)."""
    out = {"weights": {n: p.detach().clone() for n, p in f._p.items()},
           "momentum": {n: s[0].clone() for n, s in f._state.items()},
           "aux": {n: v.clone() for n, v in f._aux.items()}}
    if f.num_metric_slots:
        out["counters"] = {str(i): f.metric_state(i).clone().reshape(1)
                           for i in range(f.num_metric_slots)}
    return out


def poisoned_step(torch, mt, model, batch, metric=None):
    """One step of ``model`` with ``nan_grad`` armed at it: the state
    before and after it, and the registry delta; then ``update_metric``
    (the counters moved, or not, inside the step)."""
    from mxnet_tpu_torch import faultinject, profile_training as pt
    f = model._fused
    torch.cuda.synchronize()
    before = guard_state(f)
    totals0 = registry_totals(mt)
    with faultinject.inject(f"nan_grad:step={f.num_update}"):
        pt.run_step(model, batch)
    torch.cuda.synchronize()
    after = guard_state(f)
    delta = registry_delta(totals0, registry_totals(mt))
    if metric is not None:
        model.update_metric(metric, batch.label)
    return before, after, delta


def ft_guard_phase(mt, torch, smi, batches):
    """Phase E of bench.py main(), first half: guarded and unguarded
    captured steps interleaved (the overhead of the guard); a planted
    ``nan_grad`` step that must leave params, momenta, aux and the
    metric counters bit-identical with no new capture, with its fault
    probe (a guard captured with its select bypassed); and the lagged
    abort of ``MXTPU_FT_MAX_CONSEC_SKIPS``. Returns the guarded Module
    for the checkpoint phase."""
    from mxnet_tpu_torch import config, faultinject, profile_training as pt
    from mxnet_tpu_torch.module import fused as fused_mod
    guarded = pt.build_module(TRAIN_BATCH, SEED)
    with config.override("MXTPU_FT_GUARD", "0"):
        plain = pt.build_module(TRAIN_BATCH, SEED)
    check(guarded._fused.guard_enabled and not plain._fused.guard_enabled,
          "MXTPU_FT_GUARD did not select the guard")
    for m in (guarded, plain):
        for i in range(3):
            pt.run_step(m, batches[i % 4])
    runs = []
    for mode in GUARD_AB_RUNS:
        m = guarded if mode == "guarded" else plain
        r = timed_runs(torch, lambda i: pt.run_step(m, batches[i % 4]),
                       AB_STEPS)
        runs.append(dict(r, mode=mode))
    modes = ("guarded", "unguarded")
    host = ab_summary(runs, "host_ms", modes)
    event = ab_summary(runs, "event_ms", modes)
    launches_g = pt.step_program(guarded).launches
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    # a planted NaN step on the captured, guarded step with a metric slot
    acc = mt.metric.Accuracy()
    for i in range(2):      # the attach, then the capture with the slot
        pt.run_step(guarded, batches[i])
        guarded.update_metric(acc, batches[i].label)
    mt.fault_report(reset=True)
    before, after, delta = poisoned_step(torch, mt, guarded, batches[2],
                                         acc)
    skip = state_diff(torch, after, before)
    rep1 = mt.fault_report()
    pt.run_step(guarded, batches[3])
    guarded.update_metric(acc, batches[3].label)
    rep2 = mt.fault_report()

    # the fault probe: the same guard captured with its select bypassed
    real_select = fused_mod._select_
    probe = pt.build_module(TRAIN_BATCH, SEED)
    pt.run_step(probe, batches[0])          # the warm step (eager)

    def bypassed(finite, new, old):
        old.copy_(new)

    fused_mod._select_ = bypassed
    try:
        pt.run_step(probe, batches[1])      # the capture, with the fault
    finally:
        fused_mod._select_ = real_select
    pb, pa, _ = poisoned_step(torch, mt, probe, batches[2])
    probe_diff = state_diff(torch, pa, pb)
    del probe, pb, pa
    gc.collect()
    torch.cuda.empty_cache()

    # the lagged abort: MXTPU_FT_MAX_CONSEC_SKIPS=2, three poisoned steps
    with config.override("MXTPU_FT_MAX_CONSEC_SKIPS", str(ABORT_AFTER)):
        ab = pt.build_module(TRAIN_BATCH, SEED)
    for i in range(2):
        pt.run_step(ab, batches[i])
    ran, raised = 0, None
    with faultinject.inject("nan_grad:times=3"):
        try:
            for i in range(3 + 2 * ABORT_AFTER + 2):
                pt.run_step(ab, batches[i % 4])
                ran += 1
        except mt.MXNetError as e:
            raised = str(e)
    del ab
    gc.collect()
    torch.cuda.empty_cache()
    mt.fault_report(reset=True)

    g, u = host["guarded"]["median"], host["unguarded"]["median"]
    row = {"phase": "ft_guard", "batch": TRAIN_BATCH,
           "steps_per_run": AB_STEPS, "order": list(GUARD_AB_RUNS),
           "host_ms_per_step": host, "event_ms_per_step": event,
           "overhead": g / u - 1.0,
           "event_overhead": event["guarded"]["median"]
           / event["unguarded"]["median"] - 1.0,
           "bar": "< 0.02 of the step",
           "guarded_program_launches": launches_g,
           "skip": {"state": skip, "fault_report_after_skip": rep1,
                    "fault_report_after_clean_step": rep2,
                    "compile_report_delta": delta},
           "fault_probe": {"fault": "the guard's select bypassed in the "
                                    "captured update (new values copied "
                                    "in unconditionally)",
                           "state": probe_diff},
           "abort": {"MXTPU_FT_MAX_CONSEC_SKIPS": ABORT_AFTER,
                     "poisoned_steps": 3, "raised_at_step": ran + 1,
                     "error": raised},
           "card": smi}
    emit(row)
    check(all(v["bit_identical"] for v in skip.values()),
          f"a skipped step changed the state: {skip}")
    check(len(after.get("counters", ())) == 1,
          "the skip check held no metric counter")
    check((rep1["skipped_steps"], rep1["consecutive_skips"]) == (1, 1)
          and (rep2["skipped_steps"], rep2["consecutive_skips"]) == (1, 0),
          f"fault_report after the skip {rep1}, after a clean step {rep2}")
    check(delta["fresh_compiles"] == 0 and delta["retraces"] == 0
          and delta["replays"] == 1,
          f"the skipped step was not a replay of the captured step: "
          f"{delta}")
    check(not probe_diff["weights"]["bit_identical"],
          "the skip check passes a guard whose select is bypassed")
    check(raised is not None and "consecutive non-finite" in raised
          and ran + 1 <= 2 + 2 * ABORT_AFTER,
          f"MXTPU_FT_MAX_CONSEC_SKIPS={ABORT_AFTER}: raised {raised!r} at "
          f"step {ran + 1}")
    return guarded


def dir_mb(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs) / 1e6


def checkpoint_phase(mt, torch, smi, batches, model):
    """Phase E of bench.py main(), second half: the full training state
    of ``model`` saved by ``CheckpointManager`` synchronously and
    asynchronously (seconds, size); ``RESUME_STEPS`` steps of a fresh
    Module restored from it against the same steps of ``model`` (bit for
    bit), with a probe (a restore without the momenta) that must fail;
    a truncated newest checkpoint that must fall back to the previous."""
    from mxnet_tpu_torch import profile_training as pt
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        sync_dir, async_dir = (os.path.join(tmp, d) for d in ("s", "a"))
        mgr = CheckpointManager(sync_dir, keep=1, async_save=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save_module(model, 1)
        sync_s = time.perf_counter() - t0
        size_mb = dir_mb(mgr._dir_for(1))
        mgr_a = CheckpointManager(async_dir, keep=1, async_save=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr_a.save_module(model, 1)
        submit_s = time.perf_counter() - t0
        # the uninterrupted run goes on while the files land: its replays
        # overwrite the state the snapshot was taken from
        f = model._fused
        losses = []
        for i in range(RESUME_STEPS):
            pt.run_step(model, batches[i])
            losses.append(f.last_loss)
        mgr_a.wait()
        total_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        want = train_state(f, losses)
        same_snapshot = {
            name: open(os.path.join(mgr._dir_for(1), name), "rb").read()
            == open(os.path.join(mgr_a._dir_for(1), name), "rb").read()
            for name in ("params.params", "optimizer.states")}
        del model, f

        def resumed(load_optimizer):
            m = pt.build_module(TRAIN_BATCH, SEED)
            st = mgr.restore(m, load_optimizer=load_optimizer)
            out = []
            for i in range(RESUME_STEPS):
                pt.run_step(m, batches[i])
                out.append(m._fused.last_loss)
            torch.cuda.synchronize()
            return m, st, train_state(m._fused, out)

        fresh, st, got = resumed(True)
        diff = state_diff(torch, got, want)
        del got
        probe_mod, _, probe = resumed(False)
        probe_diff = state_diff(torch, probe, want)
        del probe_mod, probe
        gc.collect()
        torch.cuda.empty_cache()

        # a truncated newest checkpoint falls back to the previous one
        mgr3 = CheckpointManager(sync_dir, keep=3)
        mgr3.save_module(fresh, 2)
        p = os.path.join(mgr3._dir_for(2), "params.params")
        with open(p, "rb+") as fh:
            fh.truncate(os.path.getsize(p) // 2)
        mt.fault_report(reset=True)
        latest = mgr3.load_latest()
        rep = mt.fault_report(reset=True)
        del fresh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": "checkpoint", "batch": TRAIN_BATCH,
           "state": "ResNet-50 (s2d) fp32 masters, SGD momenta, BN aux, "
                    "RNG, metric",
           "size_mb": size_mb, "sync_save_s": sync_s,
           "async_submit_s": submit_s, "async_total_s": total_s,
           "async_total_includes": f"{RESUME_STEPS} steps run while the "
                                   "files were written",
           "async_snapshot_equals_sync": same_snapshot,
           "resume": {"steps": RESUME_STEPS, "epoch": st.epoch,
                      "num_update": st.num_update,
                      "against": "the same steps of the uninterrupted "
                                 "module", "state": diff},
           "resume_fault_probe": {"fault": "restore without the optimizer "
                                           "state (momenta zero)",
                                  "state": probe_diff},
           "fallback": {"newest": 2, "truncated": "params.params to half",
                        "loaded_epoch": latest.epoch if latest else None,
                        "checkpoint_counters": rep["checkpoint"]},
           "card": smi}
    emit(row)
    check(all(same_snapshot.values()),
          f"the async snapshot differs from the sync one taken at the "
          f"same state: {same_snapshot}")
    check(all(v["bit_identical"] for v in diff.values()),
          f"the resumed steps differ from the uninterrupted ones: {diff}")
    check(not probe_diff["weights"]["bit_identical"],
          "the resume check passes a restore without the momenta")
    check(latest is not None and latest.epoch == 1
          and rep["checkpoint"].get("corrupt_detected", 0) >= 1,
          f"the truncated checkpoint did not fall back: {row['fallback']}")


# ---------------------------------------------------------------------------
# decode serving: D1, DecodePredictor + DecodeBatcher, speculative decode,
# disaggregated prefill / decode
# ---------------------------------------------------------------------------
# GPT-2 small's published widths (Radford et al. 2019; the gpt2 config's
# n_vocab / n_embd / n_head / n_layer / n_positions, ffn 4 x n_embd) on the
# repo's own TransformerLMSpec: no biases, a ReLU FFN and an untied head,
# so the widths are GPT-2 small's and the model is not. Depth is not cut.
GPT2_SMALL = {"vocab_size": 50257, "num_embed": 768, "num_heads": 12,
              "num_layers": 12, "max_seq": 1024, "ffn_hidden": 3072}
DECODE_SLOTS = 16
DECODE_BUCKETS = (64, 256, 1024)
DECODE_NEW_TOKENS = 64
DECODE_CLIENTS = (1, 8, 16)
DECODE_REQUESTS = 128      # at each client count, split evenly
DECODE_PROMPT_LENGTHS = (16, 32, 64, 128, 256, 512)
CHECK_PROMPTS = 8          # batched against solo
# 1 to 10 of D1's 64-row chunks by the last token, every prefill bucket
CHECK_PROMPT_LENGTHS = (16, 60, 200, 600)
CHECK_TOKENS = 32
F64_PROMPTS = 4            # held against the f64 plain run
F64_MARGIN = 1e-3          # steps whose f64 top-2 logit gap is smaller
                           # are exempt: f32 rounding may pick either
KV_CACHE_BYTES = {"float32": 1_207_959_552, "int8": 320_864_256}
# D1 against its plain version: the outputs are O(1) averages of the V
# rows; the kernel sums up to 1024 rows in another order (chunks of R
# rows, each against its own max, combined in chunk order) than the plain
# einsum, ~1e-6 apart in f32. The limit leaves 50x room and is far below
# what a missing or extra row moves.
D1_TOL = 5e-5
# D1 against decode_attention_split_plain, the same chunks combined in the
# same order: what is left is the order inside each dot product and sum
# and the exps' last bits, ~1e-7 apart; 10x tighter than D1_TOL.
D1_SPLIT_TOL = 5e-6
D1_REPLACES = ("mxnet_tpu/serving/decode/model.py:375-381 and :448-455 "
               "(decode_step / verify_step attention over the cache, jnp, "
               "XLA-fused; no pallas_call)")
D1_ROWS_SWEEP = (32, 64, 128)
# the kernel's contract beyond the path's shapes, against both plain
# versions: (lanes, W, max_seq, heads, head_dim, cache, rows a chunk)
D1_CONTRACT = ((3, 1, 100, 2, 16, "float32", 64),
               (3, 3, 100, 2, 32, "int8", 32),
               (2, 16, 77, 3, 128, "float32", 32),
               (2, 2, 300, 1, 256, "int8", 64),
               (5, 7, 40, 4, 64, "int8", 128),
               (2, 16, 300, 2, 256, "float32", 64),
               (4, 5, 700, 3, 16, "int8", 128),
               (3, 16, 520, 2, 64, "int8", 32))


def gpt2_spec(mt, name):
    return mt.serving.decode.TransformerLMSpec(name=name, **GPT2_SMALL)


def d1_case(mt, torch, F, gen, kv, width, where, layers):
    """D1 at the decode path's shapes (16 lanes of a 1024-row cache, 12
    heads of 64) at the positions set ``where``: errors against both
    plain versions and the Triton form's, bit-identity from run to run;
    ms cold (the calls rotate over ``cold_turns`` cache buffers) beside the
    Triton form's, the plain version's and SDPA's (f32 only: a yardstick
    the port never calls) and the bound (the rows these positions
    need); ms warm (one buffer back to back) beside the Triton form's;
    the rows sweep, cold."""
    from mxnet_tpu_torch import profile_decode_attention as pda
    da = mt.ops.decode_attention
    positions = pda.POSITION_SETS[where]
    n, m, h, d = layers[0][0].shape
    q = torch.randn(n, width, h, d, device="cuda", generator=gen)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    rows = sum(min(p + width, m) for p in positions)
    nbytes = pda.needed_bytes(positions, width, kv)
    turns = pda.cold_turns(nbytes, len(layers))
    sets = [(q, k, v, pos) + ((ks, vs) if kv == "int8" else ())
            for k, v, ks, vs in layers[:turns]]
    args = sets[0]
    got = da.decode_attention(*args)
    again = da.decode_attention(*args)
    ref = da.decode_attention_plain(*args)
    split = da.decode_attention_split_plain(*args)
    tri = pda.triton_form(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    split_err = float((got - split).abs().max())
    tri_err = float((tri - ref).abs().max())
    cold = {name: time_ms(pda.rotating(fn, sets), inner=turns)
            for name, fn in (("d1", da.decode_attention),
                             ("triton", pda.triton_form),
                             ("plain", da.decode_attention_plain))}
    sweep = {}
    for r in D1_ROWS_SWEEP:
        plan = da._d1_plan(n, width, m, h, d, kv == "int8", r)
        sweep[r] = time_ms(pda.rotating(
            lambda q, k, v, p, ks=None, vs=None, plan=plan:
            da._d1_run(q, k, v, p, ks, vs, plan), sets), inner=turns)
    bound, by = bound_ms(nbytes, 4 * width * rows * h * d, "float32")
    lib_ms = lib_err = None
    if kv == "float32":
        last = pos.long()[:, None] + torch.arange(width, device="cuda")
        mask = (torch.arange(m, device="cuda") <= last[..., None])[:, None]

        def lib(q, k, v, p):
            return F.scaled_dot_product_attention(
                q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                v.permute(0, 2, 1, 3), attn_mask=mask)
        lib_err = float((lib(*args).permute(0, 2, 1, 3) - ref).abs().max())
        lib_ms = time_ms(pda.rotating(lib, sets), inner=turns)
    row = {"phase": "decode_kernel", "kernel": "D1", "route": "cuda",
           "kv_dtype": kv, "width": width, "positions_set": where,
           "lanes": n, "max_seq": m, "heads": h, "head_dim": d,
           "positions": list(positions), "rows": da.D1_ROWS,
           "max_abs_err": err, "tol": D1_TOL,
           "split_max_abs_err": split_err, "split_tol": D1_SPLIT_TOL,
           "repeat_bit_identical": torch.equal(got, again),
           "ms": cold["d1"], "triton_ms": cold["triton"],
           "plain_ms": cold["plain"], "library_ms": lib_ms,
           "timing": f"cold: calls rotate over {turns} cache buffers",
           "warm_ms": time_ms(lambda: da.decode_attention(*args)),
           "triton_warm_ms": time_ms(lambda: pda.triton_form(*args)),
           "warm_timing": "one buffer back to back (its rows in L2)",
           "rows_sweep_ms": sweep, "triton_max_abs_err": tri_err,
           "bound_ms": bound, "bound_by": by,
           "share_of_bound": bound / cold["d1"],
           "bytes_needed": nbytes, "rows_read": rows,
           "library": "F.scaled_dot_product_attention, boolean mask"
           if lib_ms is not None else None, "library_max_abs_err": lib_err}
    if where == "mixed":
        # a lane's output does not depend on the other lanes' positions
        alone = torch.zeros_like(pos)
        alone[4] = pos[4]
        solo = da.decode_attention(q, args[1], args[2], alone, *args[4:])
        torch.cuda.synchronize()
        row["lane_alone_bit_identical"] = torch.equal(solo[4], got[4])
        check(row["lane_alone_bit_identical"],
              f"D1 {kv} W={width}: lane 4 differs when alone")
    emit(row)
    what = f"D1 {kv} W={width} at {where}"
    check(err <= D1_TOL, f"{what}: error {err} > {D1_TOL}")
    check(split_err <= D1_SPLIT_TOL,
          f"{what}: error {split_err} against the split plain version > "
          f"{D1_SPLIT_TOL}")
    check(tri_err <= D1_TOL, f"{what}: the Triton form's error {tri_err}")
    check(row["repeat_bit_identical"], f"{what}: two calls differ")
    return row


def d1_contract(mt, torch, gen):
    """D1 at the contract's other shapes (D1_CONTRACT: every head_dim
    and R template, W up to 16, max_seq not a multiple of R),
    positions from 0 to past max_seq, against both plain versions."""
    da = mt.ops.decode_attention
    dm = mt.serving.decode.model
    cases = []
    for n, w, m, h, d, kv, r in D1_CONTRACT:
        q = torch.randn(n, w, h, d, device="cuda", generator=gen)
        k = torch.randn(n, m, h, d, device="cuda", generator=gen)
        v = torch.randn(n, m, h, d, device="cuda", generator=gen)
        pos = torch.randint(0, m + 3, (n,), device="cuda", generator=gen,
                            dtype=torch.int32)
        pos[0], pos[-1] = 0, m + 2
        ks = vs = None
        if kv == "int8":
            (k, ks), (v, vs) = dm._kv_quant_rows(k), dm._kv_quant_rows(v)
        args = (q, k, v, pos, ks, vs)
        got = da._d1_run(*args, da._d1_plan(n, w, m, h, d, kv == "int8", r))
        ref = da.decode_attention_plain(*args)
        split = da.decode_attention_split_plain(*args, rows=r)
        torch.cuda.synchronize()
        case = {"shape": [n, w, m, h, d], "kv_dtype": kv, "rows": r,
                "positions": pos.tolist(),
                "max_abs_err": float((got - ref).abs().max()),
                "split_max_abs_err": float((got - split).abs().max())}
        cases.append(case)
        check(case["max_abs_err"] <= D1_TOL
              and case["split_max_abs_err"] <= D1_SPLIT_TOL,
              f"D1 contract case {case}")
    emit({"phase": "decode_kernel_contract", "tol": D1_TOL,
          "split_tol": D1_SPLIT_TOL, "cases": cases})


def decode_kernel_phase(mt, torch, F, gen):
    """D1 at W = 1 (decode) and W = 5 (verify at k = 4), f32 and int8, at
    each of ``profile_decode_attention.POSITION_SETS``; its contract's
    other shapes; then one call it must refuse."""
    from mxnet_tpu_torch import profile_decode_attention as pda
    rows = {}
    for kv in ("float32", "int8"):
        layers = pda.cache_buffers(kv, 64 if kv == "int8" else 24, gen)
        for where in pda.POSITION_SETS:
            for w in (1, 5):
                rows[(kv, w, where)] = d1_case(mt, torch, F, gen, kv, w,
                                               where, layers)
        del layers
        gc.collect()
        torch.cuda.empty_cache()
    d1_contract(mt, torch, gen)
    z = torch.zeros(2, 1, 2, 64, device="cuda", dtype=torch.float16)
    try:
        mt.ops.decode_attention.decode_attention(
            z, z, z, torch.zeros(2, dtype=torch.int32, device="cuda"))
        raise AssertionError("D1 accepted float16 on CUDA")
    except mt.MXNetError as e:
        emit({"phase": "decode_kernel", "raises_on_unsupported_dtype":
              str(e)})
    return rows


def f64_reference(mt, torch, spec, p64, prompt, stream):
    """The f64 plain functions on the card (D1's plain version), teacher
    forced along ``stream``: per step the f64 argmax and top-2 gap.
    Returns (steps checked, exempt steps, steps that differ)."""
    dm = mt.serving.decode.model
    da = mt.ops.decode_attention
    real = da.decode_attention
    da.decode_attention = da.decode_attention_plain
    try:
        return _f64_steps(dm, torch, spec, p64, prompt, stream)
    finally:
        da.decode_attention = real


def _f64_steps(dm, torch, spec, p64, prompt, stream):
    caches = [c.double() for c in dm.init_caches(spec, 1, "float32",
                                                  "cuda")]
    plen = len(prompt)
    checked, exempt, differ = 0, 0, []
    with torch.inference_mode():
        for i, tok in enumerate(stream):
            if i == 0:
                _, logits = dm._prefill(
                    spec, p64, caches,
                    torch.tensor(prompt[None], device="cuda"), plen, 0,
                    "float32")
            else:
                _, logits = dm._decode(
                    spec, p64, caches,
                    torch.tensor([stream[i - 1]], dtype=torch.int32,
                                 device="cuda"),
                    torch.tensor([plen + i - 1], dtype=torch.int32,
                                 device="cuda"),
                    torch.ones(1, dtype=torch.bool, device="cuda"),
                    "float32")
                logits = logits[0]
            top = torch.topk(logits, 2)
            if float(top.values[0] - top.values[1]) > F64_MARGIN:
                checked += 1
                if int(top.indices[0]) != tok:
                    differ.append(i)
            else:
                exempt += 1
    return checked, exempt, differ


def captured_vs_eager(torch, np, pred, prompts):
    """One decode step of 8 filled lanes as the captured program and as
    the same functions run eagerly, from the same cache: logits and
    every cache buffer bit for bit."""
    slots = [pred.alloc_slot() for _ in prompts]
    try:
        toks = {s: pred.prefill(s, p) for s, p in zip(slots, prompts)}
        with pred._lock:
            buf = pred._decode_buf(toks)
            snap = [c.clone() for c in pred._caches]
            _, logits = pred._call(("decode",), "decode", None, buf)
            cap = [logits.clone()] + [c.clone() for c in pred._caches]
            for c, s in zip(pred._caches, snap):
                c.copy_(s)
            _, logits = pred._call(("decode",), "decode", None, buf,
                                   eager=True)
            eager = [logits] + list(pred._caches)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(cap, eager))
            diff = float((cap[0] - eager[0]).abs().max())
    finally:
        for s in slots:
            pred.release(s)
    return same, diff


def decode_checks(mt, torch, np, pred, prompts, p64=None):
    """The served-path checks of one DecodePredictor: 8 prompts batched
    against solo (bit for bit), the captured decode step against the
    eager one (bit for bit), and, with ``p64``, the first 4 streams
    against the f64 plain run on every step with a top-2 gap above
    F64_MARGIN. Returns (results, the names of the failed checks,
    the batched streams)."""
    solo = [list(pred.generate(p, max_new_tokens=CHECK_TOKENS))
            for p in prompts]
    bat = mt.serving.decode.DecodeBatcher(pred, max_wait_us=20000,
                                          name=f"{pred.name}-check")
    with bat:
        futs = [bat.submit(p, max_new_tokens=CHECK_TOKENS)
                for p in prompts]
        batched = [f.result(timeout=600) for f in futs]
    same, diff = captured_vs_eager(torch, np, pred, prompts)
    res = {"batched_equals_solo": batched == solo,
           "captured_equals_eager": same,
           "captured_vs_eager_max_logit_diff": diff}
    fails = [k for k in ("batched_equals_solo", "captured_equals_eager")
             if not res[k]]
    if p64 is not None:
        checked = exempt = 0
        differ = {}
        for i in range(F64_PROMPTS):
            c, e, d = f64_reference(mt, torch, pred.spec, p64, prompts[i],
                                    batched[i])
            checked, exempt = checked + c, exempt + e
            if d:
                differ[i] = d
        res.update({"f64_steps_checked": checked,
                    "f64_steps_exempt": exempt,
                    "f64_differ_at": differ})
        if differ:
            fails.append("f64_greedy_tokens")
    return res, fails, batched


def decode_step_ms(torch, np, pred, position):
    """Device ms of one replay of ``pred``'s captured decode step with all
    16 lanes active at ``position`` (D1 reads position + 1 rows a lane)."""
    prog = pred._programs[("decode",)]
    buf = np.zeros((3, DECODE_SLOTS), np.int32)
    buf[1], buf[2] = position, 1
    with pred._lock, torch.inference_mode():
        pred._stage(prog, buf)
        return time_ms(prog.replay)


def verify_step_ms(torch, np, eng, position):
    """Device ms of one replay of ``eng``'s captured verify step (k = 4,
    W = 5) with all 16 lanes at ``position``."""
    prog = eng._programs[("verify", 5)]
    buf = np.zeros((DECODE_SLOTS, 8), np.int32)
    buf[:, 5:] = (position, 5, 1)
    with eng._lock, torch.inference_mode():
        eng._stage(prog, buf)
        return time_ms(prog.replay)


def decode_serving_phase(mt, torch, np, smi, params):
    """``decode_serving``: DecodePredictor + DecodeBatcher at GPT-2
    small's widths, f32 then int8 cache (see the module docstring)."""
    from mxnet_tpu_torch.serving import loadgen
    dec = mt.serving.decode
    fb = mt.ops.fused_bn_conv
    d1 = mt.ops.decode_attention.decode_attention
    spec = gpt2_spec(mt, "gpt2s")
    prompts = loadgen.mixed_prompts(
        {n: 1 for n in DECODE_PROMPT_LENGTHS}, vocab_size=spec.vocab_size,
        n=DECODE_REQUESTS, seed=SEED)
    # the wheel's order would give a client only some of the lengths
    prompts = [prompts[i]
               for i in np.random.RandomState(SEED).permutation(len(prompts))]
    check_prompts = loadgen.mixed_prompts(
        {n: 1 for n in CHECK_PROMPT_LENGTHS}, vocab_size=spec.vocab_size,
        n=CHECK_PROMPTS, seed=SEED + 1)
    out, launches, f32_streams = {}, {}, None
    keep = None
    for kv in ("float32", "int8"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pred = dec.DecodePredictor(spec, params, slots=DECODE_SLOTS,
                                   seq_buckets=DECODE_BUCKETS,
                                   kv_dtype=kv, name=f"gpt2s-{kv}",
                                   device="cuda:0")
        if kv == "float32":
            params = pred._p            # the staged tensors, shared below
        tot0 = registry_totals(mt)
        n_prog = pred.warmup()
        warm = registry_delta(tot0, registry_totals(mt))
        setup_s = time.perf_counter() - t0
        check(n_prog == len(DECODE_BUCKETS) + 1
              and warm["fresh_compiles"] == len(DECODE_BUCKETS) + 1,
              f"{kv}: warmup captured {warm} for {DECODE_BUCKETS}")
        check(pred.kv_cache_bytes() == KV_CACHE_BYTES[kv],
              f"{kv}: kv_cache_bytes {pred.kv_cache_bytes()}")
        batcher = dec.DecodeBatcher(pred, max_wait_us=2000,
                                    name=f"gpt2s-{kv}")
        batcher.start()
        tot1 = registry_totals(mt)
        steps0 = pred.report()["decode_steps"]
        # the main path: counts set to 0 just before, read just after
        fb.reset_launch_counts()
        runs = {}
        for c in DECODE_CLIENTS:
            r = loadgen.token_closed_loop(batcher, prompts, c,
                                          DECODE_REQUESTS // c,
                                          max_new_tokens=DECODE_NEW_TOKENS)
            runs[c] = {k: r[k] for k in (
                "tok_s", "ttft_p50_ms", "ttft_p99_ms", "inter_token_p50_ms",
                "inter_token_p99_ms", "tokens", "wall_s", "gave_up",
                "by_length")}
            runs[c]["requests"] = DECODE_REQUESTS
            check(r["gave_up"] == 0 and r["tokens"] == DECODE_REQUESTS
                  * DECODE_NEW_TOKENS, f"{kv} at {c} clients: {r}")
        torch.cuda.synchronize()
        n_d1 = d1.launches
        steps = pred.report()["decode_steps"] - steps0
        serving = registry_delta(tot1, registry_totals(mt))
        batcher.stop()
        launches[kv] = {"D1": n_d1, "decode_steps": steps}
        check(serving["fresh_compiles"] == 0 and serving["retraces"] == 0,
              f"{kv}: serving after warmup captured or retraced: {serving}")
        check(steps > 0 and n_d1 == spec.num_layers * steps,
              f"{kv}: {n_d1} D1 launches over {steps} decode steps")
        res, fails, streams = decode_checks(
            mt, torch, np, pred, check_prompts,
            p64={n: t.double() for n, t in pred._p.items()}
            if kv == "float32" else None)
        check(not fails, f"{kv} served-path checks failed: {fails} {res}")
        if kv == "float32":
            f32_streams = streams
        else:
            agree = [a == b for s8, s32 in zip(streams, f32_streams)
                     for a, b in zip(s8, s32)]
            res["int8_tokens_agreeing_with_f32"] = sum(agree) / len(agree)
        # the decode step alone: replays of the captured program with all
        # 16 lanes active at one position (D1 reads position + 1 rows)
        step_ms = {p: decode_step_ms(torch, np, pred, p)
                   for p in (512, 1023)}
        for s in range(DECODE_SLOTS):
            pred.seek_slot(s, 512)
        feed = {s: 1 + s for s in range(DECODE_SLOTS)}
        from mxnet_tpu_torch.profile_training import busy_summary, \
            device_trace
        trace = device_trace(lambda _: pred.decode(feed), 20)
        busy = busy_summary(trace, 20, what="decode_step")
        cost = pred.program_cost("decode")
        out[kv] = {
            "setup_s": setup_s, "programs_captured": warm["fresh_compiles"],
            "serving_registry_delta": serving, "clients": runs,
            "d1_launches": n_d1, "decode_steps": steps,
            "d1_launches_per_step": n_d1 / steps,
            "decode_step_device_ms": {"positions_512": step_ms[512],
                                      "positions_1023": step_ms[1023]},
            "decode_loop_20_steps": {
                k: busy[k] for k in ("traced_wall_ms",
                                     "device_kernel_ms_per_decode_step",
                                     "device_busy_share")},
            "decode_loop_d1_ms_per_step":
                busy["port_kernels_ms_per_decode_step"]["D1"],
            "decode_loop_top_kernels": busy[
                "top_kernels_ms_per_decode_step"][:8],
            "kv_cache_bytes": pred.kv_cache_bytes(),
            "decode_bytes_per_token": pred.decode_bytes_per_token(),
            "reprefill_bytes_per_token_s256":
                pred.reprefill_bytes_per_token(bucket=256),
            "decode_step_bytes_counted": cost["bytes accessed"],
            "decode_step_flops_counted": cost["flops"],
            "decode_step_bound_ms_counted": bound_ms(
                cost["bytes accessed"], cost["flops"], "float32"),
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "checks": res}
        emit(dict({"phase": "decode_serving", "kv_dtype": kv,
                   "slots": DECODE_SLOTS, "buckets": list(DECODE_BUCKETS),
                   "widths": GPT2_SMALL, "card": smi}, **out[kv]))
        check(out[kv]["decode_bytes_per_token"]
              < out[kv]["reprefill_bytes_per_token_s256"],
              f"{kv}: decode bytes per token not below re-prefill's")
        if kv == "float32":
            keep = pred
        else:
            check(out[kv]["decode_bytes_per_token"]
                  < out["float32"]["decode_bytes_per_token"],
                  "int8 decode bytes per token not below f32's")
        del pred, batcher
    check(out["int8"]["kv_cache_bytes"] < out["float32"]["kv_cache_bytes"],
          "int8 cache not smaller")
    d1_fault_probe(mt, torch, np, keep, check_prompts)
    return keep, launches, f32_streams, check_prompts


def d1_fault_probe(mt, torch, np, pred, prompts):
    """The served-path checks on a predictor whose decode program was
    captured with D1's visible range off by one row (one stale row seen):
    they must reject it."""
    da = mt.ops.decode_attention
    real = da.decode_attention

    def off_by_one(q, k, v, positions, k_scale=None, v_scale=None):
        return real(q, k, v, positions + 1, k_scale, v_scale)

    da.decode_attention = off_by_one
    try:
        probe = mt.serving.decode.DecodePredictor(
            pred.spec, pred._p, slots=DECODE_SLOTS,
            seq_buckets=DECODE_BUCKETS, name="gpt2s-probe",
            device="cuda:0")
        probe.warmup()
    finally:
        da.decode_attention = real
    res, fails, _ = decode_checks(mt, torch, np, probe, prompts,
                                  p64={n: t.double()
                                       for n, t in pred._p.items()})
    emit(dict({"phase": "decode_fault_probe",
               "fault": "D1 captured with positions + 1 (one stale row "
                        "visible)", "rejected_by": fails}, **res))
    check(fails, "the decode checks pass D1 with its visible range off "
                 "by one row")
    del probe
    gc.collect()
    torch.cuda.empty_cache()


def spec_decode_phase(mt, torch, np, smi, pred, prompts, plain_streams):
    """``spec_decode``: SpecDecodePredictor over the f32 target with a
    2-layer shrink-2 draft (random, seed 1) at k = 4: streams bit for bit
    the plain ones, accept rate, verify step ms, D1's W = 5 launches."""
    dec = mt.serving.decode
    d1 = mt.ops.decode_attention.decode_attention
    spec = pred.spec
    dspec = dec.make_draft_spec(spec, num_layers=2, shrink=2)
    t0 = time.perf_counter()
    eng = dec.SpecDecodePredictor(
        spec, pred._p, dspec, dec.init_params(dspec, seed=1), k=4,
        slots=DECODE_SLOTS, seq_buckets=DECODE_BUCKETS, name="gpt2s-spec",
        device="cuda:0")
    eng.warmup()
    setup_s = time.perf_counter() - t0
    tot0 = registry_totals(mt)
    v0, d0 = eng.report()["verify_steps"], eng.report()["decode_steps"]
    dd0 = eng.draft.report()["decode_steps"]
    mt.ops.fused_bn_conv.reset_launch_counts()
    with dec.DecodeBatcher(eng, max_wait_us=20000, name="gpt2s-spec") as b:
        futs = [b.submit(p, max_new_tokens=CHECK_TOKENS) for p in prompts]
        streams = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    n_d1 = d1.launches
    rep = eng.report()
    verify_steps, decode_steps = rep["verify_steps"] - v0, \
        rep["decode_steps"] - d0
    draft_steps = eng.draft.report()["decode_steps"] - dd0
    serving = registry_delta(tot0, registry_totals(mt))
    verify_ms = verify_step_ms(torch, np, eng, 512)
    row = {"phase": "spec_decode", "k": 4, "draft": {
        "layers": dspec.num_layers, "embed": dspec.num_embed,
        "heads": dspec.num_heads, "seed": 1}, "setup_s": setup_s,
        "streams_equal_plain": streams == plain_streams,
        "acceptance_rate": rep["spec"]["acceptance_rate"],
        "accepted_per_step": rep["spec"]["accepted_per_step"],
        "degrade_events": rep["spec"]["degrade_events"],
        "verify_steps": verify_steps, "target_decode_steps": decode_steps,
        "draft_decode_steps": draft_steps, "d1_launches": n_d1,
        "d1_launches_w5": spec.num_layers * verify_steps,
        "verify_step_device_ms_positions_512": verify_ms,
        "serving_registry_delta": serving, "card": smi}
    emit(row)
    check(row["streams_equal_plain"], "speculative streams differ from "
                                      "plain decode")
    check(verify_steps > 0, "no verify round ran")
    check(n_d1 == spec.num_layers * (verify_steps + decode_steps)
          + dspec.num_layers * draft_steps,
          f"D1 launches {n_d1} against {verify_steps} verify, "
          f"{decode_steps} decode and {draft_steps} draft steps")
    check(serving["fresh_compiles"] == 0 and serving["retraces"] == 0,
          f"speculative serving captured or retraced: {serving}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return row


def decode_disagg_phase(mt, torch, np, smi, pred, prompts, plain_streams):
    """``decode_disagg``: a prefill-role batcher hands lanes to a
    decode-role one; the streams must equal the unified ones, and with
    every handoff lost (``kv_handoff``) the decode side re-prefills with
    no stream dropped."""
    from mxnet_tpu_torch import faultinject
    dec = mt.serving.decode
    pre_eng = dec.DecodePredictor(pred.spec, pred._p, slots=4,
                                  seq_buckets=DECODE_BUCKETS,
                                  name="gpt2s-pre", device="cuda:0")
    dec_eng = dec.DecodePredictor(pred.spec, pred._p, slots=DECODE_SLOTS,
                                  seq_buckets=DECODE_BUCKETS,
                                  name="gpt2s-dec", device="cuda:0")
    decode_b = dec.DecodeBatcher(dec_eng, max_wait_us=0, name="dis-dec",
                                 role="decode")
    prefill_b = dec.DecodeBatcher(pre_eng, max_wait_us=0, name="dis-pre",
                                  role="prefill")
    decode_b.start()
    prefill_b.set_handoff(
        lambda req, last, produced, lane, t0:
        bool(decode_b.adopt(req, last, produced, lane, t0)) or True)
    prefill_b.start()
    rows = {}
    try:
        for lost in (False, True):
            with (faultinject.inject(kv_handoff={}) if lost
                  else contextlib.nullcontext()):
                futs = [prefill_b.submit(p, max_new_tokens=CHECK_TOKENS)
                        for p in prompts]
                streams = [f.result(timeout=600) for f in futs]
            rp = prefill_b.report(reset=True)
            rd = decode_b.report(reset=True)
            rows["lost" if lost else "handed"] = {
                "streams_equal_unified": streams == plain_streams,
                "handoffs": rp["handoffs"], "adopted": rd["adopted"],
                "cancelled": rd["cancelled"] + rp["cancelled"],
                "shed": rd["shed_requests"] + rp["shed_requests"],
                "handoff_p50_ms": rd["handoff_p50_ms"],
                "ttft_p50_ms": rp["ttft_p50_ms"]}
    finally:
        prefill_b.stop()
        decode_b.stop()
    emit({"phase": "decode_disagg", "card": smi, **rows})
    for what, r in rows.items():
        check(r["streams_equal_unified"] and r["cancelled"] == 0
              and r["shed"] == 0 and r["adopted"] == len(prompts),
              f"disaggregated serving ({what}): {r}")
    del pre_eng, dec_eng
    gc.collect()
    torch.cuda.empty_cache()


def d1_step_ab(mt, torch, np, smi, pred):
    """The captured f32 decode step (all lanes at 512 and at 1023) and
    verify step (k = 4, at 512) with D1's launch swapped to the Triton
    form while they are captured (as ``f64_reference`` swaps the
    wrapper), against the same programs on D1; in turns (Triton, D1, D1,
    Triton), device ms of replays."""
    from mxnet_tpu_torch import profile_decode_attention as pda
    dec = mt.serving.decode
    da = mt.ops.decode_attention
    spec = pred.spec
    dspec = dec.make_draft_spec(spec, num_layers=2, shrink=2)
    draft = dec.init_params(dspec, seed=1)
    real = da.decode_attention
    engines = {}
    for form in ("triton", "d1"):
        da.decode_attention = pda.triton_form if form == "triton" \
            else real
        try:
            one = dec.DecodePredictor(spec, pred._p, slots=DECODE_SLOTS,
                                      seq_buckets=DECODE_BUCKETS,
                                      name=f"gpt2s-ab-{form}",
                                      device="cuda:0")
            one.warmup()
            sp = dec.SpecDecodePredictor(
                spec, pred._p, dspec, draft, k=4, slots=DECODE_SLOTS,
                seq_buckets=DECODE_BUCKETS, name=f"gpt2s-ab-spec-{form}",
                device="cuda:0")
            sp.warmup()
        finally:
            da.decode_attention = real
        engines[form] = (one, sp)
    ms = {f: {"decode_512": [], "decode_1023": [], "verify_512": []}
          for f in engines}
    served = {"decode_512": [], "decode_1023": []}
    order = ("triton", "d1", "d1", "triton")
    for form in order:
        one, sp = engines[form]
        ms[form]["decode_512"].append(decode_step_ms(torch, np, one, 512))
        ms[form]["decode_1023"].append(decode_step_ms(torch, np, one, 1023))
        ms[form]["verify_512"].append(verify_step_ms(torch, np, sp, 512))
        if form == "d1":
            # decode_serving's predictor (D1), after its traffic
            for p in (512, 1023):
                served[f"decode_{p}"].append(
                    decode_step_ms(torch, np, pred, p))
    mean = {f: {k: statistics.mean(v) for k, v in r.items()}
            for f, r in ms.items()}
    emit({"phase": "d1_step_ab", "card": smi, "order": list(order),
          "ms": ms, "mean_ms": mean, "decode_serving_predictor_ms": served,
          "d1_minus_triton_ms": {k: mean["d1"][k] - mean["triton"][k]
                                 for k in mean["d1"]},
          "what": "captured f32 steps, 16 lanes; Triton: the first D1 "
                  "form captured in place of D1"})
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return mean


def decode_phases(mt, torch, np, F, smi, gen):
    """Every decode phase; returns the kernels line's D1 entry."""
    t0 = time.perf_counter()
    d1_rows = decode_kernel_phase(mt, torch, F, gen)
    params = mt.serving.decode.init_params(gpt2_spec(mt, "gpt2s"), seed=0)
    pred, launches, streams, prompts = decode_serving_phase(
        mt, torch, np, smi, params)
    del params
    spec_decode_phase(mt, torch, np, smi, pred, prompts, streams)
    decode_disagg_phase(mt, torch, np, smi, pred, prompts, streams)
    step_ab = d1_step_ab(mt, torch, np, smi, pred)
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    r = d1_rows[("float32", 1, "mixed")]
    emit({"phase": "decode_seconds", "seconds": time.perf_counter() - t0})
    return {"name": "decode_attention", "route": "cuda",
            "source": "mxnet_tpu_torch/kernels/csrc/decode_attention.cu",
            "replaces": D1_REPLACES,
            "launches": sum(v["D1"] for v in launches.values()),
            "launches_by_cache": launches,
            "max_abs_err": max(x["max_abs_err"] for x in d1_rows.values()),
            "ms": r["ms"], "triton_ms": r["triton_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": "float32", "rows": r["rows"], "timing": r["timing"],
            "triton_source": "mxnet_tpu_torch/kernels/"
                             "decode_attention_triton.py",
            "per": "one decode call (W = 1, f32 cache) of 16 lanes at "
                   "the mixed positions, 12 heads of 64, max_seq 1024",
            "cases": [{k: x[k] for k in (
                "kv_dtype", "width", "positions_set", "ms", "triton_ms",
                "warm_ms", "triton_warm_ms", "plain_ms", "bound_ms",
                "library_ms", "max_abs_err", "split_max_abs_err")}
                for x in d1_rows.values()],
            "step_ab_mean_ms": step_ab,
            "path": "decode_serving (token_closed_loop at 1, 8 and 16 "
                    "clients, f32 then int8 cache), counts set to 0 just "
                    "before each run", "status": "ok"}


def k4_entry(rows, name, route, launches, what):
    """A K4 user kernel's entry of the kernels line: its times at
    ``what``; launches on its path (the softmax CE's on the Gluon
    training path, the others' through nd and autograd)."""
    r = rows[(name, what)]
    return {"name": name, "route": route, "source": "chip_smoke.py",
            "replaces": K4_REPLACES, "launches": launches,
            "max_abs_err": max(rows[(name, w)]["max_abs_err"]
                               for (n, w) in rows if n == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dtype": "float32",
            "shapes": r["shapes"], "per": f"one call at the {what}",
            "path": ("the Gluon ResNet-50 training step at batch 64 "
                     "(10 steps)" if name.startswith("softmax_ce")
                     else "nd.<name> and autograd on cuda:0"),
            "hook": "operator.UserKernel (K4)", "status": "ok"}


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
                              dtype, expect="wgmma" if dtype == "bfloat16"
                              else "fp32")
                if dtype == "bfloat16":
                    per_fwd["bn_relu_conv1x1"][(d, w)] = (count, row)
        else:
            row = k2_case(mt, torch, F, gen, b, c, h, wd, relu, "bfloat16")
            per_fwd["bn_prologue"][(d, relu)] = (count, row)
    emit({"phase": "k1_serving_sites", "batch": batch, "sites": [
        {"x": r["x"], "O": r["O"], "sites_per_forward": n,
         "route": r["route"], "ms": r["ms"], "wmma_ms": r["wmma_ms"],
         "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "plain_ms": r["plain_ms"],
         "library_ms": r["library_ms"]}
        for n, r in per_fwd["bn_relu_conv1x1"].values()]})
    k1_host_cost(mt, torch, gen)
    # ragged edges: odd channels, odd and even spatial extents (every
    # vector width of the bf16 kernel), tiny batches, a misaligned x
    for b, c, h, wd, o in ((2, 3, 1, 7, 5), (3, 33, 9, 13, 65),
                           (1, 100, 7, 7, 130), (3, 33, 4, 6, 65),
                           (2, 17, 4, 5, 9), (5, 40, 1, 2, 70)):
        for dtype in ("bfloat16", "float32"):
            expect = "wmma" if dtype == "bfloat16" else "fp32"
            k1_case(mt, torch, F, gen, b, c, h, wd, o, True, dtype,
                    timed=False, expect=expect)
            k1_case(mt, torch, F, gen, b, c, h, wd, o, False, dtype,
                    timed=False, expect=expect)
        k2_case(mt, torch, F, gen, b, c, h, wd, False, "bfloat16",
                timed=False)
        k2_case(mt, torch, F, gen, b, c, h, wd, True, "float32",
                timed=False)
    k1_case(mt, torch, F, gen, 3, 16, 4, 8, 24, True, "bfloat16",
            timed=False, misalign=True, expect="wmma")
    for (b, c, h, wd, o), route in K1_WGMMA_RAGGED:
        for relu in (True, False):
            k1_case(mt, torch, F, gen, b, c, h, wd, o, relu, "bfloat16",
                    timed=False, expect=route)
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

    # 3b. each kernel of the captured paths inside a CUDA graph ---------------
    capture_smoke(mt, torch, gen)

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
    batcher.start()          # warms and captures every bucket
    setup_s = time.perf_counter() - t0
    check(pred.retraces == len(pred.buckets),
          f"{pred.retraces} programs captured for {pred.buckets}")
    totals0 = registry_totals(mt)
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
    serving_routes = fb.route_counts()["bn_relu_conv_nchw"]
    n_calls = calls() - calls0
    serving_registry = registry_delta(totals0, registry_totals(mt))
    check(len(results) == len(reqs), "a request did not complete")
    emit({"phase": "serving_launches", "bucket_calls": n_calls,
          "launches": launches, "k1_routes": serving_routes,
          "per_bucket_call": {k: v / max(n_calls, 1)
                              for k, v in launches.items()},
          "counted_from": "CUDA graph replays (compile registry)",
          "compile_report_delta": serving_registry})
    check(serving_registry["replays"] == n_calls
          and serving_registry["fresh_compiles"] == 0
          and serving_registry["retraces"] == 0,
          f"after warm-up every bucket call must be a replay of a "
          f"captured program: {serving_registry} over {n_calls} calls")
    check(n_calls >= 1 and launches["bn_relu_conv_nchw"] == 28 * n_calls
          and launches["bn_act_prologue"] == 17 * n_calls,
          f"kernel launches {launches} over {n_calls} bucket calls")
    check(sum(serving_routes[r] for r in WGMMA_ROUTES) == 28 * n_calls,
          f"serving K1 routes {serving_routes} over {n_calls} bucket "
          "calls: the 28 K1 sites of a forward must take the wgmma core")
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
    # the checks above must reject it. A replay calls no Python, so the
    # fault goes into a bucket-64 Predictor captured while it is planted
    real_k1 = fb.bn_relu_conv_nchw
    calls_k1 = [0]

    def faulty_k1(x, w, scale, shift, relu=True):
        calls_k1[0] += 1
        if calls_k1[0] % 28 == FAULT_SITE:
            w = w.clone()
            w[:, :32] = 0
        return real_k1(x, w, scale, shift, relu)

    fb.bn_relu_conv_nchw = faulty_k1
    try:
        fault_pred = mt.serving.Predictor(
            sym, args, aux, data_shapes={"data": (3, 224, 224)},
            buckets=(64,), compute_dtype="bfloat16", device="cuda:0")
        faulty = fault_pred.predict(reqs[64])
    finally:
        fb.bn_relu_conv_nchw = real_k1
    check(fault_pred.retraces == 1, "the fault probe's bucket was not "
                                    "captured")
    del fault_pred
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
    serving_captured_check(np, pred, rng)
    serving_ab(torch, smi, pred, x64)

    # 5.-7. training -----------------------------------------------------------
    per_step, k3_default, k1_sites = train_kernel_phase(mt, torch, gen)
    k3_launches, k3_routes = k3_path(mt, torch, gen)
    train_launches, n_steps, train_routes = training_phase(mt, torch, np,
                                                           smi)
    from mxnet_tpu_torch import profile_training as pt
    batches = pt.staged_batches(TRAIN_BATCH, 4, SEED)
    training_captured_check(torch, batches)
    gc.collect()
    torch.cuda.empty_cache()
    ab_row = training_ab(torch, smi, batches)
    gc.collect()
    torch.cuda.empty_cache()
    report = mt.compile_report()
    emit({"phase": "compile_report",
          "programs": [{k: p[k] for k in ("name", "kind", "captures",
                                          "capture_s", "replays")}
                       for p in report["programs"]],
          "totals": report["totals"], "retraces": report["retraces"],
          "retraces_note": "an entry point is a program name: Predictors "
                           "and Modules of one symbol built with another "
                           "configuration (the plain references, the "
                           "fault probe, fp32) count as its retraces; "
                           "the serving and training runs after warm-up "
                           "took none (compile_report_delta in "
                           "serving_launches and training_speed)",
          "cache": report["cache"]})
    check(report["cache"]["enabled"] is False, "compile cache enabled")

    # 7b.-7d. fit, the step guard, checkpoints (bench.py phases A2, E) ------
    fit_launches, fit_steps = fit_phase(
        mt, torch, np, smi, batches,
        ab_row["host_ms_per_step"]["captured"]["median"])
    checkpoint_phase(mt, torch, smi, batches,
                     ft_guard_phase(mt, torch, smi, batches))
    del batches
    gc.collect()
    torch.cuda.empty_cache()

    # 8.-12. K4 and the imperative (Gluon) path ------------------------------
    fns = k4_build(mt)
    ops = k4_register(mt, fns, triton_scale3())
    k4_rows, k4_path_launches = k4_phase(mt, torch, np, ops)
    gluon_launches = gluon_phases(mt, torch, np, smi, ops)
    gc.collect()
    torch.cuda.empty_cache()

    # 14.-17. decode serving at GPT-2 small's widths ----------------------
    d1_entry = decode_phases(mt, torch, np, F, smi, gen)

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
                   "the step's calls)", "status": "ok",
            "fit": {"launches": fit_launches[launch_key],
                    "launches_per_step": fit_launches[launch_key]
                    / fit_steps, "steps": fit_steps,
                    "path": "Module.fit (bench.py phase A2), counts set "
                            "to 0 just before it"}}, **extra)

    pf = "mxnet_tpu/ops/pallas_fused.py"
    k3 = k3_default["bfloat16"]
    emit({"kernels": [
        train_agg("K1", "bn_relu_conv1x1",
                  "mxnet_tpu_torch/kernels/csrc/bn_relu_conv1x1.cu",
                  f"{pf}:234 (_make_nchw_kernel; pallas_call :420)", "cuda",
                  "bn_relu_conv_nchw",
                  {"serving": dict(serving_agg("bn_relu_conv1x1"),
                                   routes=serving_routes),
                   "routes": train_routes, "wmma_ms": sum(
                       r["sites_per_step"] * r["wmma_ms"] for r in k1_sites),
                   "core": "mxnet_tpu_torch/kernels/csrc/"
                           "bn_gemm_wgmma.cuh"}),
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
         "routes": k3_routes, "wmma_ms": k3["wmma_ms"],
         "core": "mxnet_tpu_torch/kernels/csrc/bn_gemm_wgmma.cuh",
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
    ] + [
        k4_entry(k4_rows, name, route, launches, per)
        for name, route, launches, per in (
            ("softmax_ce_fwd", "cuda", gluon_launches["softmax_ce_fwd"],
             "path shape"),
            ("softmax_ce_bwd", "cuda", gluon_launches["softmax_ce_bwd"],
             "path shape"),
            ("user_double", "cuda", k4_path_launches["user_double"],
             "large elementwise"),
            ("user_scale3", "cuda", k4_path_launches["user_scale3"],
             "large elementwise"),
            ("user_scale3_triton", "triton",
             k4_path_launches["user_scale3_triton"], "large elementwise"))
    ] + [d1_entry], "card": smi, "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
