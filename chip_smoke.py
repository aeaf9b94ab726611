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
7e. executor_train (Path E): ResNet-50 (s2d) bound with
   ``sym.simple_bind(ctx=cuda:0, data=(128, 3, 224, 224),
   softmax_label=(128,), grad_req="write")``, fp32, Xavier init from
   seed 0: the train-mode pass sites (28 / 16); three ``forward(
   is_train=True)`` + ``backward()`` (warm, capture, replay) held against
   the same bind with the passes off (loss, every gradient, the aux,
   ``FP32_TRAIN_LIMITS``), a probe with B2's c0 dropped in each backward
   (eager) that must fail it; ``grad_req="add"`` over two backward calls
   against twice the write bind's gradients; K1 (fp32 route) / K2 / B1 /
   B2 launches a step counted from replays (K1 56, B1 and B2 44); eager
   and captured steps in turns (host and event ms, median and spread),
   memory.
7f. module_eager: ``Module(fused=False)`` with Adam on that bind, 5
   steps at batch 128 through the Updater: the first step's update of
   every parameter against Adam in float64 on the same weights and
   gradients (a probe without the bias correction must fail), ms a step
   and the losses.
7g. fused_rules (Path F): the phase-7 configuration (bf16, batch 128)
   with Adam in the captured step: three replays against three eager
   steps (bit-identical or within twice the eager spread: masters, both
   moments, aux, ``t``); a planted NaN step leaves every leaf
   bit-identical and ``t`` advances; Adam's captured step against SGD's
   in turns; then every other rule (lars and signsgd put in the step
   directly) at the same configuration: three replays against eager
   steps of the same module, sgld with its noise at 0 and then its
   noise's variance and fresh draws per replay.
7h. eval_capture: ``Module.forward(is_train=False)`` on the executor's
   captured eval program (fp32) against the eager walk, ``score``
   captured and eager, launches a forward, eager and captured forwards
   in turns (host and event ms).
7i. monitor: ``Monitor(interval=2)`` on the phase-7 configuration's
   Module, eager regime (Adam, fp32) and fused (bf16, SGD): names and
   statistics of the monitored batches against the plain walk's op
   outputs and arguments and the executor's own gradient arrays.
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
17c. lm_fit (slice 11, ``bench.py:401-440`` at its own sizes): the
   corpus's next-char windows of 16, ``np.random.seed(7)``, a shuffled
   ``NDArrayIter`` of 32; ``build_symbol`` of the target
   (``TransformerLMSpec(28, 128, 8 heads, 4 layers, 64)``, 4 epochs) and
   of the draft (``make_draft_spec(spec, 2, 4)``, 6 epochs) through
   ``Module.fit`` on cuda:0 with Adam lr 3e-3, Xavier and
   ``Accuracy(axis=2)`` counted in the captured step: each accuracy at
   least the JAX package's CPU fit's less 0.05 (``LM_JAX_ACC``), ms a
   step, one capture and one retrace (the metric attach) per fit, the
   steps between metric reads under ``set_sync_debug_mode("error")``;
   then (after lm_serve) three replays of each step against three eager
   steps of the same step: masters, both moments and ``t`` bit-identical
   or within twice the eager spread.
17d. lm_serve: ``DecodePredictor.from_module`` on the fitted target
   streams 16 prompts equal to a predictor of cloned weights; one more
   training step of the Module leaves them unchanged; the Module's
   captured eval forward against the prompt program (``_prefill``) at
   every position of 4 windows (probabilities within
   ``LM_EVAL_PROB_LIMIT``, greedy tokens equal where the top-2 logit gap
   exceeds ``F64_MARGIN``).
17e. lm_spec (``bench.py:431-470``): ``SpecDecodePredictor`` of the
   fitted pair (slots 8, buckets (16, 32), k = 4) against the plain
   predictor: streams bit for bit, tokens/s and TTFT p99 at 1 and 8
   clients, accepted tokens per verify round above 1.5, D1's launches
   (W = 5 in the verify steps) counted from replays; then
   ``distill_draft`` at its defaults and its draft's acceptance.
17f. lm_full: ``build_symbol(TransformerLMSpec(**GPT2_SMALL), 1024)`` at
   batch 8 (nothing else cut), fp32 without TF32, Adam lr 3e-4: one
   step's loss and gradients at batch 2 against the float64 plain walk
   (limits from the fp32 plain walk's own error), a probe whose mask
   shows each position its successor must fail it; ``Module.fit`` over
   4 staged batches of random ids (eager, capture, replay), replays
   against eager steps, 10 timed replays (events, tokens/s, memory), a
   device trace (busy share, top kernels, the foreach kernels' share),
   ``from_module``'s prefill token of a 512-token prompt against the
   eval forward's argmax, ``CausalSelfAttention`` forward + backward
   beside SDPA's (a yardstick), Embedding's gradient bit for bit twice.
   ``slice11_seconds`` gives each phase's seconds.
17g. sparse_rows: ``sparse.dedup_rows``, ``segment_rows`` and the lazy
   ``row_update_`` (sgd with momentum, adam) on the card against their
   CPU results (duplicates, the sentinel tail, ids at 0 and vocab - 1, a
   capacity override), two card calls bit for bit, untouched and trash
   rows frozen; a captured dedup replayed under the sync check; a probe
   whose sentinel aliases row 0 must fail the checks.
17h. sparse_fit (``bench.py`` phase H: vocab 100,000, dim 16, batch 256
   x 8 ids, SGD lr 0.1 momentum 0.9, fp32): the routed sparse step and
   the same model on dense ``Embedding``, each captured, timed in turns
   (ms a step by events, rows/s, host ms, the steps' peak allocation,
   update bytes counted from shapes, ``sparse_report()``); replays
   against eager steps bit for bit; a NaN row skipped by the guard
   (table, moments and the other masters bit-identical, ``t`` + 1, as
   the reference advances it); every row touched twice a step, the
   sparse step equal to the dense one bit for bit for sgd and adam.
   Then the vocabulary alone raised to 40,000,000 (a 2.56 GB table):
   the same timings, and the sparse step allocating no table-sized
   gradient where the dense one does.
17i. two_tower: the example at its default sizes (``fit`` over a
   ``DataPipeline`` with a ``CheckpointManager``); a ``sparse_update``
   raise in epoch 2, then ``fit(auto_resume=True)``: tables, moments
   and ``t`` bit for bit an uninterrupted run's; ``Predictor`` on int32
   ids against the module's own forward.
17j. data_pipeline: phase 7's ResNet-50 (s2d, bf16, batch 128, SGD)
   through ``Module.fit`` over an ``NDArrayIter`` of host numpy batches
   with ``MXTPU_DATA_PIPELINE`` 1 and 0 in turns (ms a step, img/s, the
   replay's device ms and busy share, data waits); the parameters
   bit-identical; K1/K2/B1/B2 launches with counts set to 0 just before
   the first fit; the ``data_worker`` fault at ``next()`` and
   ``close()`` within its join limit.
17k. stager_capture: the fused step captured while a ``DataPipeline``
   streams host batches to the card (its stager thread pinning and
   copying on a stream of its own, as under ``fit``): the capture must
   hold, with batches handed over during it. The same in a child
   process with the capture in the global error mode is the fault
   probe: it must fail (the stager's calls invalidate that capture).
   ``slice12_seconds`` gives each phase's seconds.
18a. lstm_cell (slice 13): L1, the LSTM cell's pointwise pass in Triton
   (``kernels/lstm_cell_triton.py``), forward and backward at
   bench_lstm.py's (N, H) = (512, 650), bf16 and fp32, against its plain
   versions (fp32 within ``L1_FP32_TOL``, bf16 within one rounding,
   ``L1_BF16_REL``), ms beside the plain versions' and the bytes bound.
   Beside them ATen's CUDA LSTM cell (``_thnn_fused_lstm_cell`` and its
   backward; timed only, the port never calls it) as ``library_ms``.
18a'. lstm_step (slice 14): the fused bf16 step
   (``kernels/csrc/lstm_step.cu``: the cell in the recurrent product's
   wgmma epilogue forward, dz built as the product's register A operand
   backward, a thread-block cluster summing the K slices), forward and
   backward at (512, 650) against their plain versions within
   ``STEP_TOL``, a repeated backward bit for bit, ms beside the plain
   versions', the library's (``torch.matmul`` with ATen's cell) and the
   bound; then ``lstm_step_sweep``: the forward's four tiles and the
   backward's 4 / 8 / 16 slices (ms, clusters the card holds at once).
18b. rnn_op: the ``RNN`` op (lstm, T 35, N 512, C = H 650, 2 layers)
   forward + backward, bf16 and fp32, against the same op stepping the
   cell in plain PyTorch beside a matmul a step and against cuDNN
   (``torch.nn.LSTM`` with the same weights, timed and compared only:
   the port never calls it), rel L2 within ``RNN_TOL``; bf16 launches
   the fused step once a step and layer each way and no pointwise L1,
   fp32 L1 twice a step and layer, the plain path none. The port and
   the plain path are timed eagerly and as a captured CUDA graph (their
   device time alone), cuDNN eagerly.
18c. lstm_trainstep: bench_lstm.py's configuration, nothing cut (vocab
   33,278, embed 650, 2 x 650 LSTM, batch 512, bptt 35, SGD momentum 0.9
   lr 0.1, bf16 over fp32 masters) through ``parallel.TrainStep``: the
   warm step, the capture, a replay bit for bit against an eager step
   from the same state, captured and eager runs in turns (host and event
   ms, tokens/s), L1's launches a step (140, counted from the replays
   and the eager steps), memory, busy share and the top kernels
   (torch.profiler). Since slice 14 the step runs the fused kernels:
   lstm_step_fwd and lstm_step_bwd 70 times each a step, no pointwise L1.
18d. word_lm: the port's ``train.py`` (the eager Gluon loop) at its
   defaults for one epoch: its validation perplexity within
   ``WLM_PPL_MARGIN`` of the JAX package's CPU figure
   (``WLM_JAX_VAL_PPL``), tokens/s, L1 launches.
18e. lstm_bucketing: the example's defaults for 2 epochs through
   ``BucketingModule.fit``: the final Train-perplexity below 170 and at
   most the first; every executor program captured once and replayed
   (``compile_report()``); ms a step per bucket in epoch 2.
   ``slice13_seconds`` gives each phase's seconds.
18f. telemetry (slice 15): ``bench.py main()``'s ``fit`` (ResNet-50
   s2d, bf16, batch 128, SGD, captured) for ``TELEM_STEPS`` steps with
   ``MXTPU_TELEMETRY_DIR`` and ``MXTPU_TRACE_DIR`` on temporary
   directories (a ``train_step`` event every step), in turns with the
   same fit with them off (``TELEM_RUNS``), on one module whose step is
   captured once before: the median step wall of each run (the
   timeline's ``step::wall_s``) and its spread both ways, the overhead
   (at most ``TELEM_OVERHEAD_MAX``), beside the replay's device ms (CUDA
   events); each traced run's phase self-times within
   ``TELEM_PHASE_TOL`` of its step walls, every step's at most its
   wall, and every step's split printed (the lowest steps, their
   ``unattributed`` time, the steps under the bar); the event log read
   back (``train_step``, ``epoch``) and the
   Chrome trace's ``fit`` -> ``step`` -> ``device_step`` nesting and
   ``data:stage`` spans. ``telemetry_syncs``: the synchronising calls a
   step makes (``torch.cuda.set_sync_debug_mode("warn")``, warnings
   captured), on and off, must be equal. ``telemetry_memory``: the fused
   step's ``memory_report()`` row (pool bytes > 0 and at most
   ``torch.cuda.max_memory_allocated()``), the host ms of one pool
   reading beside the capture's seconds. ``telemetry_profiler``:
   ``profiler.set_state("run")`` around 3 steps, ``dump()``; the trace
   must name K1, K2, B1 and B2's kernels. ``telemetry_serving``: 64
   requests through a ``DynamicBatcher`` on phase 4's Predictor (buckets
   1, 8, 64), traced: each request span has its batch span and a bucket
   span under that; each bucket has a memory row.
   ``telemetry_decode``: a short traced decode run at GPT-2 small's
   widths: prefill / step / request spans, ``serving::<id>::ttft_ms``,
   the KV-cache's ``decode_state`` row.
19. image classification (slice 16), through the examples of
   ``mxnet_tpu_torch.examples.image_classification``:
   19a ``ic_benchmark``: ``train_imagenet --benchmark 1`` (ResNet-50,
   ``stem="std"``, bf16, batch 128) through the example's
   ``_benchmark``: its JSON line, one capture and replays, per step K1
   28 (every one on the wgmma core), K2 62, B1 and B2 45 (the std
   stem's 17 residual sites against phase 7's 16), a finite loss, ms a
   step beside phase 7's captured step. 19b ``ic_fit``: ``common/fit.py``
   ``fit`` with ``--kv-store device``, ResNet-50 fp32, batch 128 over 8
   learnable synthetic batches (2 for validation), 2 epochs with an lr
   step after the first, checkpoints to a temporary prefix, a
   Speedometer: the fused step engaged, one store key per parameter,
   K1 (fp32 route) / K2 / B1 / B2 launches per train step and eval
   forward; ``ic_fit_resume``: ``--load-epoch 1`` loads the saved
   params bit for bit; ``ic_fit_first_step``: one fused step against
   ``Module(fused=False)`` with both passes off from the same params
   and batch, within ``FP32_TRAIN_LIMITS``; ``ic_fit_fusion_ab``: the
   fp32 step with ``MXTPU_PALLAS_FUSION`` on and off in turns. 19c
   ``ic_mnist``: ``train_mnist`` for mlp (the defaults) and lenet (lr
   0.02, batch 32), validation accuracy above 0.95 and 0.9. 19d
   ``ic_score``: ``benchmark_score`` over every network of
   ``get_network`` at batch 32 in bf16: img/s, ms a batch, K1 / K2
   launches a forward (equal to the pass sites) with K1's routes, the
   captured eval output against the fp32 plain graph on the same four
   batches with phase 4's seeded params (top-1 on decisive rows, logit
   errors within the phase-4 limits or twice the plain bf16 graph's), a
   ``torch.profiler`` trace of 5 forwards (device ms a forward, busy
   share, top kernels); ``ic_cifar10_benchmark``:
   ``train_cifar10 --benchmark 1``. ``slice16_seconds`` times them.
20. the kernels line (K1/K2/B1/B2 also with their ``fit``, ``executor``,
   ``fused_adam``, ``data_pipeline`` and ``image_classification``
   launches, D1 with its
   decode_serving launches and its ``lm_spec`` launches, ``lstm_cell``
   with word_lm's (fp32) launches and cuDNN's whole-RNN time,
   ``lstm_step_fwd`` / ``lstm_step_bwd`` with TrainStep's launches),
   then the result line.

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
            super().__init__(batch_size=int(batches[0].data[0].shape[0]))
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


def fit_callback(torch, n_batches, epochs, frequent, speedo, sync_window):
    """A ``fit`` batch-end callback around ``speedo`` (which reads the
    metric every ``frequent`` batches): from batch ``frequent`` of epoch
    0 on, with ``sync_window``, every step between two metric reads runs
    under ``torch.cuda.set_sync_debug_mode("error")``, so a host sync
    there raises. Returns (callback, epoch end times, [steps run in the
    window], CUDA events of the last epoch's steps)."""
    marks, window, events = [], [0], []

    def on_batch(param):
        last = param.nbatch == n_batches - 1
        if torch.cuda.get_sync_debug_mode() == 2:
            window[0] += 1
        if param.epoch == epochs - 1:
            # one event a step on the card's clock (no sync)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        # the metric is read at the Speedometer interval and (after the
        # last batch) by the epoch log: syncs are allowed there
        if last or param.nbatch % frequent == 0:
            torch.cuda.set_sync_debug_mode(0)
        speedo(param)
        if last:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        elif sync_window and (param.epoch, param.nbatch) >= (0, frequent):
            torch.cuda.set_sync_debug_mode("error")

    return on_batch, marks, window, events


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
    on_batch, marks, window, events = fit_callback(
        torch, FIT_BATCHES, FIT_EPOCHS, SPEEDO_FREQUENT,
        mt.callback.Speedometer(TRAIN_BATCH, SPEEDO_FREQUENT), sync_window)
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
        out = model.get_outputs()[0].data
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


# ---------------------------------------------------------------------------
# Slice 10: the bound Executor (Path E: executor_train, module_eager), every
# optimizer rule in the captured fused step (Path F: fused_rules), the
# captured eval forward (eval_capture) and Monitor (monitor)
# ---------------------------------------------------------------------------
# forward(is_train=True) + backward() calls per executor before Path E's
# check: the warm run (eager), the capture (and its replay), a replay
EXEC_STEPS = 3
EXEC_AB_RUNS = ("eager", "captured", "captured", "eager")
EXEC_AB_STEPS = 5
# grad_req="add": two backward calls (replays) summed in place against
# the sum of two of the write bind's replays; cuDNN's weight-gradient sums
# round differently from run to run (an H100 read 1.1e-5 between two such
# sums), so the rule is the captured checks': bit-identical, or within
# twice the spread of two write replays (relative L2 over all gradients)
# Path E's K1/B1/B2 launches a step: forward(is_train=True) then
# backward(), whose grad program walks its own training forward
EXEC_K1_PER_STEP = 56
EXEC_B_PER_STEP = 44
ADAM_HP = {"learning_rate": 0.001, "wd": 1e-4}
MODULE_EAGER_STEPS = 5
# module_eager's first Adam step against Adam's arithmetic in float64 on
# the same weights and gradients: relative L2 of each parameter's new
# value. Storing it in fp32 rounds it by up to 2^-24 (6e-8) relative,
# and a few fp32 operations add as much; the limit is about 16 of those
# roundings. Adam's first update is about lr = 1e-3 an element, so the
# probe (Adam without its bias correction, an update 0.32x as large)
# moves a weight by ~7e-4 in absolute terms, far above the limit.
ADAM_W_REL_LIMIT = 1e-6
# Path F's timed runs: Adam's captured step against SGD's, in turns
RULE_AB_RUNS = ("sgd", "adam", "adam", "sgd", "sgd", "adam")
# every other rule trains the phase-7 configuration (ResNet-50 at its
# widths, 224x224, 1000 classes, batch 128, bf16): the warm step, the
# capture, then three replays against three eager steps
RULES_STEPS = 4
RULE_CASES = (("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
              ("lbsgd", {"momentum": 0.9, "warmup_epochs": 1,
                         "updates_per_epoch": 8, "batch_scale": 4}),
              ("lars", {"momentum": 0.9}), ("adamax", {}), ("nadam", {}),
              ("ftml", {}), ("adagrad", {}), ("rmsprop", {}),
              ("rmsprop", {"centered": True}), ("adadelta", {}),
              ("ftrl", {}), ("signsgd", {}), ("signum", {"momentum": 0.9}),
              ("sgld", {}), ("dcasgd", {"momentum": 0.5}), ("test", {}))
# the Monitor's statistics (mean |x|) against the plain walk's, relative:
# the op outputs and arguments come from the same walk on the same values
# (~1e-7: the Monitor's mean multiplies the sum by the reciprocal of the
# count); the gradients against the mean |g| of the same executor's
# grad_dict after the same backward, the very arrays the Monitor reads
# (the kernels-against-library gap of the gradients is executor_train's
# check)
MONITOR_REL_LIMIT = 1e-5
MONITOR_GRAD_REL_LIMIT = 1e-6


def init_executor(mt, torch, exe, seed):
    """``profile_training.build_module``'s init (Xavier gaussian, in, 2,
    from ``seed``, in the Module's order) into a bound executor."""
    from mxnet_tpu_torch import initializer
    init = initializer.Xavier(rnd_type="gaussian", factor_type="in",
                              magnitude=2)
    gen = torch.Generator().manual_seed(seed)
    attrs = exe._symbol.attr_dict()
    with torch.no_grad():
        for d in (exe.arg_dict, exe.aux_dict):
            for n in sorted(d):
                if n in ("data", "softmax_label"):
                    continue
                init(initializer.InitDesc(n, attrs.get(n)), d[n]._data, gen)


def exe_result(torch, exe):
    """(loss, {param: gradient}, {aux: value}) of the executor's last
    backward: the loss from its softmax output and label."""
    out = exe.outputs[0]._data.float()
    lab = exe.arg_dict["softmax_label"]._data.long()
    loss = -torch.log(out.gather(1, lab[:, None]).clamp_min(1e-30)).sum()
    grads = {n: g._data.clone() for n, g in exe.grad_dict.items()
             if n not in ("data", "softmax_label")}
    return loss, grads, {n: a._data.clone() for n, a in exe.aux_dict.items()}


def exe_steps(torch, exe, n):
    for _ in range(n):
        exe.forward(is_train=True)
        exe.backward()
    torch.cuda.synchronize()
    return exe_result(torch, exe)


def kernel_counts(fb):
    return {k: fb.launch_counts()[w] for k, w in KERNEL_WRAPPERS.items()}


def executor_train_phase(mt, torch, np, smi, batches):
    """Path E: ResNet-50 (s2d) bound with ``simple_bind`` at batch 128,
    fp32 (TF32 off), grad_req write. Returns {kernel: launches} and the
    steps they were counted over."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.model_zoo.symbols import resnet
    fb = mt.ops.fused_bn_conv
    sym = resnet.get_symbol(1000, 50, "3,224,224", stem="s2d")
    feed = {"data": batches[0].data[0], "softmax_label": batches[0].label[0]}
    shapes = {n: tuple(v.shape) for n, v in feed.items()}
    t0 = time.perf_counter()

    def bind(grad_req="write"):
        exe = sym.simple_bind(ctx="cuda:0", grad_req=grad_req, **shapes)
        init_executor(mt, torch, exe, SEED)
        for n, v in feed.items():
            exe.arg_dict[n][:] = v
        return exe

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the same bind with the passes off: library ops only
    torch.cuda.reset_peak_memory_stats()
    with config.override("MXTPU_PALLAS_FUSION", "0"), \
            config.override("MXTPU_PASS_RESIDUAL_FUSION", "0"):
        ref = bind()
    check(all(e["status"] == "disabled" for e in ref.pass_report["passes"]),
          "the passes-off bind was rewritten")
    fb.reset_launch_counts()
    want = exe_steps(torch, ref, EXEC_STEPS)
    check(sum(fb.launch_counts().values()) == 0,
          "the passes-off bind hit a kernel")
    del ref
    free()

    exe = bind()
    sites = {e["pass"]: len(e["sites"]) for e in exe.pass_report["passes"]}
    check(exe.pass_report["tag"] == "executor"
          and exe.pass_report["mode"] == "train"
          and sites["pallas_fusion"] == 28 and sites["residual_fusion"] == 16,
          f"executor train-mode pass sites {sites}")
    got = exe_steps(torch, exe, EXEC_STEPS)
    progs = exe._progs.captured
    check(set(progs) == {"fwd_train", "grad"}
          and all(p.captured for p in progs.values()),
          f"the executor's programs were not captured: {list(progs)}")
    summ = grad_check_summary(*got, want)
    fails = training_failures(summ, FP32_TRAIN_LIMITS)

    # the planted fault: B2 without its c0 term at one call of every
    # backward, in an executor run eagerly (a replay calls no Python)
    real_dx = fb.bn_backward_dx
    calls = [0]

    def faulty_dx(dy, x, xhat, scale, cx=None, c0=None):
        calls[0] += 1
        if calls[0] % EXEC_B_PER_STEP == FAULT_B2_CALL and c0 is not None:
            c0 = torch.zeros_like(c0)
        return real_dx(dy, x, xhat, scale, cx, c0)

    probe = bind()
    probe.captured = False
    fb.bn_backward_dx = faulty_dx
    try:
        probe_res = exe_steps(torch, probe, EXEC_STEPS)
    finally:
        fb.bn_backward_dx = real_dx
    del probe
    free()
    probe_summ = grad_check_summary(*probe_res, want)
    rejected = training_failures(probe_summ, FP32_TRAIN_LIMITS)
    del probe_res

    # grad_req="add": two backward calls against two of the write bind's
    names = sorted(got[1])

    def flat(e):
        return torch.cat([e.grad_dict[n]._data.reshape(-1) for n in names])

    add = bind("add")
    add.backward()                  # the warm run, then the capture
    add.backward()
    for g in add.grad_dict.values():
        g._data.zero_()
    add.backward()                  # two replays, added in place
    add.backward()
    exe.backward()
    g1 = flat(exe)
    exe.backward()
    g2 = flat(exe)
    summed = flat(add)
    add_err = rel_l2(summed, g1 + g2)
    add_spread = rel_l2(g2, g1)
    once_err = rel_l2(g1, g1 + g2)
    add_ok = add_err == 0.0 or add_err <= 2 * add_spread
    del add, g1, g2, summed
    free()

    # launches a step from replays, then eager and captured steps in turns
    fb.reset_launch_counts()
    routes0 = dict(fb.route_counts()["bn_relu_conv_nchw"])
    n_steps = 4
    for _ in range(n_steps):
        exe.forward(is_train=True)
        exe.backward()
    torch.cuda.synchronize()
    launches = kernel_counts(fb)
    routes = {r: v - routes0.get(r, 0) for r, v in
              fb.route_counts()["bn_relu_conv_nchw"].items()}
    runs = []

    def step(i):
        exe.forward(is_train=True)
        exe.backward()

    exe.captured = False            # one eager step before the turns
    step(0)
    for mode in EXEC_AB_RUNS:
        exe.captured = mode == "captured"
        r = timed_runs(torch, step, EXEC_AB_STEPS)
        runs.append(dict(r, mode=mode))
    exe.captured = True
    row = {"phase": "executor_train", "batch": TRAIN_BATCH,
           "dtype": "float32", "tf32": False,
           "bind": "ResNet-50 (s2d) simple_bind(ctx=cuda:0, grad_req="
                   "'write'), Xavier init from seed 0",
           "pass_sites": sites,
           "programs": {k: p.record.as_dict() for k, p in progs.items()},
           "check": summ, "limits": FP32_TRAIN_LIMITS, "failures": fails,
           "against": f"the same bind with the passes off (library ops), "
                      f"after {EXEC_STEPS} forward+backward each (the "
                      "last a replay)",
           "fault_probe": {"fault": f"B2 call {FAULT_B2_CALL} of each "
                                    "backward with c0 = 0 (eager)",
                           "rejected_by": rejected, **probe_summ},
           "grad_req_add": {"rel_l2_vs_two_write_calls": add_err,
                            "write_spread": add_spread,
                            "rule": "bit-identical, or <= 2 x the spread "
                                    "of two write replays",
                            "one_call_vs_two": once_err},
           "launches_per_step": {k: v / n_steps for k, v in launches.items()},
           "k1_routes_per_step": {r: v / n_steps for r, v in routes.items()
                                  if v},
           "counted_from": "CUDA graph replays of fwd_train and grad",
           "host_ms_per_step": ab_summary(runs, "host_ms"),
           "event_ms_per_step": ab_summary(runs, "event_ms"),
           "order": list(EXEC_AB_RUNS), "steps_per_run": EXEC_AB_STEPS,
           "max_memory_allocated_gb": max(
               r["max_memory_allocated_gb"] for r in runs),
           "max_memory_reserved_gb": max(
               r["max_memory_reserved_gb"] for r in runs),
           "setup_s": time.perf_counter() - t0, "card": smi}
    emit(row)
    check(not fails, f"executor step against the passes-off bind: {fails}")
    check(rejected, "the executor check passes a planted fault")
    check(add_ok, f"grad_req add: {add_err} against two write calls, "
                  f"spread {add_spread}")
    check(launches["K1"] == EXEC_K1_PER_STEP * n_steps
          and launches["B1"] == EXEC_B_PER_STEP * n_steps
          and launches["B2"] == EXEC_B_PER_STEP * n_steps
          and launches["K2"] > 0,
          f"executor launches {launches} over {n_steps} steps")
    check(routes.get("fp32", 0) == EXEC_K1_PER_STEP * n_steps,
          f"executor K1 routes {routes}: fp32 expected")
    del exe, got, want
    free()
    return launches, n_steps, row


def adam64(w, g, hp, rescale, wd, t=1, bias_correction=True):
    """One Adam step in float64 from zero moments (the eager class's
    formula: the bias correction folded into lr)."""
    g = g * rescale + wd * w
    m = (1 - 0.9) * g
    v = (1 - 0.999) * g * g
    lr = hp["learning_rate"]
    if bias_correction:
        lr = lr * (1 - 0.999 ** t) ** 0.5 / (1 - 0.9 ** t)
    return w - lr * m / (v.sqrt() + 1e-8)


def module_eager_phase(mt, torch, np, smi, batches):
    """Path E, second half: ``Module(fused=False)`` with Adam on the same
    bind, 5 steps at batch 128 through the Updater."""
    from mxnet_tpu_torch import profile_training as pt
    m = pt.build_module(TRAIN_BATCH, SEED, compute_dtype=None,
                        optimizer="adam", optimizer_params=ADAM_HP,
                        fused=False)
    check(m._fused is None, "Module(fused=False) started the fused step")
    o = m._optimizer
    b = batches[0]
    m.forward(b, is_train=True)
    m.backward()
    torch.cuda.synchronize()
    w0 = {n: v.double().clone() for n, v in m.get_params()[0].items()}
    g = {n: m._exec.grad_dict[n]._data.double().clone() for n in w0}
    m.update()
    w1 = m.get_params()[0]
    errs, probe_errs = {}, {}
    for i, n in enumerate(m._param_names):
        wd = o._get_wd(i)
        want = adam64(w0[n], g[n], ADAM_HP, o.rescale_grad, wd)
        bad = adam64(w0[n], g[n], ADAM_HP, o.rescale_grad, wd,
                     bias_correction=False)
        errs[n] = rel_l2(w1[n], want)
        probe_errs[n] = rel_l2(w1[n], bad)
    del w0, g
    worst = max(errs, key=errs.get)
    losses, ms = [], []
    for i in range(1, MODULE_EAGER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.run_step(m, batches[i % 4])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out = m.get_outputs()[0].data.float()
        lab = batches[i % 4].label[0].long()
        losses.append(float(-torch.log(out.gather(1, lab[:, None])
                                       .clamp_min(1e-30)).mean()))
    progs = m._exec._progs.captured
    row = {"phase": "module_eager", "batch": TRAIN_BATCH,
           "optimizer": "adam", "hp": ADAM_HP, "dtype": "float32",
           "first_step": {"weight_rel_l2_worst": errs[worst],
                          "worst": worst,
                          "weight_rel_l2_median": statistics.median(
                              errs.values()),
                          "limit": ADAM_W_REL_LIMIT,
                          "against": "Adam's arithmetic in float64 on the "
                                     "same weights and gradients"},
           "fault_probe": {"fault": "Adam without its bias correction",
                           "weight_rel_l2_least": min(probe_errs.values()),
                           "weight_rel_l2_median": statistics.median(
                               probe_errs.values())},
           "ms_per_step": ms, "steps_2_to_5_losses": losses,
           "programs": {k: p.record.as_dict() for k, p in progs.items()},
           "card": smi}
    emit(row)
    check(errs[worst] <= ADAM_W_REL_LIMIT,
          f"Module(fused=False) Adam step: {errs[worst]} at {worst}")
    check(max(probe_errs.values()) > ADAM_W_REL_LIMIT,
          "the Adam check passes an update without bias correction")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    del m
    gc.collect()
    torch.cuda.empty_cache()
    return row


def rule_state(f):
    """A fused step's state as copies: the fp32 masters, every optimizer
    leaf, the aux and t."""
    leaves = {f"{n}:{j}": x.clone() for n, s in f._state.items()
              for j, x in enumerate(s)}
    out = {"weights": {n: p.detach().clone() for n, p in f._p.items()},
           "t": {"t": f._t.clone().float().reshape(1)}}
    if f._aux:           # the LM has none
        out["aux"] = {n: v.clone() for n, v in f._aux.items()}
    if leaves:           # sgd without momentum, signsgd, sgld: none
        out["leaves"] = leaves
    return out


def reset_step(f, init):
    """Back to ``init`` (params, aux), the rule's fresh state, t = 0, in
    place."""
    f.load_params(*init)
    f.reset_state()


def override_rule(torch, m, name, kw):
    """The rules with no optimizer class of their own (lars, signsgd):
    the fused step's rule replaced before its first step."""
    from mxnet_tpu_torch.parallel import functional_opt
    f = m._fused
    f._fopt = functional_opt.create(
        name, rescale_grad=m._optimizer.rescale_grad, **kw)
    f._init_state()


def rule_captured_vs_eager(torch, fc, fe, feeds, lrs):
    """``fc``'s captured steps (its program captured already) against
    ``fe``'s eager steps (twice, for the spread) from the same state."""
    init = [{n: t.clone() for n, t in d.items()} for d in fe.params()]

    def run(f, step):
        reset_step(f, init)
        for feed, lr in zip(feeds, lrs):
            step(feed, lr)
        torch.cuda.synchronize()
        return rule_state(f)

    e1 = run(fe, fe.step_eager)
    e2 = run(fe, fe.step_eager)
    r0 = sum(p.record.replays for p in fc._programs.values())
    c = run(fc, fc.step)
    replays = sum(p.record.replays for p in fc._programs.values()) - r0
    check(replays == len(feeds),
          f"the captured steps were {replays} replays, not {len(feeds)}")
    spread = state_diff(torch, e2, e1)
    diff = state_diff(torch, c, e1)
    return diff, spread, same_within(diff, spread)


def fused_rules_phase(mt, torch, np, smi, batches):
    """Path F: the phase-7 configuration (bf16, batch 128) with Adam in
    the captured step; then every other rule at the same configuration."""
    from mxnet_tpu_torch import faultinject, profile_training as pt
    from mxnet_tpu_torch.parallel import functional_opt
    fb = mt.ops.fused_bn_conv
    feeds = [{"data": b.data[0], "softmax_label": b.label[0]}
             for b in batches[:3]]
    adam = pt.build_module(TRAIN_BATCH, SEED, optimizer="adam",
                           optimizer_params=ADAM_HP)
    twin = pt.build_module(TRAIN_BATCH, SEED, optimizer="adam",
                           optimizer_params=ADAM_HP)
    fc, fe = adam._fused, twin._fused
    fc.step(feeds[0], 1e-3)            # the warm step (eager)
    fc.step(feeds[1], 1e-3)            # the capture
    diff, spread, fails = rule_captured_vs_eager(torch, fc, fe, feeds,
                                            CHECK_LRS)
    del twin, fe
    gc.collect()
    torch.cuda.empty_cache()

    # the guard with Adam: a planted NaN step on the captured step
    for i in range(2):
        pt.run_step(adam, batches[i])
    torch.cuda.synchronize()
    before = rule_state(fc)
    totals0 = registry_totals(mt)
    with faultinject.inject(f"nan_grad:step={fc.num_update}"):
        pt.run_step(adam, batches[2])
    torch.cuda.synchronize()
    after = rule_state(fc)
    delta = registry_delta(totals0, registry_totals(mt))
    t_moved = float(after["t"]["t"] - before["t"]["t"])
    after.pop("t"), before.pop("t")
    skip = state_diff(torch, after, before)
    mt.fault_report(reset=True)

    # Adam's captured step against SGD's, in turns; Adam's launches
    sgd = pt.build_module(TRAIN_BATCH, SEED)
    for i in range(3):
        pt.run_step(sgd, batches[i % 4])
    fb.reset_launch_counts()
    for i in range(4):
        pt.run_step(adam, batches[i % 4])
    torch.cuda.synchronize()
    adam_launches = kernel_counts(fb)
    runs = []
    for mode in RULE_AB_RUNS:
        m = adam if mode == "adam" else sgd
        r = timed_runs(torch, lambda i: pt.run_step(m, batches[i % 4]),
                       AB_STEPS)
        runs.append(dict(r, mode=mode))
    host = ab_summary(runs, "host_ms", ("sgd", "adam"))
    event = ab_summary(runs, "event_ms", ("sgd", "adam"))
    del sgd, adam, fc
    gc.collect()
    torch.cuda.empty_cache()

    # every other rule at the same configuration: 3 replays against 3
    # eager steps of the same module from the same state
    t_rules = time.perf_counter()
    sfeeds = [{"data": b.data[0], "softmax_label": b.label[0]}
              for b in batches[:RULES_STEPS]]
    lrs = (0.01,) * RULES_STEPS
    rules = {}
    for name, kw in RULE_CASES:
        label = name + ("_centered" if kw.get("centered") else "")
        cls = "sgd" if name in ("lars", "signsgd") else name
        ckw = {} if cls != name else kw
        m = pt.build_module(TRAIN_BATCH, SEED, optimizer=cls,
                            optimizer_params=dict(ckw, **ADAM_HP))
        if cls != name:
            override_rule(torch, m, name, kw)
        fc = fe = m._fused
        old = functional_opt.sgld_noise_scale
        if name == "sgld":
            functional_opt.sgld_noise_scale = 0.0
        try:
            fc.step(sfeeds[0], 0.01)
            fc.step(sfeeds[1], 0.01)
            d, s, f = rule_captured_vs_eager(torch, fc, fe, sfeeds[1:],
                                             lrs[1:])
        finally:
            functional_opt.sgld_noise_scale = old
        entry = {"captured_vs_eager": {g: {k: v[k] for k in
                                           ("bit_identical",
                                            "worst_rel_l2")}
                                       for g, v in d.items()},
                 "eager_spread": {g: v["worst_rel_l2"]
                                  for g, v in s.items()},
                 "t": int(fc._t), "failures": f}
        if name == "sgld":
            # the noise on, in a step captured with it: two replays from
            # one state draw anew, against the noiseless eager step
            init = [{n: t.clone() for n, t in dd.items()}
                    for dd in fe.params()]
            fn = pt.build_module(TRAIN_BATCH, SEED, optimizer="sgld",
                                 optimizer_params=ADAM_HP)._fused
            fn.step(sfeeds[0], 0.01)
            fn.step(sfeeds[1], 0.01)
            noisy = []
            for _ in range(2):
                reset_step(fn, init)
                fn.step(sfeeds[1], 0.01)
                noisy.append(torch.cat([p.reshape(-1) for p in
                                        fn._p.values()]).clone())
            del fn
            reset_step(fe, init)
            functional_opt.sgld_noise_scale = 0.0
            try:
                fe.step_eager(sfeeds[1], 0.01)
            finally:
                functional_opt.sgld_noise_scale = old
            clean = torch.cat([p.reshape(-1) for p in fe._p.values()])
            var = [float((x - clean).var()) / 0.01 for x in noisy]
            entry["noise_var_over_lr"] = var
            entry["replays_draw_anew"] = not torch.equal(*noisy)
            f = f + ([] if all(0.8 < v < 1.25 for v in var)
                     and entry["replays_draw_anew"] else ["noise"])
            entry["failures"] = f
        rules[label] = entry
        del fc, fe, m
        gc.collect()
    torch.cuda.empty_cache()
    rules_s = time.perf_counter() - t_rules
    row = {"phase": "fused_rules", "batch": TRAIN_BATCH, "dtype": "bfloat16",
           "adam": {"hp": ADAM_HP, "lrs": list(CHECK_LRS),
                    "captured_vs_eager": diff, "eager_spread": spread,
                    "failures": fails,
                    "guard": {"state": skip, "t_advanced": t_moved,
                              "compile_report_delta": delta},
                    "launches_per_step": {k: v / 4 for k, v in
                                          adam_launches.items()}},
           "adam_vs_sgd": {"host_ms_per_step": host,
                           "event_ms_per_step": event,
                           "order": list(RULE_AB_RUNS),
                           "steps_per_run": AB_STEPS,
                           "adam_minus_sgd_event_ms":
                               event["adam"]["median"]
                               - event["sgd"]["median"]},
           "rules": {"net": "the phase-7 configuration", "batch":
                     TRAIN_BATCH, "steps": RULES_STEPS, "seconds": rules_s,
                     "cases": rules},
           "rule": "per group: bit-identical, or worst relative L2 <= 2 x "
                   "the eager spread; sgld with its noise at 0, then its "
                   "noise's variance over lr (0.8-1.25) and two replays "
                   "from one state drawing anew",
           "card": smi}
    emit(row)
    check(not fails, f"Adam's replays against its eager steps: {fails}")
    check(all(v["bit_identical"] for v in skip.values()) and t_moved == 1
          and delta["replays"] == 1 and delta["fresh_compiles"] == 0,
          f"Adam's skipped step: {skip}, t moved {t_moved}, {delta}")
    bad = {k: v["failures"] for k, v in rules.items() if v["failures"]}
    check(not bad, f"rules' replays against their eager steps: {bad}")
    check(all(v["t"] == RULES_STEPS - 1 for v in rules.values()),
          "t did not advance on the device")
    check(all(adam_launches[k] > 0 for k in adam_launches),
          f"Adam's step launches {adam_launches}")
    return adam_launches, 4, row


def eval_capture_phase(mt, torch, np, smi, batches):
    """``Module.forward(is_train=False)`` and ``score`` on the
    executor's captured eval program, against the eager walk."""
    from mxnet_tpu_torch import profile_training as pt
    fb = mt.ops.fused_bn_conv
    m = pt.build_module(TRAIN_BATCH, SEED)
    pt.run_step(m, batches[0])
    outs = []
    for i in range(3):                 # warm, capture, replay
        if i == 2:
            fb.reset_launch_counts()
        m.forward(batches[i], is_train=False)
        outs.append(m.get_outputs()[0].data.clone())
    torch.cuda.synchronize()
    launches = kernel_counts(fb)
    prog = m._exec._progs.captured["fwd_eval"]
    m._exec.captured = False
    eager = []
    for _ in range(2):
        m.forward(batches[2], is_train=False)
        eager.append(m.get_outputs()[0].data.clone())
    torch.cuda.synchronize()
    bit = torch.equal(outs[2], eager[0])
    err, spread = rel_l2(outs[2], eager[0]), rel_l2(eager[1], eager[0])
    acc_e = m.score(four_batches(mt, batches), "acc")[0][1]
    runs = []
    for mode in EXEC_AB_RUNS:
        m._exec.captured = mode == "captured"
        r = timed_runs(torch, lambda i: m.forward(batches[i % 4],
                                                  is_train=False),
                       AB_STEPS)
        runs.append(dict(r, mode=mode))
    m._exec.captured = True
    r0 = prog.record.replays
    acc_c = m.score(four_batches(mt, batches), "acc")[0][1]
    replays = prog.record.replays - r0
    row = {"phase": "eval_capture", "batch": TRAIN_BATCH,
           "program": prog.record.as_dict(),
           "launches_per_forward": launches,
           "captured_vs_eager": {"bit_identical": bit, "rel_l2": err,
                                 "eager_spread": spread},
           "score_acc": {"captured": acc_c, "eager": acc_e,
                         "replays": replays},
           "host_ms_per_forward": ab_summary(runs, "host_ms"),
           "event_ms_per_forward": ab_summary(runs, "event_ms"),
           "order": list(EXEC_AB_RUNS), "forwards_per_run": AB_STEPS,
           "card": smi}
    emit(row)
    check(bit or err <= 2 * spread, f"captured eval forward: {row}")
    check(acc_c == acc_e and replays == 4, f"score: {row['score_acc']}")
    check(launches["K1"] == 28 and launches["K2"] > 0
          and launches["B1"] == 0, f"eval launches {launches}")
    del m
    gc.collect()
    torch.cuda.empty_cache()
    return row


def monitor_expectation(torch, sym, params, aux, feed, post, grads):
    """The Monitor's statistics from the plain walk: every op output of
    the original graph at the pre-update ``params`` (training mode), the
    args after the update (``post``), and the mean |g| of the executor's
    gradient arrays ``grads`` after the step's backward."""
    amap = dict(params, **aux, **feed)
    internals = {}
    with torch.no_grad():
        sym.eval_arrays_ex(amap, training=True, internals=internals)
    stats = {n: float(v.float().abs().mean()) for n, v in internals.items()}
    for n in sym.list_arguments():
        stats[n] = float((post[n] if n in post else feed[n])
                         .float().abs().mean())
        stats[n + "_grad"] = float(grads[n].abs().mean())
    return stats


def monitor_phase(mt, torch, np, smi, batches):
    """``Monitor(interval=2)`` on the phase-7 configuration's Module, in
    the eager regime (Adam, fp32) and the fused one (bf16, SGD): names
    and statistics of batches 0 and 2 against the plain walk's."""
    from mxnet_tpu_torch import profile_training as pt
    out = {}
    for regime, fused, opt_name, hp in (
            ("eager", False, "adam", ADAM_HP),
            ("fused", None, "sgd", pt.SGD_PARAMS)):
        m = pt.build_module(TRAIN_BATCH, SEED, optimizer=opt_name,
                            optimizer_params=hp, fused=fused,
                            compute_dtype=None if fused is False
                            else "bfloat16")
        sym = m.symbol
        mon = mt.monitor.Monitor(2, sort=True)
        m.install_monitor(mon)
        worst = {"values": (0.0, None), "grads": (0.0, None)}
        names_ok, counts = True, []
        for i, b in enumerate(batches[:3]):
            feed = {"data": b.data[0], "softmax_label": b.label[0].float()}
            pre_a, pre_x = (
                {n: v.clone() for n, v in d.items()}
                for d in m.get_params())
            mon.tic()
            pt.run_step(m, b)
            res = mon.toc()
            counts.append(len(res))
            if i % 2:
                continue
            post = {n: v.clone() for n, v in m.get_params()[0].items()}
            grads = {n: g._data for n, g in m._exec.grad_dict.items()}
            want = monitor_expectation(torch, sym, pre_a, pre_x, feed,
                                       post, grads)
            got = {k: float(v) for _, k, v in res}
            names_ok &= sorted(got) == sorted(want)
            for k in want:
                if k in got:
                    err = abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                    g = "grads" if k.endswith("_grad") else "values"
                    if err > worst[g][0]:
                        worst[g] = (err, k)
        out[regime] = {"stats_per_batch": counts, "names_match": names_ok,
                       "worst_rel_err": {g: {"err": e, "name": n}
                                         for g, (e, n) in worst.items()}}
        del m, mon
        gc.collect()
        torch.cuda.empty_cache()
    row = {"phase": "monitor", "interval": 2,
           "net": "the phase-7 configuration", "batch": TRAIN_BATCH,
           "regimes": out,
           "limits": {"values": MONITOR_REL_LIMIT,
                      "grads": MONITOR_GRAD_REL_LIMIT},
           "against": "mean |x| of every op output of the original graph's "
                      "plain walk at the pre-update params, the post-update "
                      "params, the executor's gradient arrays after the "
                      "step's backward",
           "card": smi}
    emit(row)
    for regime, r in out.items():
        w = r["worst_rel_err"]
        check(r["names_match"] and w["values"]["err"] <= MONITOR_REL_LIMIT
              and w["grads"]["err"] <= MONITOR_GRAD_REL_LIMIT
              and r["stats_per_batch"][1] == 0
              and r["stats_per_batch"][0] == r["stats_per_batch"][2] > 0,
              f"Monitor in the {regime} regime: {r}")
    return row


def slice10_phases(mt, torch, np, smi, batches):
    """Phases 7e-7i (slice 10). Returns the kernels line's extra fields
    for K1/K2/B1/B2: the Executor path's and the Adam step's launches."""
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    exe_launches, exe_steps_n, _ = executor_train_phase(mt, torch, np, smi,
                                                        batches)
    lap("executor_train")
    module_eager_phase(mt, torch, np, smi, batches)
    lap("module_eager")
    adam_launches, adam_steps, _ = fused_rules_phase(mt, torch, np, smi,
                                                     batches)
    lap("fused_rules")
    eval_capture_phase(mt, torch, np, smi, batches)
    lap("eval_capture")
    monitor_phase(mt, torch, np, smi, batches)
    lap("monitor")
    emit({"phase": "slice10_seconds", "seconds": seconds})
    return {k: {"executor": {
        "launches": exe_launches[k],
        "launches_per_step": exe_launches[k] / exe_steps_n,
        "steps": exe_steps_n,
        "path": "Executor forward(is_train=True) + backward() replays "
                "(Path E, fp32), counts set to 0 just before"},
        "fused_adam": {
            "launches": adam_launches[k],
            "launches_per_step": adam_launches[k] / adam_steps,
            "steps": adam_steps,
            "path": "Module(fused=True) with Adam (Path F, bf16), counts "
                    "set to 0 just before"}} for k in KERNEL_WRAPPERS}


# ---------------------------------------------------------------------------
# Slice 11: the decode LM trained on the port (lm_fit, lm_serve, lm_spec)
# and its training step at GPT-2 small's widths (lm_full)
# ---------------------------------------------------------------------------
# bench.py:401-405's corpus, copied (this script imports nothing of
# bench.py), and bench.py's fit of its speculative pair at its own sizes
LM_CORPUS = ("the quick brown fox jumps over the lazy dog. "
             "pack my box with five dozen liquor jugs. "
             "how vexingly quick daft zebras jump. "
             "sphinx of black quartz judge my vow. ") * 12
LM_DEVICE = "cuda:0"
LM_SEQ = 16
LM_BATCH = 32
LM_LR = 3e-3
LM_NP_SEED = 7             # bench.py seeds numpy's global RNG so
LM_TARGET = {"num_embed": 128, "num_heads": 8, "num_layers": 4,
             "max_seq": 64}
LM_EPOCHS = {"target": 4, "draft": 6}
# the JAX package's own fit of the same pair (same data, windows,
# shuffle seed, optimizer, initializer and epochs) on the CPU, the
# final next-char accuracy of each: `JAX_PLATFORMS=cpu python
# tests/torch_lm_reference.py`, figures in PERF.md). The port's fits draw
# another Xavier init (torch's generator), so each accuracy is held to
# the JAX package's less LM_ACC_SLACK rather than equal
LM_JAX_ACC = {"target": 0.9372351694915254, "draft": 0.9358448093220338}
LM_ACC_SLACK = 0.05
LM_SPEEDO = 20
LM_CHECK_LRS = (3e-3, 1.5e-3, 7.5e-4)
LM_SLOTS = 8
LM_BUCKETS = (16, 32)
LM_NEW_TOKENS = 16
LM_PER_CLIENT = {1: 8, 8: 3}          # bench.py's closed loops
LM_PROMPTS = 16
# bench.py:373-377: each verify launch must commit well over one token
LM_ACCEPT_BAR = 1.5
LM_EVAL_ROWS = 4           # windows of the eval forward held position by
# position against the reprefill program: both fp32, the same math in
# another order (a batched walk against one prompt's), ~1e-7 apart in
# probability; the limit leaves 100x and is far below what a wrong
# mask or a missing layer moves (O(0.1))
LM_EVAL_PROB_LIMIT = 1e-5
# lm_full: GPT-2 small's widths, nothing cut but the batch
LM_FULL_BATCH = 8
LM_FULL_CHECK_BATCH = 2
LM_FULL_LR = 3e-4
LM_FULL_STAGED = 4
LM_FULL_WARMUP = 3         # eager, the capture, a replay
LM_FULL_TIMED = 10
LM_FULL_TRACE = 3
LM_FULL_PROMPT = 512
# the fused fp32 step's gradients against float64 may be at most this
# many times the plain fp32 walk's error against float64 (plus a
# floor), over all gradients and in each parameter
LM_FULL_GRAD_FACTOR = 3.0
LM_FULL_GRAD_FLOOR = 1e-6
LM_ATTN_SHAPE = (8, 1024, 12, 64)


def lm_windows(np):
    """bench.py's next-char windows of the corpus: (chars, ids, data,
    label)."""
    chars = sorted(set(LM_CORPUS))
    ids = np.asarray([chars.index(c) for c in LM_CORPUS], np.int32)
    nw = len(ids) - LM_SEQ - 1
    data = np.stack([ids[i:i + LM_SEQ] for i in range(nw)])
    label = np.stack([ids[i + 1:i + LM_SEQ + 1]
                      for i in range(nw)]).astype(np.float32)
    return chars, ids, data, label


def lm_fit_run(mt, torch, np, spec, data, label, epochs, name):
    """bench.py's ``_fit_lm`` on the port: ``Module.fit`` of
    ``build_symbol(spec, 16)`` on cuda:0 over a shuffled ``NDArrayIter``
    (numpy's global RNG), Adam lr 3e-3, Xavier, ``Accuracy(axis=2)``
    counted inside the captured step and a ``Speedometer(32, 20)``;
    every step between two metric reads runs under
    ``torch.cuda.set_sync_debug_mode("error")``. Returns the module and
    a row."""
    dec = mt.serving.decode
    it = mt.io.NDArrayIter(data.astype(np.float32), label, LM_BATCH,
                           shuffle=True, last_batch_handle="discard")
    n_batches = it.num_data // LM_BATCH
    m = mt.mod.Module(symbol=dec.build_symbol(spec, LM_SEQ),
                      data_names=("data",),
                      label_names=("softmax_label",), context=LM_DEVICE)
    m.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    m.init_params(mt.init.Xavier(),
                  generator=torch.Generator().manual_seed(SEED))
    metric = mt.metric.Accuracy(axis=2, name=name)
    on_batch, _, window, events = fit_callback(
        torch, n_batches, epochs, LM_SPEEDO,
        mt.callback.Speedometer(LM_BATCH, LM_SPEEDO), True)
    torch.cuda.synchronize()
    mt.compile_report(reset=True)
    totals0 = registry_totals(mt)
    t0 = time.perf_counter()
    try:
        m.fit(it, eval_metric=metric, batch_end_callback=on_batch,
              optimizer="adam", optimizer_params={"learning_rate": LM_LR},
              num_epoch=epochs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    delta = registry_delta(totals0, registry_totals(mt))
    pname = next(iter(m._fused._programs.values())).key.name
    events_ = mt.compile_report()["retraces"].get(pname, {}) \
        .get("events", [])
    gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    steps = epochs * n_batches
    want_window = n_batches - LM_SPEEDO - 1 + (epochs - 1) * \
        (n_batches - 1)
    row = {"model": name, "layers": spec.num_layers,
           "embed": spec.num_embed, "heads": spec.num_heads,
           "vocab": spec.vocab_size, "epochs": epochs,
           "batches_per_epoch": n_batches, "steps": steps,
           "accuracy": float(metric.get()[1]),
           "jax_package_cpu_accuracy": LM_JAX_ACC[name],
           "fit_s": fit_s,
           "ms_per_step_last_epoch_events": statistics.median(gaps),
           "steps_in_sync_check": window[0],
           "steps_in_sync_check_due": want_window,
           "compile_report_delta": delta,
           "retrace_detail": events_[-1].get("detail") if events_
           else None}
    check(delta["fresh_compiles"] == 1 and delta["retraces"] == 1
          and delta["replays"] == steps - 1,
          f"lm_fit {name}: one capture (with the metric slot), one "
          f"retrace (the attach) and replays after it expected: {delta}")
    check(row["retrace_detail"] == ["extra.metrics"],
          f"lm_fit {name}: the retrace guard did not name the metric "
          f"material: {row['retrace_detail']}")
    check(window[0] == want_window,
          f"lm_fit {name}: {window[0]} steps ran under the sync check, "
          f"{want_window} due")
    check(row["accuracy"] >= LM_JAX_ACC[name] - LM_ACC_SLACK,
          f"lm_fit {name}: accuracy {row['accuracy']} below the JAX "
          f"package's {LM_JAX_ACC[name]} less {LM_ACC_SLACK}")
    return m, row


def lm_replays_vs_eager(torch, m, feeds, lrs):
    """Replays of ``m``'s captured step (captured already, with its
    metric slot) against eager steps of the same step from the same
    state: masters, both of Adam's moments and t."""
    f = m._fused
    diff, spread, fails = rule_captured_vs_eager(torch, f, f, feeds, lrs)
    check(not fails, f"captured steps differ from eager ones in {fails}: "
                     f"{diff} (eager spread {spread})")
    return {"replays": len(feeds), "vs_eager": diff,
            "eager_spread": spread}


def lm_streams(pred, prompts, n=LM_NEW_TOKENS):
    return [list(pred.generate(p, max_new_tokens=n)) for p in prompts]


def lm_eval_vs_reprefill(mt, torch, np, m, spec, data, label):
    """The Module's captured eval forward (the executor's fp32 program)
    over a batch of windows, held position by position against the
    serving functions' prompt program on the same weights: the
    probabilities within LM_EVAL_PROB_LIMIT, and the greedy token equal
    wherever the program's top-2 logit gap exceeds F64_MARGIN."""
    dm = mt.serving.decode.model
    batch = mt.io.DataBatch([torch.from_numpy(data[:LM_BATCH]
                                              .astype(np.float32))],
                            [torch.from_numpy(label[:LM_BATCH])])
    m.forward(batch, is_train=False)
    probs = m.get_outputs()[0].data
    p = {k: v.detach().clone() for k, v in m.get_params()[0].items()}
    caches = dm.init_caches(spec, 1, "float32", LM_DEVICE)
    worst, checked, exempt, differ = 0.0, 0, 0, []
    with torch.inference_mode():
        for r in range(LM_EVAL_ROWS):
            toks = torch.tensor(data[r][None].astype(np.int32),
                                device=LM_DEVICE)
            for n in range(1, LM_SEQ + 1):
                _, logits = dm._prefill(spec, p, caches, toks, n, 0,
                                        "float32")
                worst = max(worst, float(
                    (torch.softmax(logits, -1) - probs[r, n - 1])
                    .abs().max()))
                top = torch.topk(logits, 2)
                if float(top.values[0] - top.values[1]) > F64_MARGIN:
                    checked += 1
                    if int(top.indices[0]) != int(
                            probs[r, n - 1].argmax()):
                        differ.append((r, n - 1))
                else:
                    exempt += 1
    return {"rows": LM_EVAL_ROWS, "positions": LM_SEQ,
            "max_abs_prob_err": worst, "limit": LM_EVAL_PROB_LIMIT,
            "greedy_checked": checked, "greedy_exempt": exempt,
            "greedy_differ": differ}


def lm_serve_phase(mt, torch, np, smi, m, spec, params, prompts, data,
                   label):
    """``lm_serve``: ``DecodePredictor.from_module`` on the fitted target
    against a predictor built from a cloned dict of its weights (streams
    token for token); one more training step of the Module leaves the
    first predictor's streams as they were; the Module's captured eval
    forward against the serving functions on the same weights."""
    dec = mt.serving.decode
    pred = dec.DecodePredictor.from_module(m, spec, slots=LM_SLOTS,
                                           seq_buckets=LM_BUCKETS,
                                           name="lm-from-module")
    ref = dec.DecodePredictor(spec, {k: v.clone() for k, v in
                                     params.items()},
                              slots=LM_SLOTS, seq_buckets=LM_BUCKETS,
                              name="lm-cloned", device=LM_DEVICE)
    streams = lm_streams(pred, prompts)
    same_as_cloned = streams == lm_streams(ref, prompts)
    before = {k: v.clone() for k, v in m.get_params()[0].items()}
    b = mt.io.DataBatch([torch.from_numpy(data[:LM_BATCH]
                                          .astype(np.float32))],
                        [torch.from_numpy(label[:LM_BATCH])])
    m.forward(b, is_train=True)
    m.backward()
    m.update()
    torch.cuda.synchronize()
    moved = max(float((m.get_params()[0][k] - v).abs().max())
                for k, v in before.items())
    unchanged = lm_streams(pred, prompts) == streams
    ev = lm_eval_vs_reprefill(mt, torch, np, m, spec, data, label)
    row = {"phase": "lm_serve", "device": str(pred.device),
           "prompts": len(prompts), "new_tokens": LM_NEW_TOKENS,
           "from_module_equals_cloned": same_as_cloned,
           "module_params_moved_by": moved,
           "streams_unchanged_after_training": unchanged,
           "eval_forward_vs_prefill": ev, "card": smi}
    emit(row)
    check(pred.device.type == "cuda", "from_module left the card")
    check(same_as_cloned, "from_module streams differ from a predictor "
                          "of cloned weights")
    check(moved > 0, "the extra training step moved no weight")
    check(unchanged, "the predictor's streams changed when its Module "
                     "trained on")
    check(ev["max_abs_prob_err"] <= LM_EVAL_PROB_LIMIT,
          f"eval forward against the prompt program: {ev}")
    check(not ev["greedy_differ"] and ev["greedy_checked"] > 0,
          f"eval forward's greedy tokens differ: {ev}")
    return row


def lm_closed_loops(mt, eng, prompts):
    from mxnet_tpu_torch.serving import loadgen
    out = {}
    with mt.serving.decode.DecodeBatcher(eng, max_wait_us=2000,
                                         max_queue=4096,
                                         name=f"{eng.name}-loop") as bat:
        for n, per in LM_PER_CLIENT.items():
            r = loadgen.token_closed_loop(bat, prompts, n, per,
                                          max_new_tokens=LM_NEW_TOKENS)
            out[str(n)] = {"tok_s": r["tok_s"],
                           "ttft_p99_ms": r["ttft_p99_ms"],
                           "inter_token_p99_ms": r["inter_token_p99_ms"]}
    return out


def lm_batched_streams(mt, eng, prompts):
    with mt.serving.decode.DecodeBatcher(eng, max_wait_us=20000,
                                         name=f"{eng.name}-check") as bat:
        futs = [bat.submit(p, max_new_tokens=LM_NEW_TOKENS)
                for p in prompts]
        return [f.result(timeout=600) for f in futs]


def lm_spec_phase(mt, torch, np, smi, spec, params, dspec, dparams,
                  prompts):
    """``lm_spec`` (bench.py:431-470): the fitted pair speculatively
    against plain decode at 1 and 8 clients; streams bit for bit the
    plain ones; accepted tokens per verify round against bench.py's
    bar; then a draft from ``distill_draft`` at its defaults, its
    acceptance beside the fitted one's. Returns D1's launches."""
    dec = mt.serving.decode
    d1 = mt.ops.decode_attention.decode_attention
    t0 = time.perf_counter()
    plain = dec.DecodePredictor(spec, params, slots=LM_SLOTS,
                                seq_buckets=LM_BUCKETS, name="lm-plain",
                                device=LM_DEVICE)
    plain.warmup()
    eng = dec.SpecDecodePredictor(spec, params, dspec, dparams,
                                  slots=LM_SLOTS, seq_buckets=LM_BUCKETS,
                                  name="lm-spec", device=LM_DEVICE)
    eng.warmup()
    setup_s = time.perf_counter() - t0
    plain_streams = lm_batched_streams(mt, plain, prompts)
    tot0 = registry_totals(mt)
    mt.ops.fused_bn_conv.reset_launch_counts()
    eng.report(reset=True)
    v0 = eng.report()["verify_steps"]
    d0 = eng.report()["decode_steps"]
    dd0 = eng.draft.report()["decode_steps"]
    spec_streams = lm_batched_streams(mt, eng, prompts)
    spec_loops = lm_closed_loops(mt, eng, prompts)
    torch.cuda.synchronize()
    n_d1 = d1.launches
    rep = eng.report()
    verify_steps = rep["verify_steps"] - v0
    decode_steps = rep["decode_steps"] - d0
    draft_steps = eng.draft.report()["decode_steps"] - dd0
    serving = registry_delta(tot0, registry_totals(mt))
    plain_loops = lm_closed_loops(mt, plain, prompts)

    t1 = time.perf_counter()
    dspec2 = dec.make_draft_spec(spec, num_layers=2, shrink=4,
                                 name=f"{spec.name}-distilled")
    dparams2 = dec.distill_draft(plain, dspec2)
    distill_s = time.perf_counter() - t1
    eng2 = dec.SpecDecodePredictor(spec, params, dspec2, dparams2,
                                   slots=LM_SLOTS, seq_buckets=LM_BUCKETS,
                                   name="lm-spec-distilled",
                                   device=LM_DEVICE)
    eng2.warmup()
    distilled_streams = lm_batched_streams(mt, eng2, prompts)
    rep2 = eng2.report()
    row = {"phase": "lm_spec", "k": eng.spec_k, "slots": LM_SLOTS,
           "buckets": list(LM_BUCKETS), "prompts": len(prompts),
           "new_tokens": LM_NEW_TOKENS, "setup_s": setup_s,
           "streams_equal_plain": spec_streams == plain_streams,
           "accepted_per_verify_round": rep["spec"]["accepted_per_step"],
           "acceptance_rate": rep["spec"]["acceptance_rate"],
           "bar": LM_ACCEPT_BAR,
           "degrade_events": rep["spec"]["degrade_events"],
           "spec": spec_loops, "plain": plain_loops,
           "verify_steps": verify_steps, "target_decode_steps":
           decode_steps, "draft_decode_steps": draft_steps,
           "d1_launches": n_d1,
           "d1_launches_w5": spec.num_layers * verify_steps,
           "serving_registry_delta": serving,
           "distilled": {
               "seconds": distill_s,
               "streams_equal_plain": distilled_streams == plain_streams,
               "accepted_per_verify_round":
                   rep2["spec"]["accepted_per_step"],
               "acceptance_rate": rep2["spec"]["acceptance_rate"]},
           "card": smi}
    emit(row)
    check(row["streams_equal_plain"], "speculative streams of the fitted "
                                      "pair differ from plain decode")
    check(row["distilled"]["streams_equal_plain"],
          "speculative streams with the distilled draft differ from plain "
          "decode")
    check(verify_steps > 0, "no verify round ran")
    check(n_d1 == spec.num_layers * (verify_steps + decode_steps)
          + dspec.num_layers * draft_steps,
          f"D1 launches {n_d1} against {verify_steps} verify, "
          f"{decode_steps} decode and {draft_steps} draft steps")
    check(serving["fresh_compiles"] == 0 and serving["retraces"] == 0,
          f"speculative serving captured or retraced: {serving}")
    check(row["accepted_per_verify_round"] > LM_ACCEPT_BAR,
          f"accepted tokens per verify round "
          f"{row['accepted_per_verify_round']} not above {LM_ACCEPT_BAR}")
    del plain, eng, eng2
    return {"launches": n_d1, "launches_w5": row["d1_launches_w5"],
            "verify_steps": verify_steps, "path": "lm_spec (the fitted "
            "pair's batched streams and closed loops at 1 and 8 clients),"
            " counts set to 0 just before"}


def lm_small_phases(mt, torch, np, smi, seconds, lap):
    """lm_fit, lm_serve and lm_spec. Returns D1's lm_spec launches."""
    dec = mt.serving.decode
    chars, ids, data, label = lm_windows(np)
    np.random.seed(LM_NP_SEED)
    spec = dec.TransformerLMSpec(vocab_size=len(chars), name="specbench",
                                 **LM_TARGET)
    target, trow = lm_fit_run(mt, torch, np, spec, data, label,
                              LM_EPOCHS["target"], "target")
    dspec = dec.make_draft_spec(spec, num_layers=2, shrink=4)
    draft, drow = lm_fit_run(mt, torch, np, dspec, data, label,
                             LM_EPOCHS["draft"], "draft")
    params = {k: v.detach().clone()
              for k, v in target.get_params()[0].items()}
    dparams = {k: v.detach().clone()
               for k, v in draft.get_params()[0].items()}
    lap("lm_fit")
    rng = np.random.RandomState(0)

    def prompt(length):
        off = int(rng.randint(0, len(ids) - length - 1))
        return ids[off:off + length].copy()

    prompts = [prompt(4 + (i * 5) % 16) for i in range(LM_PROMPTS)]
    lm_serve_phase(mt, torch, np, smi, target, spec, params, prompts,
                   data, label)
    lap("lm_serve")
    # the captured steps against eager ones (lm_fit's check, run after
    # lm_serve: it moves the modules on from their fitted weights)
    feeds = [{"data": torch.from_numpy(data[i * LM_BATCH:(i + 1) *
                                            LM_BATCH].astype(np.float32)),
              "softmax_label": torch.from_numpy(
                  label[i * LM_BATCH:(i + 1) * LM_BATCH])}
             for i in range(len(LM_CHECK_LRS))]
    emit({"phase": "lm_fit", "models": [trow, drow],
          "replays_vs_eager": {
              "target": lm_replays_vs_eager(torch, target, feeds,
                                            LM_CHECK_LRS),
              "draft": lm_replays_vs_eager(torch, draft, feeds,
                                           LM_CHECK_LRS)},
          "card": smi})
    del target, draft
    lap("lm_fit_replays")
    d1 = lm_spec_phase(mt, torch, np, smi, spec, params, dspec, dparams,
                       prompts)
    lap("lm_spec")
    return d1


def lm_full_batches(mt, torch, np, spec, batch, n, seed=0):
    """``n`` batches of random token ids (float32, exact) and their
    next-token labels, on the card."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, spec.vocab_size, (batch, spec.max_seq + 1))
        out.append(mt.io.DataBatch(
            [torch.from_numpy(ids[:, :-1].astype(np.float32)).to(LM_DEVICE)],
            [torch.from_numpy(ids[:, 1:].astype(np.float32)).to(LM_DEVICE)]))
    return out


def lm_plain_grads(mt, torch, sym, params, feed, dtype):
    """The graph's loss and gradients by the plain walk in ``dtype``."""
    from mxnet_tpu_torch.executor import build_graph_fns
    _, fwd_loss, _ = build_graph_fns(sym)
    leaves = {n: v.detach().to(dtype).requires_grad_(True)
              for n, v in params.items()}
    args = [leaves[n] if n in leaves else feed[n].to(dtype)
            for n in sym.list_arguments()]
    loss, _ = fwd_loss(args, [])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def lm_grad_errors(torch, got, ref):
    """Relative L2 of ``got`` against ``ref`` over all gradients and in
    each parameter (worst named)."""
    num = sum(float(torch.sum((got[n].double() - ref[n]) ** 2))
              for n in ref)
    den = sum(float(torch.sum(ref[n] ** 2)) for n in ref)
    per = {n: rel_l2(got[n].double(), ref[n]) for n in ref}
    worst = max(per, key=per.get)
    return {"all": (num / den) ** 0.5, "worst": per[worst],
            "worst_param": worst, "per_param": per}


def lm_full_grad_check(mt, torch, m, sym, feed, attention=None):
    """One step's loss and gradients at batch 2 from the fused step
    (eager: ``FusedSymbolStep.gradients``) and the fp32 plain walk, each
    against the float64 plain walk on the card. ``attention`` replaces
    ``CausalSelfAttention`` in the fused step alone (the probe)."""
    f = m._fused
    params = dict(f.params()[0])
    loss64, g64 = lm_plain_grads(mt, torch, sym, params, feed,
                                 torch.float64)
    loss32, g32 = lm_plain_grads(mt, torch, sym, params, feed,
                                 torch.float32)
    opdef = mt.ops.registry.get_op("CausalSelfAttention")
    real = opdef.fn
    opdef.fn = attention or real
    try:
        loss_f, g_f, _, _ = f.gradients(feed)
    finally:
        opdef.fn = real
    plain = lm_grad_errors(torch, g32, g64)
    fused = lm_grad_errors(torch, g_f, g64)
    del g32, g_f
    limit_all = LM_FULL_GRAD_FACTOR * plain["all"] + LM_FULL_GRAD_FLOOR
    over = [n for n in g64 if fused["per_param"][n] >
            LM_FULL_GRAD_FACTOR * plain["per_param"][n]
            + LM_FULL_GRAD_FLOOR]
    ok = fused["all"] <= limit_all and not over
    for d in (plain, fused):
        d.pop("per_param")
    return {"loss_f64": loss64, "loss_rel_err": abs(float(loss_f) - loss64)
            / abs(loss64), "plain_fp32_loss_rel_err":
            abs(loss32 - loss64) / abs(loss64),
            "fused_vs_f64": fused, "plain_fp32_vs_f64": plain,
            "limit_all": limit_all, "params_over_limit": len(over),
            "first_over_limit": over[:4], "ok": ok}


def lm_mask_probe_attention(data, num_heads=1, scale=None, **kw):
    """CausalSelfAttention whose mask lets each position see its
    successor (the fault the gradient check must catch)."""
    import torch
    from mxnet_tpu_torch.ops.nn import _NEG, local_attention_block
    b, s, three_hd = data.shape
    h = int(num_heads)
    d = three_hd // (3 * h)
    q, k, v = data.reshape(b, s, 3, h, d).unbind(2)
    pos = torch.arange(s, device=data.device)
    bias = torch.where(pos[:, None] + 1 >= pos[None, :],
                       torch.zeros((), dtype=data.dtype,
                                   device=data.device),
                       torch.full((), _NEG, dtype=data.dtype,
                                  device=data.device))
    o, _, l = local_attention_block(q, k, v, bias=bias[None, None],
                                    scale=scale)
    out = o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.reshape(b, s, h * d).to(data.dtype)


def lm_embedding_determinism(mt, torch):
    """Embedding's weight gradient twice over heavily repeated ids, on
    the card: a 40-row table at 16 x 32 ids and the 50257-row table at
    8 x 1024; equal bit for bit (the captured step's replays are held
    to eager steps bit for bit)."""
    out = {}
    gen = torch.Generator(device=LM_DEVICE).manual_seed(SEED)
    for rows, shape in ((40, (16, 32)), (GPT2_SMALL["vocab_size"],
                                         (8, 1024))):
        w = torch.randn(rows, 64, device=LM_DEVICE, generator=gen)
        ids = torch.randint(0, rows, shape, device=LM_DEVICE,
                            generator=gen).float()
        ct = torch.randn(shape + (64,), device=LM_DEVICE, generator=gen)
        grads = []
        for _ in range(2):
            wl = w.clone().requires_grad_(True)
            mt.ops.shape_ops.embedding(ids, wl).backward(ct)
            grads.append(wl.grad)
        out[f"{rows}x{shape[0]}x{shape[1]}"] = torch.equal(*grads)
    return out


def lm_attention_timing(mt, torch, F):
    """CausalSelfAttention forward + backward at (8, 1024, 2304) fp32,
    beside ``F.scaled_dot_product_attention``'s (causal, fp32; a
    yardstick the port never calls) on the same q, k, v."""
    b, s, h, d = LM_ATTN_SHAPE
    gen = torch.Generator(device=LM_DEVICE).manual_seed(SEED)
    x = torch.randn(b, s, 3 * h * d, device=LM_DEVICE, generator=gen) \
        .requires_grad_(True)
    ct = torch.randn(b, s, h * d, device=LM_DEVICE, generator=gen)
    op = mt.ops.nn.causal_self_attention

    def ours():
        x.grad = None
        op(x, num_heads=h).backward(ct)

    q, k, v = (t.detach().clone().requires_grad_(True) for t in
               x.detach().reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4))
    ct4 = ct.reshape(b, s, h, d).transpose(1, 2).contiguous()

    def sdpa():
        for t in (q, k, v):
            t.grad = None
        F.scaled_dot_product_attention(q, k, v, is_causal=True) \
            .backward(ct4)

    ms = time_ms(ours, reps=3, inner=3, warmup=1)
    sdpa_ms = time_ms(sdpa, reps=3, inner=3, warmup=1)
    # the work: two (B, H, S, S) products forward, four backward, in
    # fp32 (the whole score matrix, as the op computes it); bytes: x and
    # ct read, the output and dx written
    flops = 6 * 2 * b * h * s * s * d
    nbytes = 4 * 2 * (x.numel() + ct.numel())
    bms, by = bound_ms(nbytes, flops, "float32")
    return {"shape": [b, s, 3 * h * d], "heads": h, "fwd_bwd_ms": ms,
            "sdpa_fwd_bwd_ms": sdpa_ms, "bound_ms": bms, "bound_by": by,
            "note": "SDPA is a yardstick only; the op stays the JAX "
                    "package's einsum math"}


def lm_full_phase(mt, torch, np, F, smi):
    """``lm_full``: ``build_symbol(TransformerLMSpec(**GPT2_SMALL), 1024)``
    through ``Module.fit`` at batch 8, fp32 without TF32, Adam lr 3e-4,
    ``Accuracy(axis=2)`` in the step, random token ids from seed 0 over
    4 staged batches: the gradient check against float64 at batch 2 and
    its mask probe, captured replays against eager steps, ``from_module``
    at full width, then timed replays and a device trace."""
    from mxnet_tpu_torch import profile_training as pt
    dec = mt.serving.decode
    spec = gpt2_spec(mt, "gpt2s-train")
    sym = dec.build_symbol(spec, spec.max_seq)
    batches = lm_full_batches(mt, torch, np, spec, LM_FULL_BATCH,
                              LM_FULL_STAGED)
    m = mt.mod.Module(sym, data_names=("data",),
                      label_names=("softmax_label",), context=LM_DEVICE)
    m.bind(data_shapes=[("data", (LM_FULL_BATCH, spec.max_seq))],
           label_shapes=[("softmax_label", (LM_FULL_BATCH, spec.max_seq))])
    m.init_params(mt.init.Xavier(),
                  generator=torch.Generator().manual_seed(SEED))
    m.init_optimizer(optimizer="adam",
                     optimizer_params={"learning_rate": LM_FULL_LR})
    n_params = sum(v.numel() for v in m.get_params()[0].values())

    # the gradient check at batch 2, and its probe
    small = lm_full_batches(mt, torch, np, spec, LM_FULL_CHECK_BATCH, 1,
                            seed=1)[0]
    feed = {"data": small.data[0], "softmax_label": small.label[0]}
    grad = lm_full_grad_check(mt, torch, m, sym, feed)
    probe = lm_full_grad_check(mt, torch, m, sym, feed,
                               attention=lm_mask_probe_attention)
    del feed, small
    gc.collect()
    torch.cuda.empty_cache()

    # Module.fit: the warm-up steps (eager, the capture, a replay)
    metric = mt.metric.Accuracy(axis=2)
    mt.compile_report(reset=True)
    totals0 = registry_totals(mt)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m.fit(mt.io.ResizeIter(four_batches(mt, batches), LM_FULL_WARMUP),
          eval_metric=metric, optimizer="adam",
          optimizer_params={"learning_rate": LM_FULL_LR}, num_epoch=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_peak = torch.cuda.max_memory_allocated() / 1e9
    delta = registry_delta(totals0, registry_totals(mt))

    # captured replays against eager steps
    feeds = [{"data": b.data[0], "softmax_label": b.label[0]}
             for b in batches[:3]]
    replays = lm_replays_vs_eager(torch, m, feeds,
                                  (LM_FULL_LR, LM_FULL_LR / 2,
                                   LM_FULL_LR / 4))
    del feeds
    gc.collect()
    torch.cuda.empty_cache()

    # timed replays, then a device trace
    r = timed_runs(torch, lambda i: pt.run_step(m, batches[i % 4]),
                   LM_FULL_TIMED)
    events = []
    for i in range(LM_FULL_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        pt.run_step(m, batches[i % 4])
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events]
    trace = pt.device_trace(lambda i: pt.run_step(m, batches[i % 4]),
                            LM_FULL_TRACE)
    busy = pt.busy_summary(trace, LM_FULL_TRACE)
    per_kernel = trace["per_kernel"]
    foreach = sum(v for k, v in per_kernel.items()
                  if "multi_tensor_apply" in k or "foreach" in k) \
        / LM_FULL_TRACE
    dev_ms = sum(per_kernel.values()) / LM_FULL_TRACE if per_kernel \
        else None
    med = statistics.median(step_ms)

    # from_module at full width: a 512-token prompt's prefill token
    # against the Module's eval forward at position 511
    prompt = batches[0].data[0][0, :LM_FULL_PROMPT].to(torch.int32) \
        .cpu().numpy()
    pred = dec.DecodePredictor.from_module(
        m, spec, slots=1, seq_buckets=(LM_FULL_PROMPT,),
        name="gpt2s-from-module")
    tok = list(pred.generate(prompt, max_new_tokens=1))[0]
    m.forward(batches[0], is_train=False)
    logp = torch.log(m.get_outputs()[0].data[0, LM_FULL_PROMPT - 1].double())
    top = torch.topk(logp, 2)
    gap = float(top.values[0] - top.values[1])
    del pred
    attn = lm_attention_timing(mt, torch, F)
    emb_det = lm_embedding_determinism(mt, torch)
    tokens = LM_FULL_BATCH * spec.max_seq
    row = {"phase": "lm_full", "spec": GPT2_SMALL, "params": n_params,
           "batch": LM_FULL_BATCH, "tokens_per_step": tokens,
           "dtype": "float32", "tf32": False, "optimizer": "adam",
           "lr": LM_FULL_LR,
           "grad_check_batch_2": grad, "mask_probe": probe,
           "fit_warmup": {"steps": LM_FULL_WARMUP, "seconds": warm_s,
                          "max_memory_allocated_gb": warm_peak,
                          "compile_report_delta": delta,
                          "accuracy": float(metric.get()[1])},
           "replays_vs_eager": replays,
           "ms_per_step_events": {"median": med, "min": min(step_ms),
                                  "max": max(step_ms),
                                  "spread": (max(step_ms) - min(step_ms))
                                  / med, "runs": step_ms},
           "tokens_per_s": tokens / (med / 1e3),
           "host_ms_per_step": r["host_ms"],
           "steady_max_memory_allocated_gb":
               r["max_memory_allocated_gb"],
           "steady_max_memory_reserved_gb": r["max_memory_reserved_gb"],
           "trace": busy,
           "foreach_kernels_ms_per_step": foreach,
           "adam_update_share": foreach / dev_ms if dev_ms else
           "not measured",
           "from_module_prefill": {"prompt": LM_FULL_PROMPT,
                                   "token": tok,
                                   "eval_argmax": int(top.indices[0]),
                                   "top2_logit_gap": gap,
                                   "checked": gap > F64_MARGIN},
           "attention": attn,
           "embedding_backward_bit_identical_twice": emb_det,
           "card": smi}
    emit(row)
    check(grad["ok"], f"lm_full: the fused step's gradients against "
                      f"float64: {grad}")
    check(not probe["ok"], f"lm_full: the mask probe passed the "
                           f"gradient check: {probe}")
    check(all(emb_det.values()), f"lm_full: Embedding's weight gradient "
                                 f"differs between two runs: {emb_det}")
    check(delta["fresh_compiles"] == 1 and delta["retraces"] <= 1,
          f"lm_full fit: one capture expected: {delta}")
    check(gap <= F64_MARGIN or tok == int(top.indices[0]),
          f"lm_full: from_module's prefill token {tok} against the eval "
          f"forward's argmax {int(top.indices[0])} (gap {gap})")
    del m, batches
    gc.collect()
    torch.cuda.empty_cache()
    return row


def slice11_phases(mt, torch, np, F, smi):
    """lm_fit, lm_serve, lm_spec and lm_full (slice 11). Returns D1's
    launches in lm_spec for the kernels line."""
    seconds, t0 = {}, [time.perf_counter()]

    def lap(name):
        seconds[name] = time.perf_counter() - t0[0]
        t0[0] = time.perf_counter()

    d1 = lm_small_phases(mt, torch, np, smi, seconds, lap)
    gc.collect()
    torch.cuda.empty_cache()
    lm_full_phase(mt, torch, np, F, smi)
    lap("lm_full")
    emit({"phase": "slice11_seconds", "seconds": seconds})
    return d1


# ---------------------------------------------------------------------------
# Slice 12: row-sparse embedding training (bench.py phase H, the
# two-tower example) and fit's data pipeline (phase 7's ResNet-50 over
# host batches). No kernel of the repo lies on the sparse path: the
# gather, the dedup and the lazy rows are the reference's jnp, plain
# PyTorch here; the data_pipeline phase runs K1, K2, B1 and B2.
# ---------------------------------------------------------------------------
SP_VOCAB, SP_DIM, SP_BATCH, SP_LEN = 100_000, 16, 256, 8   # phase H
SP_VOCAB_LARGE = 40_000_000     # MLPerf DLRM's cap on a Criteo table
SP_SGD = {"learning_rate": 0.1, "momentum": 0.9}
SP_ADAM = {"learning_rate": 0.01}
SP_STAGED = 4
SP_AB_RUNS = ("sparse", "dense", "dense", "sparse")
SP_AB_STEPS = 20
SP_CHECK_STEPS = 4
SP_TRACE = 5                    # replays in the device trace
# dedup rows on the card against the CPU's: sums of a slot's float32
# occurrences (up to ~2,048 in the duplicates case, values N(0, 1)) in
# another order
SP_ROW_TOL = 1e-3
# row_update_ on the card against the CPU: the same float32 operations
# (the card may contract a multiply-add)
SP_RULE_TOL = 1e-6
SP_DEVICE = "cuda:0"
TT_FAULT_STEP = 40              # the two-tower default: 32 steps an epoch
TT_PROB_TOL = 1e-5
DP_BATCH = 128
DP_HOST_BATCHES = 6
DP_EPOCHS = 2
DP_RUNS = ("1", "0", "0", "1")  # MXTPU_DATA_PIPELINE, in turns
DP_JOIN_S = 5.0
SC_VOCAB = 1000                 # stager_capture's table
SC_BATCHES = 2048               # host batches of 8 x 256 fp32, cycled
SC_LEAD = 50                    # batches taken before the capture
SC_PROBE_S = 180                # the child process's time limit


def sp_module(mt, torch, op, vocab, opt="sgd", params=None):
    """bench.py phase H's model on the port: ids (batch, 8) -> ``op``
    (vocab, 16) -> sum over the ids -> FullyConnected(2) ->
    SoftmaxOutput, fused, Xavier from ``SEED``."""
    d = mt.sym.Variable("data")
    e = getattr(mt.sym, op)(data=d, input_dim=vocab, output_dim=SP_DIM,
                            name="emb")
    f = mt.sym.FullyConnected(mt.sym.sum(e, axis=1), num_hidden=2,
                              name="fc")
    m = mt.mod.Module(mt.sym.SoftmaxOutput(f, name="softmax"),
                      context=SP_DEVICE, fused=True)
    m.bind([("data", (SP_BATCH, SP_LEN))], [("softmax_label", (SP_BATCH,))])
    m.init_params(mt.init.Xavier(),
                  generator=torch.Generator().manual_seed(SEED))
    m.init_optimizer(optimizer=opt,
                     optimizer_params=dict(params or SP_SGD))
    return m


def sp_batches(mt, torch, np, vocab, n, seed, ids=None):
    """``n`` batches of random ids in [0, vocab) (or ``ids(i)``) and
    labels, on the card, each carrying its host copy as ``host`` (what
    the sparse id statistics read)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = (ids(i) if ids is not None else
             rng.randint(0, vocab, (SP_BATCH, SP_LEN))).astype(np.int32)
        y = rng.randint(0, 2, (SP_BATCH,)).astype(np.float32)
        host = mt.io.DataBatch([torch.from_numpy(x)],
                               [torch.from_numpy(y)])
        b = mt.io.DataBatch([host.data[0].to(SP_DEVICE)],
                            [host.label[0].to(SP_DEVICE)])
        b.host = host
        out.append(b)
    return out


def fused_state(torch, f):
    """A fused step's masters, optimizer state leaves and aux (their
    views: the flat buffers' alignment padding holds nothing) and ``t``,
    cloned where they lie; a routed table's trash rows too."""
    out = {"t": f._t.clone()}
    out.update({n: p.clone() for n, p in f._p.items()})
    out.update({f"aux:{n}": a.clone() for n, a in f._aux.items()})
    for n, leaves in f._state.items():
        for i, x in enumerate(leaves):
            out[f"{n}/state{i}"] = x.clone()
    for n, t in f._tables.items():
        out[f"{n}/trash"] = torch.stack(
            [t[-1]] + [x[-1] for x in f._table_state[n]])
    return out


def sp_rules(fo):
    return (("sgd_momentum", fo.create("sgd", momentum=0.9)),
            ("adam", fo.create("adam")))


def sp_rows_case(mt, torch, np, name, ids, capacity, vocab, rng):
    """dedup / segment-sum / row_update_ of one id batch on the card
    against the CPU; two card calls bit for bit; untouched rows and the
    trash row frozen."""
    from mxnet_tpu_torch.parallel import functional_opt as fo
    rs = mt.sparse.rowsparse
    vals = rng.standard_normal(ids.shape + (SP_DIM,)).astype(np.float32)
    ti, tv = torch.from_numpy(ids), torch.from_numpy(vals)
    cpu = rs.dedup_rows(ti, tv, vocab, capacity=capacity)
    g1 = rs.dedup_rows(ti.cuda(), tv.cuda(), vocab, capacity=capacity)
    g2 = rs.dedup_rows(ti.cuda(), tv.cuda(), vocab, capacity=capacity)
    seg_cpu = rs.segment_rows(tv.reshape(-1, SP_DIM), ti.reshape(-1) % 97,
                              97)
    seg_gpu = rs.segment_rows(tv.reshape(-1, SP_DIM).cuda(),
                              ti.reshape(-1).cuda() % 97, 97)
    row = {"case": name, "ids": int(ids.size),
           "unique": int(np.unique(ids).size),
           "capacity": int(cpu.ids.shape[0]),
           "ids_equal": bool(torch.equal(g1.ids.cpu(), cpu.ids)),
           "rows_max_abs_err": float((g1.rows.cpu() - cpu.rows).abs().max()),
           "segment_max_abs_err": float((seg_gpu.cpu() - seg_cpu)
                                        .abs().max()),
           "two_calls_bitwise": bool(torch.equal(g1.ids, g2.ids)
                                     and torch.equal(g1.rows, g2.rows)),
           "limit": SP_ROW_TOL, "rules": {}}
    touched = torch.zeros(vocab + 1, dtype=torch.bool)
    touched[torch.from_numpy(np.unique(ids)).long()] = True
    for rname, rule in sp_rules(fo):
        table = torch.from_numpy(rng.standard_normal(
            (vocab + 1, SP_DIM)).astype(np.float32))
        table[vocab] = 0
        leaves = tuple(torch.from_numpy(np.abs(rng.standard_normal(
            (vocab + 1, SP_DIM))).astype(np.float32) * 0.1)
            for _ in rule.init(table))
        for x in leaves:
            x[vocab] = 0
        before = [table.clone()] + [x.clone() for x in leaves]
        lr = torch.tensor(0.1)
        rule.row_update_(table, cpu.ids, cpu.rows, leaves, lr, 1e-4, t=3)
        gt = before[0].cuda()
        gl = tuple(x.cuda() for x in before[1:])
        rule.row_update_(gt, g1.ids, g1.rows, gl, lr.cuda(), 1e-4,
                         t=torch.tensor(3).cuda())
        got = [gt.cpu()] + [x.cpu() for x in gl]
        want = [table] + list(leaves)
        frozen = all(torch.equal(g[~touched], b[~touched])
                     for g, b in zip(got, before))
        row["rules"][rname] = {
            "max_abs_err": max(float((g - w).abs().max())
                               for g, w in zip(got, want)),
            "untouched_and_trash_frozen": frozen, "limit": SP_RULE_TOL}
    return row, g1


def sp_rows_failures(row):
    fails = []
    if not row["ids_equal"]:
        fails.append("ids")
    if row["rows_max_abs_err"] > SP_ROW_TOL:
        fails.append("rows")
    if row["segment_max_abs_err"] > SP_ROW_TOL:
        fails.append("segment_sum")
    if not row["two_calls_bitwise"]:
        fails.append("determinism")
    for rname, r in row["rules"].items():
        if r["max_abs_err"] > SP_RULE_TOL:
            fails.append(f"{rname} rows")
        if not r["untouched_and_trash_frozen"]:
            fails.append(f"{rname} untouched rows")
    return fails


def sparse_rows_phase(mt, torch, np):
    """dedup, segment-sum and row_update_ on the card against their CPU
    results (duplicates, the sentinel tail, ids at 0 and vocab - 1, a
    capacity override), a captured dedup replayed under the sync check,
    and the fault probe: a sentinel planted at row 0."""
    from mxnet_tpu_torch.parallel import functional_opt as fo
    rs = mt.sparse.rowsparse
    rng = np.random.default_rng(SEED)
    shape = (SP_BATCH, SP_LEN)
    edges = rng.integers(0, SP_VOCAB, shape)
    edges[0, 0], edges[-1, -1], edges[3, 4] = 0, SP_VOCAB - 1, 0
    cases = (("duplicates", rng.integers(1, 50, shape), None),
             ("sentinel_tail", rng.integers(0, SP_VOCAB, shape), None),
             ("edges_0_and_vocab_minus_1", edges, None),
             ("capacity_override", rng.integers(0, 300, shape), 300))
    rows = []
    for name, ids, cap in cases:
        row, _ = sp_rows_case(mt, torch, np, name, ids.astype(np.int32),
                              cap, SP_VOCAB, rng)
        row["failures"] = sp_rows_failures(row)
        rows.append(row)
        emit(dict({"phase": "sparse_rows"}, **row))
        check(not row["failures"], f"sparse_rows {name}: {row}")
    # a captured dedup replays with no host sync, bit for bit the eager
    ids = torch.from_numpy(cases[0][1].astype(np.int32)).cuda()
    vals = torch.randn(shape + (SP_DIM,), device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rs.dedup_rows(ids, vals, SP_VOCAB)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = rs.dedup_rows(ids, vals, SP_VOCAB)
    new_ids = torch.from_numpy(cases[1][1].astype(np.int32)).cuda()
    ids.copy_(new_ids)
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager = rs.dedup_rows(new_ids, vals, SP_VOCAB)
    captured_ok = bool(torch.equal(cap.ids, eager.ids)
                       and torch.equal(cap.rows, eager.rows))
    emit({"phase": "sparse_rows_captured", "bitwise_vs_eager": captured_ok,
          "replayed_under": "torch.cuda.set_sync_debug_mode('error')"})
    check(captured_ok, "a captured dedup differs from the eager one")
    del graph, cap
    # the probe: the sentinel of a dedup planted at row 0 (the classic
    # padding bug), which then takes momentum and weight decay
    real = rs.dedup_rows

    def alias0(i, v, num_rows, capacity=None):
        r = real(i, v, num_rows, capacity)
        return rs.RowSparseRows(torch.where(r.ids == num_rows, 0, r.ids),
                                r.rows, r.num_rows)

    rs.dedup_rows = alias0
    try:
        probe, _ = sp_rows_case(mt, torch, np, "probe_sentinel_at_row_0",
                                cases[0][1].astype(np.int32), None,
                                SP_VOCAB, rng)
    finally:
        rs.dedup_rows = real
    probe["failures"] = sp_rows_failures(probe)
    emit(dict({"phase": "sparse_rows_fault_probe"}, **probe))
    check(probe["failures"], "the sparse_rows checks pass a sentinel "
                             "aliasing row 0")
    return rows


def sp_timed(torch, m, batches, n):
    """``n`` steps of Module ``m`` over ``batches``: (ms a step on the
    card's clock, host ms a step, peak bytes the steps allocated)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for i in range(n):
        m.forward(batches[i % len(batches)], is_train=True)
        m.update()
    b.record()
    b.synchronize()
    host = (time.perf_counter() - t0) / n * 1e3
    return (a.elapsed_time(b) / n, host,
            torch.cuda.max_memory_allocated() - base)


def sp_update_bytes(rows):
    """Bytes the update of ``rows`` table rows moves, counted from
    shapes: the rows of the param, gradient and momentum read, of the
    param and momentum written (float32)."""
    return 5 * rows * SP_DIM * 4


def sp_economics(mt, torch, np, smi, vocab, check_steps):
    """The sparse and dense modules at ``vocab``, each captured, timed
    in turns; with ``check_steps`` also replays against eager steps and
    the guard."""
    batches = sp_batches(mt, torch, np, vocab, SP_STAGED, SEED + 1)
    out = {"vocab": vocab, "dim": SP_DIM, "batch": SP_BATCH,
           "ids_per_step": SP_BATCH * SP_LEN, "card": smi,
           "table_gb": vocab * SP_DIM * 4 / 1e9}
    mods, first = {}, {}
    for op, key in (("SparseEmbedding", "sparse"), ("Embedding", "dense")):
        t0 = time.perf_counter()
        m = sp_module(mt, torch, op, vocab)
        # the warm (eager) step and the capture: what they allocate
        # beyond the module (a replay allocates nothing: the graph's
        # pool keeps what the capture took)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for b in batches[:2]:
            m.forward(b, is_train=True)
            m.update()
        torch.cuda.synchronize()
        first[key] = {"peak_bytes": torch.cuda.max_memory_allocated()
                      - base,
                      "kept_bytes": torch.cuda.memory_allocated() - base}
        mods[key] = m
        out[f"{key}_setup_s"] = time.perf_counter() - t0
    check(len(mods["sparse"]._fused._sparse_sites) == 1
          and not mods["dense"]._fused._sparse_sites,
          "phase H: the sparse model must route its table, the dense not")
    runs = {"sparse": [], "dense": []}
    mt.sparse.sparse_report(reset=True)
    for key in SP_AB_RUNS:
        runs[key].append(sp_timed(torch, mods[key], batches, SP_AB_STEPS))
    rep = mt.sparse.sparse_report()
    for key, rr in runs.items():
        ms = [r[0] for r in rr]
        out[key] = {"ms_per_step_events": statistics.median(ms),
                    "ms_per_step_runs": ms,
                    "host_ms_per_step": statistics.median(r[1] for r in rr),
                    "rows_per_s": SP_BATCH * 1e3 / statistics.median(ms),
                    "replay_peak_bytes": max(r[2] for r in rr),
                    "warm_and_capture": first[key],
                    "update_bytes_from_shapes": sp_update_bytes(
                        SP_BATCH * SP_LEN if key == "sparse" else vocab),
                    "captures": sum(p.captured for p in
                                    mods[key]._fused._programs.values())}
    # the captured programs alone: device ms a replay back to back, and
    # the kernels of 5 replays by name (torch.profiler)
    from mxnet_tpu_torch import profile_training as pt
    for key, m in mods.items():
        prog = next(p for p in m._fused._programs.values() if p.captured)
        ms = time_ms(prog.replay, reps=3, inner=10, warmup=2)
        tr = pt.busy_summary(pt.device_trace(lambda i: prog.replay(),
                                             SP_TRACE), SP_TRACE)
        out[key].update({
            "replay_device_ms": ms,
            "busy_share": ms / out[key]["ms_per_step_events"],
            "kernels_per_replay_ms": tr["device_kernel_ms_per_step"],
            "top_kernels_ms_per_replay": tr["top_kernels_ms_per_step"][:8]})
    out["dense_gradient_bytes_from_shapes"] = vocab * SP_DIM * 4
    out["sparse_report"] = {k: rep.get(k) for k in (
        "dedup_ratio", "touched_rows", "steps", "ids_total", "sites",
        "gather_bytes", "scatter_bytes")}
    out["touched_rows_per_step"] = rep["touched_rows"] / max(rep["steps"],
                                                             1)
    out["sparse_over_dense_time"] = (out["sparse"]["ms_per_step_events"]
                                     / out["dense"]["ms_per_step_events"])
    check(rep["steps"] == 2 * SP_AB_STEPS and rep["sites"] == 1,
          f"sparse_report counted {rep}")
    if vocab >= SP_VOCAB_LARGE:
        # no (vocab, dim) gradient for the routed table: what the
        # sparse step's warm step and capture allocate (the graph pool,
        # workspaces: ~135 MB at 100k rows too) stays far below one
        # table, the dense step's exceeds it
        table = vocab * SP_DIM * 4
        sp_peak = first["sparse"]["peak_bytes"]
        dn_peak = first["dense"]["peak_bytes"]
        check(sp_peak < table / 10 and dn_peak > table,
              f"warm and capture peaks at {vocab}: sparse {sp_peak}, "
              f"dense {dn_peak}, table {table}")
    if check_steps:
        out["checks"] = sp_checks(mt, torch, np, mods["sparse"], vocab)
    del mods
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_checks(mt, torch, np, m, vocab):
    """Replays against eager steps bit for bit (fresh modules from one
    init) and the guard skipping a NaN row on the captured module."""
    batches = sp_batches(mt, torch, np, vocab, SP_CHECK_STEPS, SEED + 2)
    rep, eag = (sp_module(mt, torch, "SparseEmbedding", vocab)
                for _ in range(2))
    for b in batches:
        rep.forward(b, is_train=True)
        rep.update()                 # warm, capture, replays
        eag.forward(b, is_train=True)
        eag._update(eager=True)
    a, e = fused_state(torch, rep._fused), fused_state(torch, eag._fused)
    diff = [k for k in a if not torch.equal(a[k], e[k])]
    captures = sum(p.captured for p in rep._fused._programs.values())
    # the guard: an out-of-range id gives a NaN row; the step is skipped
    bad = sp_batches(mt, torch, np, vocab, 1, SEED + 3)[0]
    bad.data[0][5, 3] = vocab + 7
    before = fused_state(torch, m._fused)
    skips0 = int(m._fused.fault_state[0])
    m.forward(bad, is_train=True)
    m.update()
    after = fused_state(torch, m._fused)
    changed = [k for k in before if k != "t"
               and not torch.equal(before[k], after[k])]
    res = {"replays_vs_eager_differ": diff, "captures": captures,
           "guard_skip_changed": changed,
           "guard_t_advanced": int(after["t"]) - int(before["t"]),
           "guard_skips": int(m._fused.fault_state[0]) - skips0}
    check(not diff and captures == 1,
          f"sparse replays against eager steps: {res}")
    check(not changed and res["guard_skips"] == 1
          and res["guard_t_advanced"] == 1,
          f"a skipped sparse step changed the state: {res}")
    return res


def sp_full_coverage(mt, torch, np):
    """Every row touched twice a step (vocab = 1,024 from 2,048 ids):
    the captured sparse step equals the captured dense step bit for bit,
    for sgd and adam."""
    vocab = SP_BATCH * SP_LEN // 2
    perm = np.random.RandomState(SEED + 4)

    def ids(i):
        return perm.permutation(np.tile(np.arange(vocab), 2)) \
            .reshape(SP_BATCH, SP_LEN)

    batches = sp_batches(mt, torch, np, vocab, SP_CHECK_STEPS, SEED + 5,
                         ids=ids)
    out = {}
    for opt, params in (("sgd", SP_SGD), ("adam", SP_ADAM)):
        res = {}
        for op in ("SparseEmbedding", "Embedding"):
            m = sp_module(mt, torch, op, vocab, opt, params)
            for b in batches:
                m.forward(b, is_train=True)
                m.update()
            args, _ = m.get_params()
            st = m._fused.states_snapshot()["state"]
            res[op] = (args, st, len(m._fused._sparse_sites))
        sp_, dn_ = res["SparseEmbedding"], res["Embedding"]
        diff = [n for n in sp_[0] if not torch.equal(sp_[0][n].cpu(),
                                                      dn_[0][n].cpu())]
        diff += [f"{n}/state{i}" for n in sp_[1]
                 for i, (x, y) in enumerate(zip(sp_[1][n], dn_[1][n]))
                 if not np.array_equal(x, y)]
        out[opt] = {"differ": diff, "routed": (sp_[2], dn_[2])}
        check(not diff and sp_[2] == 1 and dn_[2] == 0,
              f"full coverage {opt}: sparse against dense {out[opt]}")
    return out


def sparse_fit_phase(mt, torch, np, smi):
    """bench.py phase H at its own sizes (vocab 100,000, dim 16, batch
    256 x 8 ids, SGD lr 0.1 momentum 0.9, fp32), then only the vocab
    raised to 40,000,000."""
    res = sp_economics(mt, torch, np, smi, SP_VOCAB, True)
    res["full_coverage"] = sp_full_coverage(mt, torch, np)
    emit(dict({"phase": "sparse_fit"}, **res))
    big = sp_economics(mt, torch, np, smi, SP_VOCAB_LARGE, False)
    emit(dict({"phase": "sparse_fit_40m"}, **big))
    return res, big


def tt_state(np, m):
    f = m._fused
    args, _ = m.get_params()
    out = {n: v.cpu().numpy() for n, v in args.items()}
    for n, leaves in f.states_snapshot()["state"].items():
        for i, x in enumerate(leaves):
            out[f"{n}/state{i}"] = np.array(x)
    out["t"] = int(f._t)
    return out


def two_tower_phase(mt, torch, np, smi):
    """The two-tower example at its default sizes on the card: fit over
    a DataPipeline with a CheckpointManager; a sparse_update raise in
    epoch 2, then fit(auto_resume=True), bit for bit an uninterrupted
    run; Predictor on int32 ids against the module's own forward."""
    from mxnet_tpu_torch.examples.sparse import two_tower as tt
    work = tempfile.mkdtemp(prefix="two_tower_")
    kw = dict(device=SP_DEVICE, quiet=True)
    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    mt.sparse.sparse_report(reset=True)
    ref, acc = tt.train(os.path.join(work, "ref"), **kw)
    fit_s = time.perf_counter() - t0
    report = mt.sparse.sparse_report()
    want = tt_state(np, ref)
    torch.manual_seed(SEED)
    raised = None
    with mt.faultinject.inject(f"sparse_update:step={TT_FAULT_STEP}"):
        try:
            tt.train(os.path.join(work, "run"), **kw)
        except mt.faultinject.FaultInjected as e:
            raised = str(e)
    torch.manual_seed(SEED + 1)
    resumed, acc2 = tt.train(os.path.join(work, "run"), **kw)
    got = tt_state(np, resumed)
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    # Predictor on int32 ids against the module's eval forward
    args, aux = resumed.get_params()
    pred = mt.serving.Predictor(
        resumed.symbol, args, aux, data_names=("user", "item"),
        data_shapes={"user": (1,), "item": (1,)}, buckets=(8, 32),
        device=SP_DEVICE)
    rng = np.random.RandomState(SEED)
    req = {"user": rng.randint(0, 200, (32, 1)).astype(np.int32),
           "item": rng.randint(0, 100, (32, 1)).astype(np.int32)}
    served = pred.predict(req)
    resumed.forward(mt.io.DataBatch(
        [torch.from_numpy(req["user"]).to(SP_DEVICE),
         torch.from_numpy(req["item"]).to(SP_DEVICE)]), is_train=False)
    own = resumed.get_outputs()[0].data.float().cpu().numpy()
    scores = tt.serve(resumed, n_requests=64, device=SP_DEVICE)
    row = {"phase": "two_tower", "fit_s": fit_s, "train_acc": acc,
           "resumed_acc": acc2, "fault": raised,
           "fault_step": TT_FAULT_STEP, "resume_differs": differ,
           "t": got["t"], "predictor_vs_forward_max_abs_err":
           float(np.abs(served - own).max()), "limit": TT_PROB_TOL,
           "batcher_rows": int(scores.shape[0]),
           "routed": sorted(resumed._fused._routed),
           "sparse_report": report, "card": smi}
    emit(row)
    check(raised is not None, "the sparse_update fault did not fire")
    check(not differ, f"two_tower resume differs from the uninterrupted "
                      f"run: {differ}")
    check(row["predictor_vs_forward_max_abs_err"] <= TT_PROB_TOL
          and served.shape == (32, 2),
          f"two_tower Predictor against the module: {row}")
    shutil.rmtree(work, ignore_errors=True)
    return row


def dp_fit(mt, torch, np, flag, it):
    """One phase-7 ResNet-50 fit (s2d, bf16, batch 128, SGD) over ``it``
    with ``MXTPU_DATA_PIPELINE=flag``; (row, the fused step's masters,
    momenta and aux, launches)."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch import profile_training as pt
    fb = mt.ops.fused_bn_conv
    m = pt.build_module(DP_BATCH, SEED)
    events = []

    def on_batch(param):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    it.reset()
    mt.data_report(reset=True)
    torch.cuda.synchronize()
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    with config.override("MXTPU_DATA_PIPELINE", flag):
        m.fit(it, kvstore=None, optimizer="sgd",
              optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-4},
              batch_end_callback=on_batch, num_epoch=DP_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fb.launch_counts()
    rep = mt.data_report()
    f = m._fused
    steps = DP_EPOCHS * DP_HOST_BATCHES
    gaps = [a.elapsed_time(b) for a, b in
            zip(events[DP_HOST_BATCHES:], events[DP_HOST_BATCHES + 1:])]
    state = fused_state(torch, f)
    progs = [p for p in f._programs.values() if p.captured]
    check(len(progs) == 1, f"data_pipeline fit captured {len(progs)} "
                           "programs, 1 expected")
    replay_ms = time_ms(progs[0].replay, reps=3, inner=5, warmup=1) \
        if progs else float("nan")
    ms = statistics.median(gaps)
    row = {"pipeline": flag, "steps": steps, "fit_s": wall,
           "ms_per_step_events": ms, "img_per_s": DP_BATCH * 1e3 / ms,
           "replay_device_ms": replay_ms, "busy_share": replay_ms / ms,
           "data_wait_s": rep["wait_s"], "data_waits": rep["waits"],
           "next_calls": rep["next_calls"],
           "starvation_fraction": rep["starvation_fraction"],
           "launches": launches}
    return row, state, launches, m


def data_pipeline_phase(mt, torch, np, smi):
    """Phase 7's ResNet-50 through Module.fit over an NDArrayIter of host
    numpy batches, MXTPU_DATA_PIPELINE 1 and 0 in turns: ms a step,
    img/s, busy share, data waits; the parameters bit-identical between
    the two; the data_worker fault and close()."""
    rng = np.random.RandomState(SEED)
    n = DP_BATCH * DP_HOST_BATCHES
    data = rng.rand(n, 3, 224, 224).astype(np.float32)
    # int32 labels, as phase 7 stages them: a float32 label would be
    # cast to bf16 with the other inputs (C-ref-3), and 999 rounds to
    # 1000, an index past the classes
    label = rng.randint(0, 1000, n).astype(np.int32)
    it = mt.io.NDArrayIter(data, label, DP_BATCH)
    rows, states, launches = [], {}, None
    for flag in DP_RUNS:
        row, st, la, m = dp_fit(mt, torch, np, flag, it)
        rows.append(row)
        states.setdefault(flag, st)
        if launches is None:
            launches = la
        del m
        gc.collect()
        torch.cuda.empty_cache()
    same = sorted(states["1"]) == sorted(states["0"]) and all(
        torch.equal(states["1"][k], states["0"][k]) for k in states["1"])
    summary = {}
    for flag in ("1", "0"):
        rr = [r for r in rows if r["pipeline"] == flag]
        summary[flag] = {k: statistics.median(r[k] for r in rr) for k in (
            "ms_per_step_events", "img_per_s", "busy_share",
            "replay_device_ms", "data_wait_s", "starvation_fraction")}
    # the data_worker fault surfaces at next(); close() within its limit
    pipe = mt.data.DataPipeline(it, num_workers=2, sharding="cuda:0",
                                name="dp_fault")
    raised = None
    with mt.faultinject.inject("data_worker:batch=2"):
        try:
            for _ in range(DP_HOST_BATCHES):
                pipe.next()
        except mt.faultinject.FaultInjected as e:
            raised = str(e)
    t0 = time.perf_counter()
    pipe.close()
    close_s = time.perf_counter() - t0
    steps = DP_EPOCHS * DP_HOST_BATCHES
    out = {"phase": "data_pipeline", "batch": DP_BATCH,
           "host_batches": DP_HOST_BATCHES, "epochs": DP_EPOCHS,
           "runs": rows, "median": summary, "params_bitwise_equal": same,
           "worker_fault": raised, "close_s": close_s,
           "close_limit_s": DP_JOIN_S, "card": smi}
    emit(out)
    check(same, "fit's parameters differ with and without the pipeline")
    check(raised is not None and "data_worker" in raised,
          "the data_worker fault did not surface at next()")
    check(close_s < DP_JOIN_S, f"close() took {close_s} s")
    for k, w in KERNEL_WRAPPERS.items():
        want = {"K1": 28, "K2": 60, "B1": 44, "B2": 44}[k] * steps
        check(launches[w] == want,
              f"data_pipeline fit launched {k} {launches[w]} times, "
              f"{want} expected")
    del data, it
    gc.collect()
    return {k: {"launches": launches[w], "launches_per_step":
                launches[w] / steps, "steps": steps,
                "path": "Module.fit over an NDArrayIter of host batches "
                        "through the DataPipeline (data_pipeline phase), "
                        "counts set to 0 just before it"}
            for k, w in KERNEL_WRAPPERS.items()}


def stager_capture(mt, torch, np, mode):
    """The sparse phase-H step at a small vocabulary captured while a
    ``DataPipeline`` streams host batches to the card: a consumer thread
    takes them as fast as the stager pins and copies them, so the
    stager's calls run during the capture. ``mode``: the fused step's
    capture error mode. A row: whether the capture held, its error, and
    the batches handed over around it."""
    from mxnet_tpu_torch.module.fused import FusedSymbolStep
    rng = np.random.RandomState(SEED)
    it = mt.io.NDArrayIter(rng.rand(SC_BATCHES * 8, 256).astype(np.float32),
                           np.zeros(SC_BATCHES * 8, np.float32), 8)
    pipe = mt.data.DataPipeline(it, sharding=SP_DEVICE, name="stager_capture")
    got, errors, stop = [0], [], threading.Event()

    def consume():
        try:
            torch.cuda.set_stream(torch.cuda.Stream(SP_DEVICE))
            while not stop.is_set():
                try:
                    pipe.next()
                except StopIteration:
                    pipe.reset()
                    continue
                got[0] += 1
        except Exception as e:      # noqa: BLE001 - reported in the row
            errors.append(f"{type(e).__name__}: {e}"[:300])

    old = FusedSymbolStep.capture_error_mode
    FusedSymbolStep.capture_error_mode = mode
    try:
        m = sp_module(mt, torch, "SparseEmbedding", SC_VOCAB)
        b = sp_batches(mt, torch, np, SC_VOCAB, 1, SEED)[0]
        m.forward(b, is_train=True)
        m.update()                  # the warm (eager) step
        torch.cuda.synchronize()
        t = threading.Thread(target=consume, daemon=True)
        t.start()
        deadline = time.perf_counter() + 30
        while got[0] < SC_LEAD and not errors and \
                time.perf_counter() < deadline:
            time.sleep(0.001)
        before, err = got[0], None
        try:
            m.forward(b, is_train=True)
            m.update()              # captures, then replays
            torch.cuda.synchronize()
        except Exception as e:      # noqa: BLE001 - reported in the row
            err = f"{type(e).__name__}: {e}"[:300]
        during = got[0] - before
        stop.set()
        t.join(10)
        pipe.close()
    finally:
        FusedSymbolStep.capture_error_mode = old
    progs = [p for p in m._fused._programs.values() if p.captured]
    return {"mode": mode, "captured": err is None and len(progs) == 1,
            "error": err, "batches_before": before,
            "batches_during_capture": during, "consumer_errors": errors,
            "consumer_joined": not t.is_alive()}


def stager_capture_phase(mt, torch, np):
    """stager_capture in this process (thread-local mode, as the port
    captures), then the global-mode probe in a child process, which must
    fail."""
    row = stager_capture(mt, torch, np, "thread_local")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--stager-capture",
         "global"], capture_output=True, text=True, timeout=SC_PROBE_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    try:
        probe = json.loads(lines[-1])
    except (IndexError, ValueError):
        probe = {"rc": proc.returncode, "stderr": proc.stderr[-600:]}
    out = {"phase": "stager_capture", "port": row, "probe_global": probe,
           "probe_rc": proc.returncode}
    emit(out)
    check(row["captured"] and not row["consumer_errors"]
          and row["consumer_joined"],
          f"stager_capture: the fused step's capture did not hold beside "
          f"the pipeline's stager: {row}")
    check(row["batches_during_capture"] > 0,
          f"stager_capture: no batch was staged during the capture: {row}")
    check(proc.returncode == 0 and probe.get("captured") is False,
          f"stager_capture probe: the global-mode capture beside the "
          f"stager did not fail: {probe}")


def stager_capture_main(mode):
    """``chip_smoke.py --stager-capture MODE``: one stager_capture row as
    the last line (the child process of the stager_capture phase)."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return 2
    import mxnet_tpu_torch as mt
    emit(stager_capture(mt, torch, np, mode))
    sys.stdout.flush()
    os._exit(0)     # the failed capture may leave the stager blocked


def slice12_phases(mt, torch, np, smi):
    """sparse_rows, sparse_fit (100k and 40M), two_tower and
    data_pipeline (slice 12). Returns the data_pipeline phase's K1, K2,
    B1 and B2 launches for the kernels line."""
    seconds, t0 = {}, [time.perf_counter()]

    def lap(name):
        seconds[name] = time.perf_counter() - t0[0]
        t0[0] = time.perf_counter()

    sparse_rows_phase(mt, torch, np)
    lap("sparse_rows")
    sparse_fit_phase(mt, torch, np, smi)
    lap("sparse_fit")
    two_tower_phase(mt, torch, np, smi)
    lap("two_tower")
    gc.collect()
    torch.cuda.empty_cache()
    launches = data_pipeline_phase(mt, torch, np, smi)
    lap("data_pipeline")
    stager_capture_phase(mt, torch, np)
    lap("stager_capture")
    emit({"phase": "slice12_seconds", "seconds": seconds,
          "total": sum(seconds.values())})
    return launches


# ---------------------------------------------------------------------------
# 18. the LSTM language models (slice 13)
# ---------------------------------------------------------------------------
L1_SHAPE = (512, 650)            # bench_lstm.py's batch and hidden width
L1_FP32_TOL = 1e-5               # absolute: the same fp32 arithmetic
L1_BF16_REL = 2 ** -7            # one bf16 rounding, relative to max(1, |x|)
L1_FLOPS = (36, 60)              # operations a cell, forward / backward
# the fused step (kernels/csrc/lstm_step.cu) against its plain versions,
# relative to max(1, |x|): one bf16 rounding of each output (2^-8) and
# the kernels' tanh.approx activations (2^-10.9); the fp32 outputs sum
# bf16 products whose dz may round the other way
STEP_TOL = 2 ** -7
STEP_FLOPS = (40, 60)            # the cell's operations a unit and row
RNN_SHAPE = (35, 512, 650, 2)    # T, N, C = H, layers: bench_lstm.py's
# relative L2 error of outputs and gradients: fp32 against the plain
# path and cuDNN (TF32 off; the sums are ordered otherwise), bf16 where
# the plain path rounds every intermediate to bf16 and L1 does not
RNN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSTM_STEP_RUNS = ("captured", "eager", "eager", "captured")
LSTM_STEP_N = 5                  # steps a timed run
LSTM_TRACE_STEPS = 3
# train.py's one epoch at its defaults on the JAX package (CPU):
# PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_lstm_examples.py
WLM_JAX_VAL_PPL = 496.17
WLM_PPL_MARGIN = 0.03            # relative: init and dropout draws differ
BUCKET_PPL_BAR = 170.0           # tests/test_bucketing_lm.py's bar
S13_DEVICE = "cuda:0"             # the slice's phases run here


def l1_case(mt, torch, gen, dtype):
    """L1 forward and backward at ``L1_SHAPE`` against the plain
    versions: errors, ms (events), plain ms and the bytes bound."""
    from mxnet_tpu_torch.ops import lstm_cell as lc
    n, h = L1_SHAPE
    dt = getattr(torch, dtype)

    def r(*shape):
        return torch.randn(shape, device=S13_DEVICE, generator=gen).to(dt)

    xg, hg, b, cp, dh, dc = (r(n, 4 * h), r(n, 4 * h), r(4 * h), r(n, h),
                             r(n, h), r(n, h))
    got = lc.lstm_cell_fwd(xg, hg, b, cp) + lc.lstm_cell_bwd(
        xg, hg, b, cp, dh, dc)
    want = lc.lstm_cell_fwd_plain(xg, hg, b, cp) + lc.lstm_cell_bwd_plain(
        xg, hg, b, cp, dh, dc)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("h", "c", "dz", "dc_prev"), got, want):
        d = (g.float() - w.float()).abs()
        errs[name] = {"max_abs_err": float(d.max()),
                      "max_rel_err": float((d / w.float().abs()
                                            .clamp_min(1.0)).max())}
    key, tol = (("max_abs_err", L1_FP32_TOL) if dtype == "float32"
                else ("max_rel_err", L1_BF16_REL))
    esize = 4 if dtype == "float32" else 2
    cells = n * h
    fwd_bytes = (2 * 4 * cells + 4 * h + cells + 2 * cells) * esize
    bwd_bytes = (2 * 4 * cells + 4 * h + 3 * cells + 4 * cells + cells) \
        * esize
    fb_ms, fb_by = bound_ms(fwd_bytes, L1_FLOPS[0] * cells, dtype)
    bb_ms, bb_by = bound_ms(bwd_bytes, L1_FLOPS[1] * cells, dtype)
    bz = torch.zeros_like(b)
    _, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(xg, hg, cp, b, bz)
    row = {"phase": "lstm_cell", "dtype": dtype, "shape": [n, h],
           "errors": errs, "tolerance": {key: tol},
           "fwd_ms": time_ms(lambda: lc.lstm_cell_fwd(xg, hg, b, cp)),
           "bwd_ms": time_ms(lambda: lc.lstm_cell_bwd(xg, hg, b, cp, dh,
                                                      dc)),
           "fwd_plain_ms": time_ms(
               lambda: lc.lstm_cell_fwd_plain(xg, hg, b, cp)),
           "bwd_plain_ms": time_ms(
               lambda: lc.lstm_cell_bwd_plain(xg, hg, b, cp, dh, dc)),
           "fwd_bound_ms": fb_ms, "bwd_bound_ms": bb_ms,
           "bound_by": fb_by if fb_by == bb_by else [fb_by, bb_by],
           "bytes": {"fwd": fwd_bytes, "bwd": bwd_bytes},
           "fwd_library_ms": time_ms(
               lambda: torch.ops.aten._thnn_fused_lstm_cell(
                   xg, hg, cp, b, bz)),
           "bwd_library_ms": time_ms(
               lambda: torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
                   dh, dc, cp, cy, ws, True)),
           "library": "torch.ops.aten._thnn_fused_lstm_cell and "
                      "_thnn_fused_lstm_cell_backward_impl (ATen's CUDA "
                      "LSTM cell, gates i, f, g, o)"}
    row["library_ms"] = row["fwd_library_ms"] + row["bwd_library_ms"]
    row["ms"] = row["fwd_ms"] + row["bwd_ms"]
    row["plain_ms"] = row["fwd_plain_ms"] + row["bwd_plain_ms"]
    row["bound_ms"] = fb_ms + bb_ms
    row["max_abs_err"] = max(e["max_abs_err"] for e in errs.values())
    emit(row)
    for name, e in errs.items():
        check(e[key] <= tol, f"L1 {dtype} {name}: {key} {e[key]} > {tol}")
    return row


def lstm_step_inputs(torch, gen):
    """One bf16 step's inputs at ``L1_SHAPE``: xg, b, c_prev, h_prev, wh,
    dy (bf16) and the recurrent gradients dh_rec, dc (fp32)."""
    n, h = L1_SHAPE

    def r(*shape, scale=1.0, dt=torch.bfloat16):
        return (torch.randn(shape, device=S13_DEVICE, generator=gen)
                * scale).to(dt)

    return (r(n, 4 * h), r(4 * h, scale=0.1), r(n, h), r(n, h),
            r(4 * h, h, scale=h ** -0.5), r(n, h, scale=0.1),
            r(n, h, scale=0.1, dt=torch.float32),
            r(n, h, scale=0.1, dt=torch.float32))


def step_errors(got, want, names):
    errs = {}
    for name, g, w in zip(names, got, want):
        d = (g.float() - w.float()).abs()
        errs[name] = {"max_abs_err": float(d.max()),
                      "max_rel_err": float((d / w.float().abs()
                                            .clamp_min(1.0)).max())}
    return errs


def lstm_step_case(mt, torch, gen):
    """The fused step (``kernels/csrc/lstm_step.cu``), forward and
    backward at ``L1_SHAPE`` in bf16 with the plan's tile and cluster,
    against the plain versions (the backward on the kernel's own z):
    errors, a repeated backward bit for bit, ms (events) beside the
    plain versions', the library's (``torch.matmul`` with ATen's CUDA
    LSTM cell; the port never calls it) and the bound."""
    from mxnet_tpu_torch.ops import lstm_cell as lc
    n, h = L1_SHAPE
    dt, f32 = torch.bfloat16, torch.float32
    xg, b, cp, hprev, wh, dy, dh_rec, dc = lstm_step_inputs(torch, gen)
    plan = lc._l1_plan(dt, n, h, torch.device(S13_DEVICE))
    w = lc.stage_recurrent_weight(wh)
    hbuf = torch.zeros((2, n, plan.hp), device=S13_DEVICE, dtype=dt)
    hbuf[0, :, :h] = hprev
    h_in, h_next = hbuf[0, :, :h], hbuf[1, :, :h]
    hout, cout = torch.empty_like(cp), torch.empty_like(cp)
    z = torch.empty_like(xg)
    dz = torch.empty_like(xg)
    dcp = torch.empty((n, h), device=S13_DEVICE, dtype=f32)
    dhp = torch.empty_like(dcp)

    def fwd():
        lc.lstm_step_fwd(xg, h_in, w, b, cp, hout, cout, z, h_next, plan)

    def bwd():
        lc.lstm_step_bwd(dy, dh_rec, dc, z, cp, w, dz, dcp, dhp, plan)

    fwd()
    bwd()
    want_f = lc.lstm_step_fwd_plain(xg, h_in, wh, b, cp)
    want_b = lc.lstm_step_bwd_plain(dy, dh_rec, dc, z, cp, wh)
    torch.cuda.synchronize()
    errs = step_errors((hout, cout, z, h_next), want_f + (want_f[0],),
                       ("h", "c", "z", "h_next"))
    errs.update(step_errors((dz, dcp, dhp), want_b,
                            ("dz", "dc_prev", "dh_prev")))
    first = (dz.clone(), dcp.clone(), dhp.clone())
    bwd()
    torch.cuda.synchronize()
    repeat_equal = all(torch.equal(a, c) for a, c in
                       zip(first, (dz, dcp, dhp)))
    bz = torch.zeros_like(b)
    hg = torch.matmul(hprev, wh.t())
    _, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(xg, hg, cp, b, bz)
    dh_lib, dc_lib = (dy.float() + dh_rec).to(dt), dc.to(dt)
    cells, g4 = n * h, n * 4 * h
    wbytes = 4 * h * h * 2
    # each input read once, each output written once (h once: its
    # recurrent copy is the kernel's own), the weight once
    fwd_bytes = (g4 + cells + 4 * h + cells) * 2 + wbytes \
        + (2 * cells + g4) * 2
    bwd_bytes = (cells + g4 + cells) * 2 + 2 * cells * 4 + wbytes \
        + g4 * 2 + 2 * cells * 4
    flops = 2 * n * 4 * h * h
    fb_ms, fb_by = bound_ms(fwd_bytes, flops + STEP_FLOPS[0] * cells,
                            "bfloat16")
    bb_ms, bb_by = bound_ms(bwd_bytes, flops + STEP_FLOPS[1] * cells,
                            "bfloat16")
    row = {"phase": "lstm_step", "dtype": "bfloat16", "shape": [n, h],
           "plan": plan._asdict(), "errors": errs,
           "tolerance": {"max_rel_err": STEP_TOL},
           "repeat_bit_equal": repeat_equal,
           "fwd_ms": time_ms(fwd), "bwd_ms": time_ms(bwd),
           "fwd_plain_ms": time_ms(
               lambda: lc.lstm_step_fwd_plain(xg, h_in, wh, b, cp)),
           "bwd_plain_ms": time_ms(
               lambda: lc.lstm_step_bwd_plain(dy, dh_rec, dc, z, cp, wh)),
           "fwd_library_ms": time_ms(
               lambda: torch.ops.aten._thnn_fused_lstm_cell(
                   xg, torch.matmul(h_in, wh.t()), cp, b, bz)),
           "bwd_library_ms": time_ms(
               lambda: torch.matmul(
                   torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
                       dh_lib, dc_lib, cp, cy, ws, True)[0], wh)),
           "library": "torch.matmul with torch.ops.aten."
                      "_thnn_fused_lstm_cell, and "
                      "_thnn_fused_lstm_cell_backward_impl with "
                      "torch.matmul (timed only)",
           "stage_ms": time_ms(lambda: lc.stage_recurrent_weight(wh)),
           "fwd_bound_ms": fb_ms, "bwd_bound_ms": bb_ms,
           "bound_by": [fb_by, bb_by],
           "bytes": {"fwd": fwd_bytes, "bwd": bwd_bytes},
           "flops": flops}
    emit(row)
    for name, e in errs.items():
        check(e["max_rel_err"] <= STEP_TOL, f"lstm_step {name}: max_rel_err "
              f"{e['max_rel_err']} > {STEP_TOL}")
    check(repeat_equal, "lstm_step_bwd: a repeated call differs")
    return row


def lstm_step_sweep(mt, torch, gen):
    """The forward's tiles and the backward's cluster sizes at
    ``L1_SHAPE``: ms (events) and how many clusters the card holds at
    once; each result within ``STEP_TOL`` of the plain version."""
    from mxnet_tpu_torch.ops import lstm_cell as lc
    n, h = L1_SHAPE
    dt = torch.bfloat16
    dev = torch.device(S13_DEVICE)
    xg, b, cp, hprev, wh, dy, dh_rec, dc = lstm_step_inputs(torch, gen)
    w = lc.stage_recurrent_weight(wh)
    hbuf = torch.zeros((2, n, 16 * -(-h // 16)), device=dev, dtype=dt)
    hbuf[0, :, :h] = hprev
    hout, cout, z = (torch.empty_like(cp), torch.empty_like(cp),
                     torch.empty_like(xg))
    dz = torch.empty_like(xg)
    dcp = torch.empty(cp.shape, device=dev)
    dhp = torch.empty_like(dcp)
    want_f = lc.lstm_step_fwd_plain(xg, hbuf[0, :, :h], wh, b, cp)
    rows = []
    for tile in lc._FWD_TILES:
        plan = lc._l1_plan(dt, n, h, dev, fwd_tile=tile)

        def fwd():
            lc.lstm_step_fwd(xg, hbuf[0, :, :h], w, b, cp, hout, cout, z,
                             hbuf[1, :, :h], plan)

        fwd()
        torch.cuda.synchronize()
        err = max(e["max_rel_err"] for e in step_errors(
            (hout, cout, z), want_f, "hcz").values())
        rows.append({"fwd_tile": list(tile), "grid": list(plan.fwd_grid),
                     "smem": plan.fwd_smem, "ms": time_ms(fwd),
                     "max_rel_err": err})
        check(err <= STEP_TOL, f"lstm_step_fwd tile {tile}: {err}")
    want_b = lc.lstm_step_bwd_plain(dy, dh_rec, dc, z, cp, wh)
    lib = lc._lstm_lib()
    for slices in lc._BWD_SLICE_CHOICES:
        plan = lc._l1_plan(dt, n, h, dev, bwd_slices=slices)

        def bwd():
            lc.lstm_step_bwd(dy, dh_rec, dc, z, cp, w, dz, dcp, dhp, plan)

        bwd()
        torch.cuda.synchronize()
        err = max(e["max_rel_err"] for e in step_errors(
            (dz, dcp, dhp), want_b, ("dz", "dc_prev", "dh_prev")).values())
        rows.append({"bwd_slices": slices, "stages": plan.bwd_stages,
                     "smem": plan.bwd_smem, "grid": list(plan.bwd_grid),
                     "max_active_clusters": lib.mxtt_lstm_bwd_max_clusters(
                         slices, plan.bwd_smem),
                     "ms": time_ms(bwd), "max_rel_err": err})
        check(err <= STEP_TOL, f"lstm_step_bwd slices {slices}: {err}")
    emit({"phase": "lstm_step_sweep", "rows": rows,
          "chosen": {"fwd_tile": list(lc.L1_FWD_TILE),
                     "bwd_slices": lc.L1_BWD_SLICES}})
    return rows


def plain_lstm_cell(xg, hg, b, c):
    """The LSTM cell in plain differentiable PyTorch (the reference's
    jnp, ``_lstm_cell_step``), in the tensors' dtype."""
    import torch
    i, f, g, o = (xg + hg + b).chunk(4, dim=-1)
    i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), \
        torch.tanh(g)
    c = f * c + i * g
    return o * torch.tanh(c), c


def rnn_inputs(mt, torch, gen, dtype):
    t, n, c, layers = RNN_SHAPE
    size = mt.ops.nn.rnn_param_size("lstm", layers, c, c)
    dt = getattr(torch, dtype)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, device=S13_DEVICE, generator=gen)
                * scale).to(dt)

    k = c ** -0.5
    params = ((torch.rand(size, device=S13_DEVICE, generator=gen) * 2 - 1)
              * k).to(dt)
    return (r(t, n, c), params, r(layers, n, c, scale=0.1),
            r(layers, n, c, scale=0.1)), r(t, n, c)


def rnn_fwd_bwd(torch, fn, ins, gy):
    """Output and input gradients of ``fn(*ins)`` for the output
    cotangent ``gy``."""
    leaves = [x.detach().requires_grad_() for x in ins]
    out = fn(*leaves)
    out.backward(gy)
    return out.detach(), [x.grad for x in leaves]


def cudnn_lstm(mt, torch, dtype, params):
    """``torch.nn.LSTM`` (cuDNN) holding the flat vector's weights."""
    t, n, c, layers = RNN_SHAPE
    m = torch.nn.LSTM(c, c, layers, device=S13_DEVICE,
                      dtype=getattr(torch, dtype))
    with torch.no_grad():
        for li, (wx, wh, bx, bh) in enumerate(mt.ops.nn.rnn_unpack_params(
                params, "lstm", layers, c, c)):
            for nm, v in (("weight_ih", wx), ("weight_hh", wh),
                          ("bias_ih", bx), ("bias_hh", bh)):
                getattr(m, f"{nm}_l{li}").copy_(v)
    m.flatten_parameters()
    return m


def cudnn_flat_grad(torch, m, layers):
    """cuDNN's weight gradients in the flat vector's layout."""
    w = [getattr(m, f"{nm}_l{li}").grad.reshape(-1) for li in range(layers)
         for nm in ("weight_ih", "weight_hh")]
    b = [getattr(m, f"{nm}_l{li}").grad for li in range(layers)
         for nm in ("bias_ih", "bias_hh")]
    return torch.cat(w + b)


def graph_ms(torch, fn):
    """Device ms of ``fn()`` captured as one CUDA graph (warmed on a
    side stream first): its replays timed by ``time_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    ms = time_ms(g.replay, reps=3, inner=5, warmup=1)
    del g
    return ms


def rnn_op_case(mt, torch, gen, dtype):
    """The RNN op (lstm: the fused step in bf16, L1 and a matmul a step
    in fp32) forward + backward at ``RNN_SHAPE`` against the plain path
    (the same op stepping the cell in plain PyTorch beside a matmul a
    step) and cuDNN; times by events."""
    from mxnet_tpu_torch import profile_training as pt
    from mxnet_tpu_torch.ops import lstm_cell as lc
    fb = mt.ops.fused_bn_conv
    t, n, c, layers = RNN_SHAPE
    ins, gy = rnn_inputs(mt, torch, gen, dtype)

    def port(d, p, h0, c0):
        return mt.ops.nn.rnn(d, p, h0, c0, state_size=c, num_layers=layers,
                             mode="lstm")

    real, real_plan = lc.lstm_cell, lc._l1_plan
    cell_loop = real_plan(torch.float32, n, c, torch.device(S13_DEVICE))

    def plain(*a):
        lc.lstm_cell = plain_lstm_cell
        lc._l1_plan = lambda *args, **kw: cell_loop
        try:
            return port(*a)
        finally:
            lc.lstm_cell, lc._l1_plan = real, real_plan

    def counts():
        return {"lstm_cell": lc.lstm_cell_fwd.launches
                + lc.lstm_cell_bwd.launches,
                "lstm_step_fwd": lc.lstm_step_fwd.launches,
                "lstm_step_bwd": lc.lstm_step_bwd.launches}

    fb.reset_launch_counts()
    got = rnn_fwd_bwd(torch, port, ins, gy)
    torch.cuda.synchronize()
    launched = counts()
    fb.reset_launch_counts()
    ref = rnn_fwd_bwd(torch, plain, ins, gy)
    torch.cuda.synchronize()
    plain_launched = counts()
    m = cudnn_lstm(mt, torch, dtype, ins[1])
    d_leaf = ins[0].detach().requires_grad_()
    lib_out, _ = m(d_leaf, (ins[2], ins[3]))
    lib_out.backward(gy)
    lib = (lib_out.detach(), [d_leaf.grad,
                              cudnn_flat_grad(torch, m, layers)])
    names = ("data", "parameters", "state", "state_cell")
    err = {"vs_plain": {"out": rel_l2(got[0], ref[0]), **{
        f"d_{nm}": rel_l2(g, w) for nm, g, w in zip(names, got[1], ref[1])}},
        "vs_cudnn": {"out": rel_l2(got[0], lib[0]),
                     "d_data": rel_l2(got[1][0], lib[1][0]),
                     "d_parameters": rel_l2(got[1][1], lib[1][1])}}

    def cudnn_call():
        # timed eagerly only: cuDNN's RNN backward does not capture (it
        # makes the legacy stream wait on the capturing one)
        x = ins[0].detach().requires_grad_()
        out, _ = m(x, (ins[2], ins[3]))
        return torch.autograd.grad(out, [x] + list(m.parameters()), gy)

    t0 = time.perf_counter()
    rnn_fwd_bwd(torch, port, ins, gy)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    row = {"phase": "rnn_op", "dtype": dtype, "T": t, "N": n, "C": c,
           "H": c, "layers": layers, "mode": "lstm",
           "rel_l2_err": err, "tolerance": RNN_TOL[dtype],
           "route": real_plan(getattr(torch, dtype), n, c,
                              torch.device(S13_DEVICE)).route,
           "launches": launched, "plain_launches": plain_launched,
           "ms": time_ms(lambda: rnn_fwd_bwd(torch, port, ins, gy),
                         reps=3, inner=2, warmup=1),
           "plain_ms": time_ms(lambda: rnn_fwd_bwd(torch, plain, ins, gy),
                               reps=3, inner=2, warmup=1),
           "cudnn_ms": time_ms(cudnn_call, reps=3, inner=2, warmup=1),
           "captured_ms": graph_ms(
               torch, lambda: rnn_fwd_bwd(torch, port, ins, gy)),
           "captured_plain_ms": graph_ms(
               torch, lambda: rnn_fwd_bwd(torch, plain, ins, gy)),
           "library_kernels": [k for k, _ in pt.busy_summary(
               pt.device_trace(lambda i: cudnn_call(), 1), 1)[
                   "top_kernels_ms_per_step"][:8]],
           "host_ms_one_call": host_ms,
           "timing": "forward + backward, CUDA events (median of 3 runs "
                     "of 2 calls); the port's and the plain path's "
                     "thousands of launches a call can outrun the spin, "
                     "so their ms may include host gaps"}
    emit(row)
    want = ({"lstm_cell": 0, "lstm_step_fwd": t * layers,
             "lstm_step_bwd": t * layers} if dtype == "bfloat16" else
            {"lstm_cell": 2 * t * layers, "lstm_step_fwd": 0,
             "lstm_step_bwd": 0})
    check(launched == want, f"rnn_op {dtype}: launches {launched}, "
          f"expected {want} (forward and backward a step)")
    check(not any(plain_launched.values()),
          f"the plain path launched {plain_launched}")
    for what, es in err.items():
        for nm, e in es.items():
            check(e <= RNN_TOL[dtype], f"rnn_op {dtype} {what} {nm}: "
                  f"rel L2 {e} > {RNN_TOL[dtype]}")
    return row


def lstm_step_state(torch, step):
    return [p.clone() for p in step._p] + \
        [x.clone() for s in step._s for x in s] + [step._t.clone()]


def lstm_trainstep_phase(mt, torch, np, smi):
    """bench_lstm.py's configuration through the port's TrainStep:
    eager against captured, a replay bit for bit against an eager step
    from the same state, the fused step's launches a step (and no
    pointwise L1), ms, tokens/s, memory, busy share and top kernels."""
    from mxnet_tpu_torch import profile_training as pt
    from mxnet_tpu_torch.examples.word_language_model import bench_lstm
    from mxnet_tpu_torch.ops import lstm_cell as lc
    fb = mt.ops.fused_bn_conv
    t, n = RNN_SHAPE[0], RNN_SHAPE[1]
    _, step = bench_lstm.build(S13_DEVICE, seed=SEED)
    xs, ys = bench_lstm.batches(n, t, seed=SEED)
    ctx = mt.context.as_context(S13_DEVICE)
    xs = [x.as_in_context(ctx) for x in xs]
    ys = [y.as_in_context(ctx) for y in ys]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(xs[0], ys[0]).asnumpy())]       # eager (warm)
    warm_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    losses.append(float(step(xs[1], ys[1]).asnumpy()))   # the capture
    pool_gb = (torch.cuda.memory_reserved() - reserved0) / 1e9
    prog = next(iter(step._programs.values()), None)
    check(prog is not None and prog.captured
          and prog.record.captures == 1,
          "TrainStep did not capture its step once")
    # a replay against an eager step from the same state, bit for bit
    snap = step.snapshot()
    replay_loss = step(xs[2], ys[2]).data.clone()
    after_replay = lstm_step_state(torch, step)
    step.restore(snap)
    eager_loss = step.step_eager(xs[2], ys[2]).data.clone()
    after_eager = lstm_step_state(torch, step)
    torch.cuda.synchronize()
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(after_replay, after_eager)]
    bit_equal = all(torch.equal(a, b) for a, b in
                    zip(after_replay + [replay_loss],
                        after_eager + [eager_loss]))
    fb.reset_launch_counts()
    runs, n_steps = [], 0
    for i, mode in enumerate(LSTM_STEP_RUNS):
        fn = step.step_eager if mode == "eager" else step
        r = timed_runs(torch, lambda j: fn(xs[j % 4], ys[j % 4]),
                       LSTM_STEP_N)
        runs.append(dict(r, mode=mode))
        n_steps += LSTM_STEP_N
    torch.cuda.synchronize()
    launches = {"lstm_step_fwd": lc.lstm_step_fwd.launches,
                "lstm_step_bwd": lc.lstm_step_bwd.launches,
                "lstm_cell": lc.lstm_cell_fwd.launches
                + lc.lstm_cell_bwd.launches}
    trace = pt.busy_summary(pt.device_trace(
        lambda j: step(xs[j % 4], ys[j % 4]), LSTM_TRACE_STEPS),
        LSTM_TRACE_STEPS)
    losses.append(float(step(xs[3], ys[3]).asnumpy()))
    host = ab_summary(runs, "host_ms")
    row = {"phase": "lstm_trainstep", "config": {
        "vocab": bench_lstm.VOCAB, "emsize": bench_lstm.EMSIZE,
        "nhid": bench_lstm.NHID, "nlayers": bench_lstm.NLAYERS,
        "batch": n, "bptt": t, "optimizer": "sgd momentum 0.9, lr 0.1",
        "compute_dtype": "bfloat16 over fp32 masters"},
        "host_ms_per_step": host,
        "event_ms_per_step": ab_summary(runs, "event_ms"),
        "tokens_per_s": {m: n * t / (host[m]["median"] / 1e3)
                         for m in ("eager", "captured")},
        "replay_vs_eager": {"bit_equal": bit_equal,
                            "max_abs_diff": max(diffs)},
        "launches": launches, "steps": n_steps,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "memory": {"warm_step_peak_gb": warm_peak,
                   "max_memory_allocated_gb": max(
                       r["max_memory_allocated_gb"] for r in runs),
                   "captured_graph_pool_reserved_gb": pool_gb},
        "busy": {k: trace[k] for k in ("device_busy_share",
                                       "device_kernel_ms_per_step",
                                       "traced_wall_ms")},
        "l1_ms_per_step": {k: v for k, v in trace[
            "port_kernels_ms_per_step"].items() if k.startswith("L1")},
        "top_kernels": trace["top_kernels_ms_per_step"][:10],
        "program": prog.record.as_dict() if prog is not None else None,
        "losses": losses, "card": smi}
    emit(row)
    check(bit_equal, f"a TrainStep replay differs from the eager step "
                     f"from the same state: max diff {max(diffs)}")
    per = t * RNN_SHAPE[3] * n_steps
    check(launches == {"lstm_step_fwd": per, "lstm_step_bwd": per,
                       "lstm_cell": 0},
          f"launches {launches} in {n_steps} steps, expected "
          f"{t * RNN_SHAPE[3]} fused forward and backward steps a step "
          "and no pointwise L1")
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    del step, xs, ys
    return row


def word_lm_phase(mt, torch, smi):
    """train.py's eager Gluon loop at its defaults for one epoch: the
    validation perplexity against the JAX package's CPU figure, tokens/s,
    L1 launches."""
    from mxnet_tpu_torch.examples.word_language_model import train
    from mxnet_tpu_torch.ops import lstm_cell as lc
    mt.random.seed(SEED)
    mt.ops.fused_bn_conv.reset_launch_counts()
    t0 = time.perf_counter()
    stats = train.main(["--epochs", "1", "--device", S13_DEVICE])
    secs = time.perf_counter() - t0
    launches = lc.lstm_cell_fwd.launches + lc.lstm_cell_bwd.launches
    val = stats["val_ppl"][0]
    rel = abs(val - WLM_JAX_VAL_PPL) / WLM_JAX_VAL_PPL
    row = {"phase": "word_lm", "config": "train.py defaults: synthetic "
           "vocab 500, emsize 200, 2 x 200 LSTM, batch 32, bptt 35, "
           "dropout 0.2, SGD lr 1.0, clip 0.2, one epoch",
           "val_ppl": val, "jax_cpu_val_ppl": WLM_JAX_VAL_PPL,
           "rel_diff": rel, "margin": WLM_PPL_MARGIN,
           "tokens_per_s": stats["tokens_per_s"][0],
           "train_s": stats["train_s"][0], "batches": stats["batches"][0],
           "l1_launches": launches, "seconds": secs, "card": smi}
    emit(row)
    check(rel <= WLM_PPL_MARGIN, f"word_lm val ppl {val} against the JAX "
          f"package's {WLM_JAX_VAL_PPL}: {rel} > {WLM_PPL_MARGIN}")
    return row


def bucketing_phase(mt, torch, np, smi):
    """The lstm_bucketing example's defaults for 2 epochs through
    BucketingModule.fit: Train-perplexity, one capture per bucket
    program, ms a step per bucket."""
    import logging
    import random
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing as lb
    from mxnet_tpu_torch.ops import lstm_cell as lc

    class Capture(logging.Handler):
        def __init__(self):
            super().__init__()
            self.ppl = []

        def emit(self, record):
            msg = record.getMessage()
            if "Train-perplexity" in msg:
                self.ppl.append(float(msg.split("=")[-1]))

    times, last = {}, [None]

    def on_batch(p):
        torch.cuda.synchronize()
        now = time.perf_counter()
        key = p.locals["data_batch"].bucket_key
        if last[0] is not None and p.epoch == 1:
            times.setdefault(key, []).append((now - last[0]) * 1e3)
        last[0] = now

    cap = Capture()
    root = logging.getLogger()
    level = root.level
    root.addHandler(cap)
    root.setLevel(logging.INFO)
    mt.random.seed(SEED)
    np.random.seed(SEED)
    random.seed(SEED)
    mt.compile_report(reset=True)
    mt.ops.fused_bn_conv.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        mod = lb.main(["--num-epochs", "2", "--device", S13_DEVICE],
                      batch_end_callback=on_batch)
    finally:
        root.removeHandler(cap)
        root.setLevel(level)
    secs = time.perf_counter() - t0
    launches = lc.lstm_cell_fwd.launches + lc.lstm_cell_bwd.launches
    report = mt.compile_report()
    progs = [p for p in report["programs"]
             if p["kind"].startswith("executor")]
    row = {"phase": "lstm_bucketing", "config": "lstm_bucketing.py "
           "defaults: buckets 10, 20, 30, 40, batch 32, embed 128, 2 x 128 "
           "LSTM (FusedRNNCell), Adam 0.01, 2 epochs",
           "train_perplexity": cap.ppl, "bar": BUCKET_PPL_BAR,
           "buckets": sorted(mod._buckets),
           "ms_per_step_epoch2": {str(k): {"median": statistics.median(v),
                                           "steps": len(v)}
                                  for k, v in sorted(times.items())},
           "programs": [{k: p[k] for k in ("name", "captures", "replays")}
                        for p in progs],
           "l1_launches": launches, "seconds": secs, "card": smi}
    emit(row)
    check(cap.ppl and cap.ppl[-1] < BUCKET_PPL_BAR
          and cap.ppl[-1] <= cap.ppl[0],
          f"lstm_bucketing Train-perplexity {cap.ppl}")
    check(progs and all(p["captures"] == 1 and p["replays"] >= 1
                        for p in progs),
          f"every bucket program must be captured once and replayed: "
          f"{row['programs']}")
    check(len(progs) >= len(mod._buckets),
          f"{len(progs)} programs for {len(mod._buckets)} buckets")
    check(launches > 0, "the bucketing fit launched no L1")
    return row


def slice13_phases(mt, torch, np, smi, gen):
    """lstm_cell, lstm_step and its sweep (slice 14), rnn_op,
    lstm_trainstep, word_lm, lstm_bucketing (slice 13). Returns the
    kernels line's lstm_cell, lstm_step_fwd and lstm_step_bwd entries."""
    seconds, t0 = {}, [time.perf_counter()]

    def lap(name):
        seconds[name] = time.perf_counter() - t0[0]
        t0[0] = time.perf_counter()

    l1 = {dt: l1_case(mt, torch, gen, dt) for dt in ("bfloat16", "float32")}
    lap("lstm_cell")
    st = lstm_step_case(mt, torch, gen)
    lstm_step_sweep(mt, torch, gen)
    lap("lstm_step")
    ops = {dt: rnn_op_case(mt, torch, gen, dt)
           for dt in ("bfloat16", "float32")}
    lap("rnn_op")
    gc.collect()
    torch.cuda.empty_cache()
    ts = lstm_trainstep_phase(mt, torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lap("lstm_trainstep")
    wlm = word_lm_phase(mt, torch, smi)
    lap("word_lm")
    bk = bucketing_phase(mt, torch, np, smi)
    lap("lstm_bucketing")
    emit({"phase": "slice13_seconds", "seconds": seconds,
          "total": sum(seconds.values())})
    bf, fp = l1["bfloat16"], l1["float32"]
    fused_src = "mxnet_tpu_torch/kernels/csrc/lstm_step.cu"
    replaces = ("mxnet_tpu/ops/nn.py:486-495 (_lstm_cell_step, jnp in "
                "lax.scan by _run_layer :518; no pallas_call)")

    def step_entry(name, way):
        errs = [e["max_abs_err"] for k, e in st["errors"].items()
                if (k in ("h", "c", "z", "h_next")) == (way == "fwd")]
        return {
            "name": name, "route": "cuda", "source": fused_src,
            "replaces": replaces + ", with the recurrent product",
            "launches": ts["launches"][name],
            "launches_per_step": ts["launches_per_step"][name],
            "max_abs_err": max(errs), "ms": st[f"{way}_ms"],
            "plain_ms": st[f"{way}_plain_ms"],
            "bound_ms": st[f"{way}_bound_ms"],
            "bound_by": st["bound_by"][0 if way == "fwd" else 1],
            "library_ms": st[f"{way}_library_ms"],
            "library": st["library"], "dtype": "bfloat16",
            "shape": list(L1_SHAPE), "plan": st["plan"],
            "per": "one step at (512, 650)",
            "path": "TrainStep at bench_lstm.py's configuration (counts "
                    "set to 0 just before its timed runs); rnn_op bf16 "
                    f"{ops['bfloat16']['launches'][name]} a call",
            "status": "ok"}

    return [{
        "name": "lstm_cell", "route": "triton",
        "source": "mxnet_tpu_torch/kernels/lstm_cell_triton.py",
        "replaces": replaces,
        "launches": wlm["l1_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in l1.values()),
        "ms": bf["ms"], "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"], "bound_by": "bytes",
        "library_ms": bf["library_ms"], "library": bf["library"],
        "fp32": {k: fp[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")},
        "cudnn_rnn_ms": {dt: r["cudnn_ms"] for dt, r in ops.items()},
        "rnn_op_ms": {dt: r["ms"] for dt, r in ops.items()},
        "rnn_op_plain_ms": {dt: r["plain_ms"] for dt, r in ops.items()},
        "rnn_op_captured_ms": {dt: {"port": r["captured_ms"],
                                    "plain": r["captured_plain_ms"]}
                               for dt, r in ops.items()},
        "dtype": "bfloat16", "shape": list(L1_SHAPE),
        "per": "one forward and one backward at (512, 650) (bf16: the "
               "fused step's yardstick; fp32: the route of fp32 layers)",
        "path": "train.py's eager Gluon loop in fp32 (word_lm, counts set "
                "to 0 just before it); rnn_op fp32 "
                f"{ops['float32']['launches']['lstm_cell']} a call; "
                "bf16 takes the fused step",
        "bucketing": {"launches": bk["l1_launches"]},
        "status": "ok"},
        step_entry("lstm_step_fwd", "fwd"),
        step_entry("lstm_step_bwd", "bwd")]


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


# ---------------------------------------------------------------------------
# The telemetry layer (slice 15): StepTimeline through fit and the captured
# step, trace spans, the event log, memory rows, the profiler
# ---------------------------------------------------------------------------
TELEM_STEPS = 20
TELEM_RUNS = ("off", "on", "on", "off", "off", "on", "on", "off")
TELEM_OVERHEAD_MAX = 0.02     # the JAX package's bar for tracing's cost
TELEM_PHASE_TOL = 0.10        # named phases against a run's step walls
TELEM_REQUESTS = 64
TELEM_DECODE_PROMPTS = (16, 24, 32, 40, 48, 20, 28, 36)
TELEM_DECODE_TOKENS = 16
SYNC_WARNING = "synchronizing CUDA operation"


def telemetry_fit(mt, torch, model, batches, metric, dirs=None,
                  callback=None):
    """One ``fit`` of ``TELEM_STEPS`` steps over the staged batches on
    ``model`` (its step already captured); with ``dirs`` = (event dir,
    trace dir) the event log (a ``train_step`` event every step) and
    tracing are on. Returns the run's ``step::`` registry snapshot and
    its ms a step on the card's clock: from an event recorded as ``fit``
    is called to one recorded in the last step's batch-end callback
    (the fit's own setup and its steps, host gaps included; not the
    epoch end nor the timeline's close). No sync is added."""
    from mxnet_tpu_torch import profile_training as pt
    it = mt.io.ResizeIter(four_batches(mt, batches), TELEM_STEPS)
    knobs = {"MXTPU_TELEMETRY_DIR": dirs[0] if dirs else None,
             "MXTPU_TRACE_DIR": dirs[1] if dirs else None,
             "MXTPU_TELEMETRY_EVENT_STEPS": 1 if dirs else None}
    ends = []

    def on_batch(param):
        if callback is not None:
            callback(param)
        if param.nbatch == TELEM_STEPS - 1:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()

    start = torch.cuda.Event(enable_timing=True)
    with contextlib.ExitStack() as stack:
        for k, v in knobs.items():
            stack.enter_context(mt.config.override(k, v))
        mt.telemetry.reset(prefix="step::")
        torch.cuda.synchronize()
        start.record()
        model.fit(it, eval_metric=metric, kvstore=None, optimizer="sgd",
                  optimizer_params=pt.SGD_PARAMS, num_epoch=1,
                  batch_end_callback=on_batch)
    torch.cuda.synchronize()
    return (mt.telemetry.snapshot(prefix="step::"),
            start.elapsed_time(ends[0]) / TELEM_STEPS)


def telemetry_trace_checks(mt, trace_dir):
    """The Chrome trace of one traced fit: the ``fit`` root, every
    ``step`` under it, ``device_step`` spans under the steps (and the
    fused step's inside fit's), the data pipeline's ``data:stage`` spans
    on the run's trace. Returns span counts by name."""
    files = mt.telemetry.trace.trace_files(trace_dir)
    check(files, "the traced fit exported no trace")
    spans = [e for e in mt.telemetry.trace.read_trace(files[-1])
             if e["ph"] == "X"]
    by_id = {e["args"]["span_id"]: e for e in spans
             if "span_id" in e["args"]}
    roots = [e for e in spans if e["cat"] == "train"]
    check(len(roots) == 1 and roots[0]["name"].startswith("fit:"),
          f"trace roots {[e['name'] for e in roots]}")
    root = roots[0]["args"]
    steps = [e for e in spans if e["name"] == "step"]
    check(len(steps) == TELEM_STEPS and all(
        e["args"]["parent_id"] == root["span_id"] for e in steps),
        f"{len(steps)} step spans under the fit root")
    dev = [e for e in spans if e["name"] == "device_step"]
    under_step = [e for e in dev
                  if by_id[e["args"]["parent_id"]]["name"] == "step"]
    inner = [e for e in dev
             if by_id[e["args"]["parent_id"]]["name"] == "device_step"]
    check(len(under_step) == TELEM_STEPS and len(inner) == TELEM_STEPS,
          f"device_step spans: {len(under_step)} under a step, "
          f"{len(inner)} inside fit's")
    stage = [e for e in spans if e["name"] == "data:stage"]
    check(stage and all(e["args"]["trace_id"] == root["trace_id"]
                        and e["args"]["parent_id"] == root["span_id"]
                        for e in stage), "data:stage spans on the run")
    counts = {}
    for e in spans:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def phase_split(steps):
    """Named phases over wall, and the unattributed share, of ``(run,
    train_step event)`` pairs: least, most, the lowest three steps."""
    ratios = sorted(((sum(e["phases"].values()) / e["wall_s"], i, e)
                     for i, e in steps), key=lambda t: t[0])
    unattr = [e["unattributed_s"] / e["wall_s"] for _, e in steps]
    return {"min": ratios[0][0], "max": ratios[-1][0], "steps": len(steps),
            "under_bar": sum(r < 1 - TELEM_PHASE_TOL for r, _, _ in ratios),
            "unattributed_share": {"median": statistics.median(unattr),
                                   "max": max(unattr)},
            "lowest": [{"ratio": r, "run": i, "step": e["step"],
                        "wall_s": e["wall_s"],
                        "unattributed_s": e["unattributed_s"],
                        "phases": e["phases"]} for r, i, e in ratios[:3]]}


def telemetry_fit_phase(mt, torch, smi, model, batches, metric):
    """``telemetry_fit`` / ``telemetry_syncs``: the fits on and off in
    turns, the per-step checks, the event log, the trace, the syncs."""
    import warnings
    progs = [p for p in model._fused._programs.values() if p.captured]
    prog = progs[-1]
    dev_ms = time_ms(prog.replay, reps=5, inner=5, warmup=1)
    captures0, replays0 = prog.record.captures, prog.record.replays
    runs = {"on": [], "off": []}
    kinds, spans, steps, run_ratios = None, None, [], []
    for i, mode in enumerate(TELEM_RUNS):
        dirs = (tempfile.mkdtemp(), tempfile.mkdtemp()) \
            if mode == "on" else None
        try:
            snap, fit_ms = telemetry_fit(mt, torch, model, batches,
                                         metric, dirs)
            check(snap["step::steps"]["value"] == TELEM_STEPS,
                  f"{mode}: {snap['step::steps']}")
            wall = snap["step::wall_s"]
            runs[mode].append({"fit_ms_per_step": fit_ms,
                               "host_median_ms": wall["p50"] * 1e3,
                               "host_min_ms": wall["min"] * 1e3,
                               "host_max_ms": wall["max"] * 1e3})
            if dirs:
                events, torn = mt.telemetry.read_events(dirs[0])
                check(torn == 0, "torn event lines")
                ts = [e for e in events if e["kind"] == "train_step"]
                check(len(ts) == TELEM_STEPS, f"{len(ts)} train_step events")
                steps.extend((i, e) for e in ts)
                run_ratios.append(
                    sum(sum(e["phases"].values()) for e in ts)
                    / sum(e["wall_s"] for e in ts))
                if kinds is None:
                    kinds = sorted({e["kind"] for e in events})
                    spans = telemetry_trace_checks(mt, dirs[1])
        finally:
            mt.telemetry.export.reset_exporter()   # closes the event log
            for d in dirs or ():
                shutil.rmtree(d, ignore_errors=True)
    check({"train_step", "epoch", "timeline_close"} <= set(kinds),
          f"event kinds {kinds}")
    # one graph both ways: telemetry on or off captures nothing new
    check(prog.record.captures == captures0 and
          prog.record.replays - replays0 == len(TELEM_RUNS) * TELEM_STEPS,
          f"captures {captures0} -> {prog.record.captures}, replays "
          f"{prog.record.replays - replays0} over the runs")
    replays_in_runs = prog.record.replays - replays0
    # the named phases against the step walls of each traced run (the
    # JAX package's bar, tests/test_telemetry.py:306, over its fit's
    # sums); each step is checked for double counting and printed: a
    # host stall between two phases is no phase's time, and on a
    # host-paced step of 1-2 ms one of a few hundred microseconds takes
    # that step alone under the bar (PERF.md section 6)
    split = phase_split(steps)
    check(min(run_ratios) >= 1 - TELEM_PHASE_TOL and
          split["max"] <= 1 + 1e-6,
          f"phase self-times over step wall: runs {run_ratios}, "
          f"steps {split}")

    def medians(key):
        return {m: statistics.median(r[key] for r in runs[m])
                for m in runs}

    med, host = medians("fit_ms_per_step"), medians("host_median_ms")
    overhead = med["on"] / med["off"] - 1
    emit({"phase": "telemetry_fit", "steps_per_run": TELEM_STEPS,
          "order": list(TELEM_RUNS), "runs": runs,
          "fit_ms_per_step": med,
          "fit_spread_ms": {m: [min(r["fit_ms_per_step"] for r in runs[m]),
                                max(r["fit_ms_per_step"] for r in runs[m])]
                            for m in runs},
          "overhead": overhead,
          "host_step_wall_ms": host,
          "host_overhead": host["on"] / host["off"] - 1,
          "program": {"captures": prog.record.captures,
                      "replays_in_runs": replays_in_runs},
          "replay_device_ms": dev_ms,
          "phases_over_wall": {"runs": run_ratios, "steps": split},
          "event_kinds": kinds, "trace_spans": spans,
          "clocks": "fit_ms_per_step: CUDA events, fit called -> the last "
                    "step's batch-end callback, over the steps; "
                    "host_step_wall_ms: the StepTimeline's step::wall_s "
                    "(host clock; the host runs ahead of the card); "
                    "replay_device_ms: CUDA events over prog.replay()",
          "card": smi})
    check(overhead <= TELEM_OVERHEAD_MAX,
          f"telemetry and tracing cost {overhead:.2%} of the step")

    # synchronising calls a step, on and off
    counts = {}
    for mode in ("off", "on"):
        marks = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            dirs = (tempfile.mkdtemp(), tempfile.mkdtemp()) \
                if mode == "on" else None
            try:
                telemetry_fit(
                    mt, torch, model, batches, metric, dirs,
                    callback=lambda p: marks.append(sum(
                        SYNC_WARNING in str(w.message) for w in caught)))
                total = sum(SYNC_WARNING in str(w.message) for w in caught)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                mt.telemetry.export.reset_exporter()
                for d in dirs or ():
                    shutil.rmtree(d, ignore_errors=True)
        counts[mode] = {"per_step": [b - a for a, b in
                                     zip([0] + marks, marks)],
                        "whole_fit": total}
    emit({"phase": "telemetry_syncs", "counts": counts,
          "counted": "warnings of torch.cuda.set_sync_debug_mode('warn'); "
                     "a step's window ends at its batch-end callback; "
                     "whole_fit adds the epoch end and the timeline's "
                     "close", "card": smi})
    check(len(counts["on"]["per_step"]) == TELEM_STEPS
          and counts["on"]["per_step"] == counts["off"]["per_step"],
          f"synchronising calls a step differ: {counts}")
    return prog, med


def telemetry_serving_phase(mt, torch, np, smi, pred):
    """``telemetry_serving``: phase 4's Predictor through a traced
    DynamicBatcher, 64 requests of 1-12 rows from 4 client threads."""
    tdir = tempfile.mkdtemp()
    rng = np.random.default_rng(SEED + 15)
    reqs = [rng.standard_normal((int(rng.integers(1, 13)), 3, 224, 224))
            .astype(np.float32) for _ in range(TELEM_REQUESTS)]
    futs = [None] * TELEM_REQUESTS
    try:
        with mt.config.override("MXTPU_TRACE_DIR", tdir):
            mt.telemetry.trace.reset()
            bat = mt.serving.DynamicBatcher(pred, max_wait_us=2000,
                                            name="telemetry")
            bat.start()
            try:
                def client(k):
                    for i in range(k, TELEM_REQUESTS, 4):
                        futs[i] = bat.submit(reqs[i])
                        futs[i].result(timeout=300)

                threads = [threading.Thread(target=client, args=(k,))
                           for k in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
            finally:
                bat.stop()             # exports the trace
        files = mt.telemetry.trace.trace_files(tdir)
        check(files, "the batcher exported no trace")
        spans = [e for e in mt.telemetry.trace.read_trace(files[-1])
                 if e["ph"] == "X"]
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    check(all(f is not None and f.done() for f in futs),
          "a request did not complete")
    by_id = {e["args"]["span_id"]: e for e in spans
             if "span_id" in e["args"]}
    reqspans = {e["args"]["trace_id"]: e for e in spans
                if e["name"] == "serving:request"}
    bucket_of = {}
    for e in spans:
        if e["name"].startswith("serving:bucket") and \
                "parent_id" in e["args"]:
            bucket_of[e["args"]["parent_id"]] = e
    held = 0
    for f in futs:
        r = reqspans.get(f.trace_id)
        b = by_id.get(r["args"].get("batch_span")) if r else None
        k = bucket_of.get(b["args"]["span_id"]) if b else None
        if b is None or k is None or f.trace_id not in \
                b["args"]["trace_ids"]:
            continue
        held += (r["ts"] - 5 <= b["ts"] and b["ts"] <= k["ts"] and
                 k["ts"] + k["dur"] <= b["ts"] + b["dur"] + 5 and
                 b["ts"] + b["dur"] <= r["ts"] + r["dur"] + 5)
    rows = {}
    for b in pred.buckets:
        mem = pred.program_memory(b)
        rows[b] = {k: mem.get(k) for k in ("pool_bytes", "argument_bytes",
                                           "output_bytes", "peak_bytes")}
    report = mt.memory_report()["programs"]
    named = {r["name"] for r in report}
    emit({"phase": "telemetry_serving", "requests": TELEM_REQUESTS,
          "requests_with_batch_and_bucket_spans": held,
          "batches": sum(e["name"] == "serving:batch" for e in spans),
          "bucket_spans": sum(e["name"].startswith("serving:bucket")
                              for e in spans),
          "memory_rows": rows, "card": smi})
    check(held == TELEM_REQUESTS,
          f"{held} of {TELEM_REQUESTS} request spans hold their batch and "
          "bucket spans")
    for b in pred.buckets:
        check(rows[b]["peak_bytes"] and
              f"predictor:{pred.symbol.name}:b{b}" in named,
              f"bucket {b} has no memory row")


def telemetry_decode_phase(mt, torch, np, smi):
    """``telemetry_decode``: a short traced decode run at GPT-2 small's
    widths (slots 4, bucket 64)."""
    dec = mt.serving.decode
    spec = gpt2_spec(mt, "gpt2tel")
    params = dec.init_params(spec, seed=SEED)
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, spec.vocab_size, size=n).astype(np.int32)
               for n in TELEM_DECODE_PROMPTS]
    tdir = tempfile.mkdtemp()
    try:
        with mt.config.override("MXTPU_TRACE_DIR", tdir):
            mt.telemetry.trace.reset()
            eng = dec.DecodePredictor(spec, params, slots=4,
                                      seq_buckets=(64,), name="gpt2tel",
                                      device="cuda:0")
            del params
            eng.warmup()
            with dec.DecodeBatcher(eng, max_wait_us=2000,
                                   name="gpt2tel") as bat:
                futs = [bat.submit(p, max_new_tokens=TELEM_DECODE_TOKENS)
                        for p in prompts]
                outs = [f.result(timeout=300) for f in futs]
        spans = [e for e in mt.telemetry.trace.read_trace(
            mt.telemetry.trace.trace_files(tdir)[-1]) if e["ph"] == "X"]
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    check(all(len(o) == TELEM_DECODE_TOKENS for o in outs),
          "a generation came back short")
    ids = {f.trace_id for f in futs}
    prefill = {e["args"]["trace_id"] for e in spans
               if e["name"] == "decode:prefill"}
    reqs = {e["args"]["trace_id"] for e in spans
            if e["name"] == "serving:request"}
    steps = sum(e["name"] == "decode:step" for e in spans)
    pid = eng.telemetry_id
    ttft = mt.telemetry.snapshot(prefix=f"serving::{pid}::ttft_ms")[
        f"serving::{pid}::ttft_ms"]
    row = [r for r in mt.memory_report()["programs"]
           if r["name"] == f"decode:{pid}:kv_cache"]
    emit({"phase": "telemetry_decode", "widths": GPT2_SMALL,
          "requests": len(prompts), "decode_step_spans": steps,
          "ttft_ms": {"count": ttft["count"], "p50": ttft["p50"],
                      "p99": ttft["p99"]},
          "decode_state_row": row[0] if row else None, "card": smi})
    check(prefill == ids and reqs == ids and
          steps >= TELEM_DECODE_TOKENS - 1, f"decode spans: {steps} steps")
    check(ttft["count"] == len(prompts), f"ttft count {ttft['count']}")
    check(row and row[0]["kind"] == "decode_state" and
          row[0]["peak_bytes"] == eng.kv_cache_bytes(),
          f"decode_state row {row}")


def telemetry_phases(mt, torch, np, smi, pred):
    """Every telemetry phase (slice 15)."""
    from mxnet_tpu_torch import profile_training as pt
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batches = pt.staged_batches(TRAIN_BATCH, 4, SEED)
    model = pt.build_module(TRAIN_BATCH, SEED)
    metric = mt.metric.create("acc")
    telemetry_fit(mt, torch, model, batches, metric)   # warm step, capture
    prog, med = telemetry_fit_phase(mt, torch, smi, model, batches, metric)

    # the fused step's memory row
    mem = dict(prog.memory)
    rows = [r for r in mt.memory_report()["programs"]
            if r["digest"] == prog.key.digest[:12]]
    peak_alloc = torch.cuda.max_memory_allocated()
    # what the row costs a capture: one pool reading (a walk of
    # memory_snapshot()) after it, and one before it where the pool is
    # shared (a predictor's buckets); host clock, beside the capture's
    reads = []
    for _ in range(5):
        r0 = time.perf_counter()
        mt.telemetry.memory.pool_reading(prog.graph.pool())
        reads.append((time.perf_counter() - r0) * 1e3)
    emit({"phase": "telemetry_memory", "program": prog.key.name,
          "row": mem, "max_memory_allocated": peak_alloc,
          "gauge_process_peak": mt.telemetry.gauge(
              "mem::process_peak_bytes").get(),
          "pool_reading_ms": statistics.median(reads),
          "pool_reading_ms_runs": reads,
          "allocator_segments": len(torch.cuda.memory_snapshot()),
          "capture_s": prog.record.capture_s,
          "clocks": "pool_reading_ms, capture_s: host clock", "card": smi})
    check(rows and rows[0]["pool_bytes"] == mem.get("pool_bytes"),
          "memory_report() has no row of the fused step")
    check(0 < mem["pool_bytes"] <= peak_alloc,
          f"pool bytes {mem.get('pool_bytes')} against "
          f"max_memory_allocated {peak_alloc}")

    # the profiler around 3 steps
    from mxnet_tpu_torch import profiler
    pdir = tempfile.mkdtemp()
    try:
        profiler.set_config(filename=os.path.join(pdir, "profile.json"))
        profiler.set_state("run")
        for i in range(3):
            pt.run_step(model, batches[i])
        torch.cuda.synchronize()
        profiler.dump()
        files = profiler.trace_files()
        check(len(files) == 1, f"profiler files {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(files[0])
    finally:
        shutil.rmtree(pdir, ignore_errors=True)
    kernels = [e.get("name", "") for e in events
               if e.get("cat") == "kernel"]
    named = {k: sum(any(sub in n for sub in pt.PORT_KERNELS[k])
                    for n in kernels) for k in ("K1", "K2", "B1", "B2")}
    emit({"phase": "telemetry_profiler", "steps": 3,
          "kernel_events": len(kernels), "port_kernel_events": named,
          "trace_bytes": size, "card": smi})
    check(all(v > 0 for v in named.values()),
          f"the profiler's trace lacks a kernel: {named}")
    del model, batches, prog
    gc.collect()
    torch.cuda.empty_cache()

    telemetry_serving_phase(mt, torch, np, smi, pred)
    telemetry_decode_phase(mt, torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "telemetry_seconds",
          "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# 19. the image-classification examples (slice 16): train_imagenet's
# --benchmark loop and fit path, train_mnist, benchmark_score over every
# network of get_network
# ---------------------------------------------------------------------------
IC_BENCH_STEPS = 30            # the example's own default
IC_FIT_BATCHES = 8             # learnable 3x224x224 sets: ~154 MB a batch
IC_VAL_BATCHES = 2             # of float64 on the host while drawn
IC_FIT_EPOCHS = 2
IC_AB_RUNS = ("on", "off", "off", "on")
IC_AB_STEPS = 10
IC_MNIST = (("mlp", [], 0.95),
            # the example's lr 0.05 and batch 64 leave LeNet at chance in
            # both packages (the JAX script reads 0.09 after 2 epochs on
            # the CPU); tests/test_train_conv.py trains it at lr 0.02,
            # batch 32
            ("lenet", ["--lr", "0.02", "--batch-size", "32"], 0.9))
IC_SCORE_NETWORKS = ("alexnet", "googlenet", "inception-bn", "mobilenet",
                     "vgg-16", "inception-v3", "resnext-50", "resnet-50",
                     "resnet-152")
IC_SCORE_BATCH = 32
IC_SCORE_STEPS = 10
IC_SCORE_TRACE = 5             # forwards in each network's device trace
# std-stem ResNet-50 training sites: 28 K1 (pallas_fusion) and 17 of the
# residual_fusion's K2 + convolution (the s2d stem of phase 7 has 16: its
# stem is not a Convolution); a step launches K2 at the 17 in the forward
# and again at all 45 in the backward, B1 and B2 at all 45
IC_TRAIN_PER_STEP = {"bn_relu_conv_nchw": 28, "bn_act_prologue": 62,
                     "bn_backward_reduce": 45, "bn_backward_dx": 45}
IC_EVAL_PER_FORWARD = {"bn_relu_conv_nchw": 28, "bn_act_prologue": 17,
                       "bn_backward_reduce": 0, "bn_backward_dx": 0}


def ic_launches(fb):
    return {k: v for k, v in fb.launch_counts().items()
            if k in KERNEL_WRAPPERS.values()}


def ic_benchmark_phase(mt, torch, np, smi, phase7_ms):
    """19a: train_imagenet.py --benchmark 1 (ResNet-50, std stem, bf16,
    batch 128) through the example's own _benchmark."""
    from mxnet_tpu_torch.examples.image_classification import train_imagenet
    fb = mt.ops.fused_bn_conv
    argv = ["--benchmark", "1", "--network", "resnet", "--num-layers",
            "50", "--dtype", "bfloat16", "--batch-size", str(TRAIN_BATCH)]
    gc.collect()
    torch.cuda.empty_cache()
    totals0 = registry_totals(mt)
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    model = train_imagenet.main(argv)
    seconds = time.perf_counter() - t0
    launches = ic_launches(fb)
    routes = fb.route_counts()["bn_relu_conv_nchw"]
    registry = registry_delta(totals0, registry_totals(mt))
    res = model.benchmark_result
    steps = 3 + 3 * res["steps"]
    loss = float(model._fused.last_loss)
    sites = {e["pass"]: len(e["sites"]) for e in
             model.pass_report["passes"]}
    emit({"phase": "ic_benchmark", "argv": argv, "line": {
        k: res[k] for k in ("value", "step_time_s", "steps")},
        "device_ms_per_step": res["device_s"] / res["steps"] * 1e3,
        "host_ms_per_step": res["host_s"] / res["steps"] * 1e3,
        "img_per_s_device": TRAIN_BATCH * res["steps"] / res["device_s"],
        "phase7_captured_host_ms_per_step": phase7_ms,
        "steps_counted": steps, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "k1_routes": routes, "pass_sites": sites,
        "compile_report_delta": registry, "loss": loss,
        "seconds": seconds, "card": smi})
    check(model._fused is not None and np.isfinite(loss),
          f"benchmark step: fused {model._fused is not None}, loss {loss}")
    check(registry["fresh_compiles"] == 1 and registry["replays"]
          == steps - 1, f"the benchmark's {steps} steps must be one eager "
          f"step, one capture and replays: {registry}")
    check(launches == {k: v * steps for k, v in IC_TRAIN_PER_STEP.items()},
          f"benchmark launches {launches} over {steps} steps, expected "
          f"{IC_TRAIN_PER_STEP} a step")
    check(sum(routes[r] for r in WGMMA_ROUTES) == 28 * steps,
          f"benchmark K1 routes {routes}: every launch on the wgmma core")
    del model
    return {"launches": launches, "steps": steps,
            "path": "train_imagenet --benchmark 1 (bf16, batch 128)"}


def ic_one_step(mt, torch, net, w0, batch, fused):
    """One SGD step (lr 0.1, momentum 0.9, wd 1e-4) of a fresh Module
    from params ``w0``: (loss, updates w1 - w0, new aux). The eager
    Module's aux is read after its training forward: its backward walks
    its own training forward and folds the statistics again (the
    reference executor's semantics), the fused step folds them once."""
    from mxnet_tpu_torch import config
    off = contextlib.ExitStack()
    if not fused:
        off.enter_context(config.override("MXTPU_PALLAS_FUSION", "0"))
        off.enter_context(config.override("MXTPU_PASS_RESIDUAL_FUSION",
                                          "0"))
    with off:
        m = mt.mod.Module(net, context="cuda:0",
                          fused=None if fused else False)
        m.bind([("data", tuple(batch.data[0].shape))],
               [("softmax_label", tuple(batch.label[0].shape))])
        m.init_params(arg_params=w0[0], aux_params=w0[1])
        m.init_optimizer(kvstore="device", optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1,
                                           "momentum": 0.9, "wd": 1e-4})
    check((m._fused is not None) == fused, "one-step module regime")
    m.forward(batch, is_train=True)
    if not fused:
        aux_fwd = {n: v.clone() for n, v in m.get_params()[1].items()}
    m.backward()
    m.update()
    args, aux = m.get_params()
    if not fused:
        aux = aux_fwd
    out = m.get_outputs()[0].data.float()
    lab = batch.label[0].data.long()
    loss = -torch.log(out[torch.arange(out.shape[0]), lab]).sum()
    res = (loss, {n: (v - w0[0][n]).clone() for n, v in args.items()},
           {n: v.clone() for n, v in aux.items()})
    del m
    gc.collect()
    torch.cuda.empty_cache()
    return res


def ic_fit_phase(mt, torch, np, smi):
    """19b: common/fit.py's fit on the default path (--kv-store device,
    ResNet-50, fp32, batch 128) over learnable synthetic sets."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.examples.image_classification import train_imagenet
    from mxnet_tpu_torch.examples.image_classification.common import (
        data as icd, fit as icf)
    from mxnet_tpu_torch.examples.image_classification.symbols import resnet
    fb = mt.ops.fused_bn_conv
    shape = (TRAIN_BATCH, 3, 224, 224)
    sets = {}

    def loader(n_train, n_val, learnable=True):
        def load(args, kv):
            t0 = time.perf_counter()
            train = icd.SyntheticDataIter(1000, shape, num_batches=n_train,
                                          learnable=learnable, seed=0)
            val = icd.SyntheticDataIter(1000, shape, num_batches=n_val,
                                        learnable=learnable, seed=1)
            sets["draw_s"] = time.perf_counter() - t0
            sets["train"] = train
            return train, val
        return load

    tmp = tempfile.mkdtemp()
    prefix = os.path.join(tmp, "r50")
    argv = ["--kv-store", "device", "--batch-size", str(TRAIN_BATCH),
            "--num-epochs", str(IC_FIT_EPOCHS), "--lr-step-epochs", "1",
            "--num-examples", str(TRAIN_BATCH * IC_FIT_BATCHES),
            "--model-prefix", prefix, "--disp-batches", "4"]
    args = train_imagenet.parse_args(argv)
    net = resnet.get_symbol(1000, 50, "3,224,224")
    try:
        gc.collect()
        torch.cuda.empty_cache()
        fb.reset_launch_counts()
        totals0 = registry_totals(mt)
        t0 = time.perf_counter()
        model = icf.fit(args, net, loader(IC_FIT_BATCHES, IC_VAL_BATCHES))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ic_launches(fb)
        routes = fb.route_counts()["bn_relu_conv_nchw"]
        registry = registry_delta(totals0, registry_totals(mt))
        steps = model._fused.num_update
        evals = IC_VAL_BATCHES * IC_FIT_EPOCHS
        want = {k: IC_TRAIN_PER_STEP[k] * steps
                + IC_EVAL_PER_FORWARD[k] * evals for k in IC_TRAIN_PER_STEP}
        lr_now = float(model._fused._lr)
        keys = len(model._kvstore._data)
        saved = mt.model.load_checkpoint(prefix, 1)
        emit({"phase": "ic_fit", "argv": argv, "steps": steps,
              "eval_forwards": evals, "seconds": seconds,
              "data_draw_s": sets["draw_s"], "launches": launches,
              "expected_launches": want, "k1_routes": routes,
              "kvstore": {"type": model._kvstore.type, "keys": keys,
                          "params": len(model._param_names),
                          "update_on_kvstore": model._update_on_kvstore},
              "lr_after_step": {"scheduler": model._optimizer.lr_scheduler(
                  steps), "step_scalar": lr_now},
              "compile_report_delta": registry, "card": smi})
        check(model._fused is not None, "fit's Module left the fused step")
        check(keys == len(model._param_names) and
              not model._update_on_kvstore,
              f"the store holds {keys} keys for "
              f"{len(model._param_names)} params")
        check(launches == want, f"fit launches {launches}, expected {want}")
        check(routes["fp32"] == launches["bn_relu_conv_nchw"],
              f"fit's fp32 K1 launches took routes {routes}")
        check(abs(lr_now - 0.01) < 1e-9, f"lr after the step epoch {lr_now}")
        sets["train"].reset()
        train_batch = sets["train"].next()
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # resume from --load-epoch 1: what was saved, bit for bit
        args2 = train_imagenet.parse_args(
            argv + ["--load-epoch", "1", "--num-epochs", "1"])
        resumed = icf.fit(args2, net, loader(1, 1, learnable=False))
        r_args, r_aux = resumed.get_params()
        diff = [n for n, v in list(saved[1].items()) + list(saved[2].items())
                if not torch.equal((r_args.get(n) if n in r_args
                                    else r_aux[n]).cpu(), v.data.cpu())]
        w0 = ({n: v.clone() for n, v in r_args.items()},
              {n: v.clone() for n, v in r_aux.items()})
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "ic_fit_resume", "load_epoch": 1,
              "params": len(saved[1]) + len(saved[2]),
              "not_bit_identical": diff})
        check(not diff, f"resumed params differ from the saved: {diff}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the first step against Module(fused=False) with the passes off,
    # from the same params and batch
    ref = ic_one_step(mt, torch, net, w0, train_batch, fused=False)
    got = ic_one_step(mt, torch, net, w0, train_batch, fused=True)
    summ = grad_check_summary(*got, ref)
    fails = training_failures(summ, FP32_TRAIN_LIMITS)
    emit(dict({"phase": "ic_fit_first_step", "against": "Module(fused="
               "False) with both passes off, same params and batch; the "
               "updates w1 - w0 of one SGD step (momentum 0) in place of "
               "the gradients; its moving statistics after its training "
               "forward (its backward folds them a second time)",
               "limits": FP32_TRAIN_LIMITS,
               "failures": fails}, **summ))
    check(not fails, f"fit's first step against the eager step: {fails}")

    # the fp32 fused step with MXTPU_PALLAS_FUSION on and off, in turns
    from mxnet_tpu_torch import profile_training as pt
    batches = pt.staged_batches(TRAIN_BATCH, 4, SEED)
    mods = {}
    for flag in ("on", "off"):
        with config.override("MXTPU_PALLAS_FUSION",
                             "1" if flag == "on" else "0"):
            m = mt.mod.Module(net, context="cuda:0")
            m.bind([("data", shape)], [("softmax_label", (TRAIN_BATCH,))])
            m.init_params(arg_params=w0[0], aux_params=w0[1])
            m.init_optimizer(kvstore="device", optimizer="sgd",
                             optimizer_params={"learning_rate": 0.1,
                                               "momentum": 0.9, "wd": 1e-4})
        for i in range(3):
            pt.run_step(m, batches[i % 4])
        mods[flag] = m
    runs = []
    for flag in IC_AB_RUNS:
        fb.reset_launch_counts()
        r = timed_runs(torch, lambda i: pt.run_step(
            mods[flag], batches[i % 4]), IC_AB_STEPS)
        runs.append(dict(r, mode=flag, launches=ic_launches(fb)))
    sites = {f: {e["pass"]: len(e["sites"]) for e in
                 m.pass_report["passes"]} for f, m in mods.items()}
    emit({"phase": "ic_fit_fusion_ab", "dtype": "float32",
          "batch": TRAIN_BATCH, "order": list(IC_AB_RUNS),
          "steps_per_run": IC_AB_STEPS, "pass_sites": sites,
          "host_ms_per_step": ab_summary(runs, "host_ms", ("on", "off")),
          "event_ms_per_step": ab_summary(runs, "event_ms", ("on", "off")),
          "launches_per_step": {f: {k: v / IC_AB_STEPS for k, v in
                                    next(r["launches"] for r in runs
                                         if r["mode"] == f).items()}
                                for f in ("on", "off")},
          "card": smi})
    check(sites["on"]["pallas_fusion"] == 28
          and sites["off"].get("pallas_fusion", 0) == 0,
          f"fusion A/B pass sites {sites}")
    del mods, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps, "eval_forwards": evals,
            "path": "common/fit.py fit (--kv-store device, fp32, batch "
                    "128): train steps and eval forwards"}


def ic_mnist_phase(mt, torch, np, smi):
    """19c: train_mnist.py for mlp and lenet on the synthetic fallback."""
    from mxnet_tpu_torch.examples.image_classification import train_mnist
    from mxnet_tpu_torch.examples.image_classification.common import (
        data as icd)
    rows = {}
    for network, extra, bar in IC_MNIST:
        argv = ["--network", network] + extra
        t0 = time.perf_counter()
        model = train_mnist.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        args = train_mnist.parse_args(argv)
        with mt.gpu(0):
            _, val = icd.get_mnist_iter(args)
        acc = model.score(val, "acc")[0][1]
        steps = model._fused.num_update
        rows[network] = {"argv": argv, "val_accuracy": acc, "bar": bar,
                         "steps": steps, "seconds": seconds,
                         "steps_per_s": steps / seconds,
                         "fused": model._fused is not None}
        check(acc > bar, f"train_mnist {network}: validation accuracy "
                         f"{acc} <= {bar}")
        del model
    emit({"phase": "ic_mnist", "runs": rows,
          "clock": "steps_per_s: host clock over main(), evaluation and "
                   "set-up included", "card": smi})


def ic_score_phase(mt, torch, np, smi):
    """19d: benchmark_score.py over every network of get_network at
    batch 32 in bf16: img/s and ms a batch, K1 / K2 launches and routes
    a forward, the captured eval output against the fp32 plain graph."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch import profile_training as pt
    from mxnet_tpu_torch.examples.image_classification import (
        benchmark_score as bs)
    fb = mt.ops.fused_bn_conv
    rows = {}
    for net in IC_SCORE_NETWORKS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.manual_seed(SEED)
        t0 = time.perf_counter()
        mod, batches = bs.bind_scoring(net, IC_SCORE_BATCH, "bfloat16",
                                       "cuda:0")
        bind_s = time.perf_counter() - t0
        sites = {e["pass"]: len(e["sites"]) for e in
                 mod.pass_report["passes"]}
        fb.reset_launch_counts()
        routes0 = dict(fb.route_counts()["bn_relu_conv_nchw"])
        best = bs.time_scoring(mod, batches, IC_SCORE_STEPS)
        forwards = 2 + 3 * IC_SCORE_STEPS
        launches = ic_launches(fb)
        routes = {r: n - routes0.get(r, 0) for r, n in
                  fb.route_counts()["bn_relu_conv_nchw"].items()
                  if n - routes0.get(r, 0)}
        # device time a forward and the busy share (torch.profiler), as
        # the scoring loop runs them: is the loop host-paced?
        trace = pt.device_trace(lambda i: (
            mod.forward(batches[i % 4], is_train=False),
            mod.get_outputs()[0].sum()), IC_SCORE_TRACE)
        busy = pt.busy_summary(trace, IC_SCORE_TRACE, "forward")
        # the check's params: phase 4's seeded draw (Xavier's uniform
        # init leaves these outputs near-uniform, with no decisive row)
        args, aux = mt.interop.init_params(
            mod.symbol, {"data": tuple(batches[0].data[0].shape)}, SEED)
        mod.set_params(args, aux)
        outs = []
        for b in batches:
            mod.forward(b, is_train=False)
            outs.append(mod.get_outputs()[0].data.float().cpu().numpy())
        out_dtype = str(mod.get_outputs()[0].data.dtype)
        with config.override("MXTPU_PALLAS_FUSION", "0"), \
                config.override("MXTPU_PASS_RESIDUAL_FUSION", "0"):
            plain = mt.mod.Module(mod.symbol, context="cuda:0",
                                  label_names=("softmax_label",))
            plain.bind(data_shapes=[("data", tuple(
                batches[0].data[0].shape))], label_shapes=[(
                    "softmax_label", (IC_SCORE_BATCH,))],
                       for_training=False)
        plain.set_params(args, aux)
        # fp32 and bf16 batches in turns: run its programs eagerly rather
        # than capture one for each switch of the input's dtype
        plain._exec.captured = False
        ref, p16 = [], []
        for b in batches:
            x = b.data[0].data
            plain.forward(mt.io.DataBatch([mt.nd.NDArray(x.float())], []),
                          is_train=False)
            ref.append(plain.get_outputs()[0].data.float().cpu().numpy())
            plain.forward(mt.io.DataBatch([mt.nd.NDArray(x)], []),
                          is_train=False)
            p16.append(plain.get_outputs()[0].data.float().cpu().numpy())
        got, ref, p16 = (np.concatenate(v) for v in (outs, ref, p16))
        check(np.ptp(ref, axis=0).max() > 0, f"benchmark_score {net}: the "
              "fp32 plain graph's output does not depend on its input")
        cmp = compare_to_fp32(ref, got, p16)
        fails = []
        if cmp["decisive_rows"] >= 8 and \
                cmp["top1_agreement_decisive"] < 0.98:
            fails.append("top-1 on decisive rows")
        for k, lim in (("logit_rel_err", MAX_LOGIT_REL_ERR),
                       ("input_part_rel_err", MAX_INPUT_PART_REL_ERR)):
            bar = max(lim, 2 * cmp[k + "_plain_bf16"])
            if not cmp[k] <= bar:
                fails.append(f"{k} {cmp[k]} > {bar}")
        per_fwd = {"K1": launches["bn_relu_conv_nchw"] / forwards,
                   "K2": launches["bn_act_prologue"] / forwards}
        rows[net] = {"img_per_s": IC_SCORE_BATCH * IC_SCORE_STEPS / best,
                     "ms_per_batch": best / IC_SCORE_STEPS * 1e3,
                     "forwards_counted": forwards,
                     "device": {k: busy[k] for k in (
                         "device_kernel_ms_per_forward",
                         "device_busy_share", "traced_wall_ms")},
                     "top_kernels_ms_per_forward":
                         busy["top_kernels_ms_per_forward"][:5],
                     "launches_per_forward": per_fwd, "k1_routes": routes,
                     "pass_sites": sites, "output_dtype": out_dtype,
                     "bind_s": bind_s, "finite": bool(np.isfinite(got)
                                                      .all()),
                     "vs_fp32_plain": {k: cmp[k] for k in (
                         "decisive_rows", "top1_agreement_decisive",
                         "logit_rel_err", "logit_rel_err_plain_bf16",
                         "input_part_rel_err",
                         "input_part_rel_err_plain_bf16")},
                     "failures": fails}
        emit(dict({"phase": "ic_score", "network": net,
                   "batch": IC_SCORE_BATCH, "dtype": "bfloat16",
                   "card": smi}, **rows[net]))
        check(not fails and rows[net]["finite"],
              f"benchmark_score {net}: {fails}")
        check(per_fwd["K1"] == sites.get("pallas_fusion", 0)
              and per_fwd["K2"] == sites.get("residual_fusion", 0),
              f"benchmark_score {net}: launches a forward {per_fwd} "
              f"against the pass sites {sites}")
        del mod, plain, batches
    return rows


def ic_cifar_phase(mt, torch, np, smi):
    """19d': train_cifar10.py --benchmark 1 (ResNet-110 at 32x32, fp32,
    batch 128), one line."""
    from mxnet_tpu_torch.examples.image_classification import train_cifar10
    fb = mt.ops.fused_bn_conv
    fb.reset_launch_counts()
    model = train_cifar10.main(["--benchmark", "1"])
    res = model.benchmark_result
    steps = 3 + 3 * res["steps"]
    launches = ic_launches(fb)
    emit({"phase": "ic_cifar10_benchmark", "line": {
        k: res[k] for k in ("value", "step_time_s", "steps")},
        "device_ms_per_step": res["device_s"] / res["steps"] * 1e3,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "loss": float(model._fused.last_loss), "card": smi})
    check(np.isfinite(float(model._fused.last_loss)), "cifar10 loss")
    del model
    return {"launches": launches, "steps": steps}


def image_classification_phases(mt, torch, np, smi, phase7_ms=None):
    """Phase 19 (slice 16); returns each kernel's launches per path for
    the kernels line."""
    t0 = time.perf_counter()
    lap = {}
    paths = {}
    paths["benchmark"] = ic_benchmark_phase(mt, torch, np, smi, phase7_ms)
    lap["ic_benchmark"] = time.perf_counter() - t0
    paths["fit"] = ic_fit_phase(mt, torch, np, smi)
    lap["ic_fit"] = time.perf_counter() - t0 - sum(lap.values())
    ic_mnist_phase(mt, torch, np, smi)
    lap["ic_mnist"] = time.perf_counter() - t0 - sum(lap.values())
    scores = ic_score_phase(mt, torch, np, smi)
    lap["ic_score"] = time.perf_counter() - t0 - sum(lap.values())
    paths["cifar10_benchmark"] = ic_cifar_phase(mt, torch, np, smi)
    lap["ic_cifar10"] = time.perf_counter() - t0 - sum(lap.values())
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "slice16_seconds", "seconds": time.perf_counter() - t0,
          "per_phase": lap})
    out = {}
    for key, wrapper in KERNEL_WRAPPERS.items():
        entry = {name: {"launches": p["launches"][wrapper],
                        "per_step": p["launches"][wrapper] / p["steps"],
                        "steps": p["steps"], "path": p.get("path", name)}
                 for name, p in paths.items()}
        if key in ("K1", "K2"):
            entry["benchmark_score"] = {
                net: {"per_forward": r["launches_per_forward"][key],
                      "k1_routes": r["k1_routes"] if key == "K1" else None}
                for net, r in scores.items()}
        out[key] = entry
    return out


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
    gc.collect()
    torch.cuda.empty_cache()

    # 7e.-7i. the bound Executor, Module(fused=False), every rule in the
    # captured step, the captured eval forward, Monitor (slice 10) --------
    slice10 = slice10_phases(mt, torch, np, smi, batches)
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

    # 17c.-17f. the decode LM trained on the port, served, and its
    # training step at GPT-2 small's widths (slice 11) ---------------------
    d1_entry["lm_spec"] = slice11_phases(mt, torch, np, F, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 17g.-17j. row-sparse embedding training and fit's data pipeline
    # (slice 12) ------------------------------------------------------------
    dp_launches = slice12_phases(mt, torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 18a.-18e. the LSTM language models: L1, the RNN op, TrainStep at
    # bench_lstm.py's widths, train.py's loop, lstm_bucketing (slice 13)
    l1_entries = slice13_phases(mt, torch, np, smi, gen)

    # 18f. the telemetry layer (slice 15) --------------------------------------
    telemetry_phases(mt, torch, np, smi, pred)

    # 19a.-19d. the image-classification examples (slice 16) ------------------
    ic = image_classification_phases(
        mt, torch, np, smi, ab_row["host_ms_per_step"]["captured"]["median"])

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
            "data_pipeline": dp_launches[key],
            "dtype": "bfloat16", "batch": TRAIN_BATCH,
            "per": "one ResNet-50 training step at batch 128 (sum over "
                   "the step's calls)", "status": "ok",
            "fit": {"launches": fit_launches[launch_key],
                    "launches_per_step": fit_launches[launch_key]
                    / fit_steps, "steps": fit_steps,
                    "path": "Module.fit (bench.py phase A2), counts set "
                            "to 0 just before it"}}, **extra,
            **slice10[key])

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
                           "bn_gemm_wgmma.cuh",
                   "image_classification": ic["K1"]}),
        train_agg("K2", "bn_prologue",
                  "mxnet_tpu_torch/kernels/bn_prologue_triton.py",
                  f"{pf}:250 (_make_prologue_kernel; pallas_call :390)",
                  "triton", "bn_act_prologue",
                  {"serving": serving_agg("bn_prologue"),
                   "image_classification": ic["K2"]}),
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
                  {"library_covers": "B1 and B2 together",
                   "image_classification": ic["B1"]}),
        train_agg("B2", "bn_backward_dx",
                  "mxnet_tpu_torch/kernels/bn_backward_triton.py",
                  f"{pf}:529-537 (dx assembly of the fused BN backwards, "
                  "jnp there)", "triton", "bn_backward_dx",
                  {"image_classification": ic["B2"]}),
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
    ] + [d1_entry] + l1_entries, "card": smi,
        "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--stager-capture":
        sys.exit(stager_capture_main(sys.argv[2]))
    sys.exit(main())
