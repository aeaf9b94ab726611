"""Runtime knobs read from the environment (counterpart of
``mxnet_tpu/config.py``), limited to the knobs the ported slices read.
Names and defaults are the JAX package's; ``auto`` in a pass flag means
"on when the predictor's device is CUDA" here (the JAX package meant
TPU)."""
from __future__ import annotations

import contextlib
import os

__all__ = ["get", "override", "register"]

_REGISTRY = {}


def register(name, default, typ=str, doc=""):
    """Register a configuration variable."""
    _REGISTRY[name] = (default, typ, doc)
    return name


def get(name, default=None):
    """The variable's environment value, typed, else its registered (or
    the given) default."""
    reg_default, typ, _ = _REGISTRY.get(name, (None, str, ""))
    eff = default if default is not None else reg_default
    raw = os.environ.get(name)
    if raw is None:
        return eff
    if typ is bool:
        return raw.lower() not in ("0", "false", "off", "")
    return typ(raw)


@contextlib.contextmanager
def override(name, value):
    """Temporarily set a variable's environment value (None removes it)."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


register("MXTPU_PALLAS_FUSION", "auto", str,
         "Rewrite BN(+ReLU)->1x1-conv subgraphs onto the fused "
         "BN+ReLU+1x1-conv kernel: 1/0 force on/off, auto = on when the "
         "predictor's device is CUDA")
register("MXTPU_PASS_RESIDUAL_FUSION", "auto", str,
         "Rewrite BN(+ReLU)->conv chains of any geometry onto the "
         "BN-apply prologue kernel + conv: 1/0 force, auto = on for CUDA")
register("MXTPU_SERVING_BUCKETS", "1,8,64", str,
         "Default batch buckets for serving.Predictor")
register("MXTPU_SERVING_MAX_WAIT_US", 2000, int,
         "DynamicBatcher coalescing window in microseconds")
register("MXTPU_SERVING_MAX_QUEUE", 256, int,
         "DynamicBatcher admission bound in queued rows")
register("MXTPU_FT_GUARD", "auto", str,
         "Non-finite-step guard inside the fused train step: NaN/Inf "
         "gradients skip the update in the step itself (params, "
         "optimizer state, aux and metric counters kept, counter "
         "bumped). 1/auto = on, 0 = off")
register("MXTPU_FT_MAX_CONSEC_SKIPS", 0, int,
         "Abort training (MXNetError) once this many CONSECUTIVE steps "
         "were guard-skipped (checked laggedly, no per-step sync); "
         "0 disables the abort")
register("MXTPU_CKPT_KEEP", 3, int,
         "CheckpointManager retention: newest K valid checkpoints "
         "survive pruning (checkpoint.py)")
register("MXTPU_CKPT_ASYNC", False, bool,
         "CheckpointManager default: snapshot state synchronously but "
         "write checkpoint files on a background thread")
register("MXTPU_FAULT_INJECT", "", str,
         "Deterministic fault-injection spec, 'site:k=v[:k=v];site2:...' "
         "(faultinject.py) — e.g. 'ckpt_write:byte=100:action=kill', "
         "'nan_grad:step=3'. Empty = no faults. Test-only")
register("MXTPU_DECODE_SLOTS", 4, int,
         "Decode batch width (serving/decode): concurrent generation "
         "slots of the continuous-batching decode program; the KV-cache "
         "grows linearly with it")
register("MXTPU_DECODE_SEQ_BUCKETS", "16,64", str,
         "Prompt-length buckets of the decode prefill program: prompts "
         "pad to the nearest bucket (clipped to the model's max_seq, "
         "which is always a bucket)")
register("MXTPU_DECODE_KV_DTYPE", "float32", str,
         "KV-cache storage dtype for decode serving: float32 or int8 "
         "(int8 values with one f32 absmax scale per (slot, position, "
         "head), dequantized on load by the decode-attention kernel)")
register("MXTPU_DECODE_MAX_WAIT_US", 2000, int,
         "DecodeBatcher first-fill window: when no generation is in "
         "flight, how long the first queued prompt waits for company "
         "(joins mid-flight are immediate)")
register("MXTPU_DECODE_MAX_QUEUE", 256, int,
         "DecodeBatcher admission bound in queued REQUESTS; submits past "
         "it fail fast with serving.Overloaded")
register("MXTPU_SPEC_K", 4, int,
         "Speculation depth (serving/decode/spec.py): draft tokens "
         "proposed per lane per round; the target verifies k+1 fed "
         "tokens in one program. Verify width k+1 is compile-key material")
register("MXTPU_SPEC_DISABLE_BELOW", 0.125, float,
         "Acceptance-rate floor: below it (windowed) the speculative "
         "engine degrades to plain decode, and re-probes after "
         "MXTPU_SPEC_PROBE_STEPS rounds")
register("MXTPU_SPEC_PROBE_STEPS", 64, int,
         "Plain-decode rounds a degraded speculative engine serves before "
         "probing speculation again")
register("MXTPU_SPEC_WINDOW", 32, int,
         "Sliding window (rounds) of the speculative engine's acceptance "
         "rate, accepted-per-step figures and degrade decision")
register("MXTPU_SPARSE_STATS", "auto", str,
         "Per-step sparse id statistics (sparse_report): 1 = on (ids "
         "that live only on the card are read back, a sync), 0 = off, "
         "auto = on where the feed has a host copy of the ids, never "
         "reading a device tensor")
register("MXTPU_DATA_PIPELINE", "auto", str,
         "Async host data pipeline (data/pipeline.py) wrapped around "
         "fit()'s train iterator: worker threads, read-ahead and staging "
         "into the step's device (pinned host memory, a copy stream), a "
         "checkpointable cursor. 1/auto = on (on every device), 0 = off; "
         "the batch stream is byte-identical either way")
register("MXTPU_DATA_WORKERS", 2, int,
         "Decode/transform worker threads per DataPipeline")
register("MXTPU_DATA_QUEUE_DEPTH", 4, int,
         "Bounded depth (batches) of the pipeline's work/done queues: how "
         "far the source thread reads ahead of the workers")
register("MXTPU_DATA_STAGE_AHEAD", 2, int,
         "Staged batches already on the device ahead of the consumer "
         "(2 = double buffering: the next batch is on the card before "
         "the current step retires)")
register("MXNET_BACKWARD_DO_MIRROR", False, bool,
         "Recompute activations in backward (parallel.TrainStep's remat: "
         "torch.utils.checkpoint) to trade FLOPs for memory")
