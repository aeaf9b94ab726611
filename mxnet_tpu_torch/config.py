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
