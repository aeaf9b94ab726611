"""``mxnet_tpu_torch.symbol.passes`` — the graph-rewrite pass framework
(counterpart of ``mxnet_tpu/symbol/passes``).

Ported pipeline, each pass behind its JAX-package env flag (1/0 force,
``auto`` = on for a CUDA device):

1. ``pallas_fusion`` (``MXTPU_PALLAS_FUSION``) — BN(+ReLU)→1×1-conv onto
   the fused CUDA kernel (symbol/fusion.py's matcher).
2. ``residual_fusion`` (``MXTPU_PASS_RESIDUAL_FUSION``) — BN(+ReLU)→conv
   of any geometry onto the prologue kernel + convolution.

The manager is ungated in this slice (see manager.py); ``bn_fold``,
``hoist``, ``int8_ptq`` and ``bf16_cast`` are reported ``disabled``.
"""
from .base import GraphPass, PassContext, rebuild_graph, resolve_flag, \
    flag_active
from .manager import (PassManager, apply_pipeline, default_manager,
                      legacy_fusion_entry, pipeline_key_material)
from .pallas_fusion import PallasFusionPass
from .residual_fusion import ResidualFusionPass

__all__ = ["GraphPass", "PassContext", "PassManager", "apply_pipeline",
           "default_manager", "legacy_fusion_entry", "pipeline_key_material",
           "rebuild_graph",
           "resolve_flag", "flag_active", "PallasFusionPass",
           "ResidualFusionPass"]
