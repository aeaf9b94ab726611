"""``mxnet_tpu_torch`` — the PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package (``mxnet_tpu``) stays the reference. This package keeps
its module names, its symbol JSON format and its ``MXTPU_*`` knobs, and
runs on an NVIDIA Hopper card (``cuda:0`` unless the caller passes a CPU
device). Every Pallas kernel on the served path is a hand-written Hopper
kernel under ``kernels/``; on CPU tensors each kernel wrapper runs its
plain PyTorch version instead, which is how the CPU tests reach it.

Slice 1 covers inference serving of a symbol graph: the op set a ResNet
needs, the ``pallas_fusion`` and ``residual_fusion`` rewrite passes, and
``serving.Predictor`` / ``serving.DynamicBatcher``.
"""
from . import base, config, context
from .base import MXNetError
from .context import cpu, gpu, default_device
from . import ops
from . import symbol
from . import symbol as sym
from . import interop
from . import serving

__all__ = ["MXNetError", "base", "config", "context", "cpu", "gpu",
           "default_device", "ops", "symbol", "sym", "interop", "serving"]
