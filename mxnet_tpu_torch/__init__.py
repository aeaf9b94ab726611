"""``mxnet_tpu_torch`` — the PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package (``mxnet_tpu``) stays the reference. This package keeps
its module names, its symbol JSON format and its ``MXTPU_*`` knobs, and
runs on an NVIDIA Hopper card (``cuda:0`` unless the caller passes a CPU
device). Every Pallas kernel on the served path is a hand-written Hopper
kernel under ``kernels/``; on CPU tensors each kernel wrapper runs its
plain PyTorch version instead, which is how the CPU tests reach it.

Slice 1 covers inference serving of a symbol graph: the op set a ResNet
needs, the ``pallas_fusion`` and ``residual_fusion`` rewrite passes, and
``serving.Predictor`` / ``serving.DynamicBatcher``. Slice 2 covers
training it: ``mod.Module`` with the fused step, ``init``, ``optimizer``,
``lr_scheduler``, ``io.NDArrayIter`` and ``metric``. Slice 3 covers the
imperative path: ``nd`` (NDArray), ``autograd``, ``gluon`` (Blocks,
layers, losses, Trainer, the ResNet model zoo), ``random``, and
``operator`` / ``rtc``, the hook that runs a user's CUDA or Triton
kernel as an op. Slice 6 captures the fused training step and each
Predictor bucket as CUDA graphs on the card, under the program keys,
registry and retrace guard of ``compile`` (``compile_report()``).
Slice 7 covers ``bench.py``'s ``fit()`` and fault-tolerance phases: the
in-step metric counters (``metric_device``) and the non-finite step
guard inside the captured step, ``fault`` (``fault_report()``) and
``faultinject``, ``checkpoint.CheckpointManager`` with ``fit``'s
auto-resume, ``callback``, the remaining ``metric`` classes, ``model``
checkpoints and the ``.params`` format (``nd.save`` / ``nd.load``,
``ndarray.param_file``), byte for byte the JAX package's. Slice 10
covers the bound ``executor.Executor`` (``Symbol.simple_bind`` /
``bind``, captured forward and grad programs), ``Module(fused=False)``
with the ``optimizer.Updater``, every optimizer rule (the eager classes
and ``parallel.functional_opt``, also inside the captured fused step)
and ``monitor.Monitor``. Slice 12 covers row-sparse embedding training:
``sparse`` (``SparseEmbedding``, the fused step's routing and the lazy
sgd / adam rows), ``data`` (``DataPipeline`` under ``fit``, RecordIO
sources), ``recordio`` and the ``telemetry`` registry
(``sparse_report()``, ``data_report()``). Slice 13 covers the LSTM
language models: the ``RNN`` op (lstm on the L1 kernel) and ``Dropout``,
``gluon.rnn``, ``parallel.TrainStep`` (a Gluon block's captured training
step), the symbolic cells of ``rnn`` with ``BucketSentenceIter``, and
``mod.BucketingModule``. Slice 15 covers the telemetry layer:
``telemetry`` (``StepTimeline`` through ``fit`` and the captured step,
trace spans, the durable event log, ``memory_report()`` of the captured
programs), ``profiler`` on ``torch.profiler``, and the ``serving``,
``compile``, ``fault`` and ``data`` collectors (``serving_report()``).
Slice 16 covers the image-classification examples
(``examples.image_classification``): the single-process ``kvstore``
(``kv``) with ``gradient_compression``, ``Module.predict`` /
``iter_predict`` / ``as_predictor``, a Trainer that updates on the
store, and the ``LRN`` op.
"""
from . import base, config, context
from .base import MXNetError
from .context import (Context, cpu, gpu, current_context, num_gpus,
                      default_device)
from . import ops
from . import dtype, random
from .random import seed
from . import autograd
from . import operator  # registers the Custom op before nd's codegen
from . import ndarray
from . import ndarray as nd
from . import rtc
from . import symbol
from . import symbol as sym
from . import interop
from . import serving
from . import initializer
from . import initializer as init
from . import io, lr_scheduler, metric, optimizer
from . import module
from . import module as mod
from . import gluon
from . import compile
from .compile import compile_report
from . import fault, faultinject
from .fault import fault_report
from . import callback, checkpoint, metric_device, model
from . import executor, monitor
from . import monitor as mon
from . import gradient_compression, kvstore
from . import kvstore as kv
from .checkpoint import CheckpointManager
from . import telemetry, sparse, recordio, data
from .data import data_report
from . import parallel, rnn
from . import profiler
from .telemetry import memory_report
from .serving import serving_report

__all__ = ["MXNetError", "base", "config", "context", "Context", "cpu", "gpu",
           "current_context", "num_gpus", "default_device", "ops", "dtype",
           "random", "seed", "autograd", "operator", "ndarray", "nd", "rtc",
           "symbol", "sym", "interop", "serving", "initializer", "init", "io",
           "lr_scheduler", "metric", "optimizer", "module", "mod", "gluon",
           "compile", "compile_report", "fault", "faultinject",
           "fault_report", "callback", "checkpoint", "metric_device",
           "model", "executor", "monitor", "mon", "kvstore", "kv",
           "gradient_compression", "CheckpointManager",
           "telemetry", "sparse", "recordio", "data", "data_report",
           "parallel", "rnn", "profiler", "memory_report",
           "serving_report"]

config._autostart_profiler()
