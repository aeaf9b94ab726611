"""Inference serving: a bucketed Predictor and a dynamic batcher
(counterpart of ``mxnet_tpu/serving``).

- ``Predictor`` (predictor.py) freezes a symbol + params on a device,
  applies the rewrite pipeline to the predict program, and pads
  requests to a small fixed set of batch buckets.
- ``DynamicBatcher`` (batcher.py) coalesces concurrent requests into
  bucket-sized micro-batches, enforces per-request deadlines and sheds
  load past a queue bound with ``Overloaded``.

Knobs default from the ``MXTPU_SERVING_*`` variables (config.py). The
compile cache, telemetry registry, profiler spans, fault injection and
``restage`` come in later slices; ``report()`` keeps plain counters.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["Predictor", "DynamicBatcher", "ServingFuture", "ServingError",
           "Overloaded", "DeadlineExceeded"]


class ServingError(MXNetError):
    """Base class for serving-path failures."""


class Overloaded(ServingError):
    """Request rejected at admission: the batcher queue is at its bound.
    Raised immediately at ``submit()`` so the client can back off."""


class DeadlineExceeded(ServingError):
    """The request's deadline expired before its micro-batch ran."""


from .predictor import Predictor                      # noqa: E402
from .batcher import DynamicBatcher, ServingFuture    # noqa: E402
