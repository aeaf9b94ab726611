"""Inference serving: a bucketed Predictor, a dynamic batcher and
decode serving (counterpart of ``mxnet_tpu/serving``).

- ``Predictor`` (predictor.py) freezes a symbol + params on a device,
  applies the rewrite pipeline to the predict program, and pads
  requests to a small fixed set of batch buckets.
- ``DynamicBatcher`` (batcher.py) coalesces concurrent requests into
  bucket-sized micro-batches, enforces per-request deadlines and sheds
  load past a queue bound with ``Overloaded``.
- ``decode`` (decode/): KV-cached autoregressive serving of a
  transformer LM with continuous batching and speculative decoding;
  ``loadgen`` drives it with closed-loop token clients.

Knobs default from the ``MXTPU_SERVING_*`` and ``MXTPU_DECODE_*``
variables (config.py). The compile cache, telemetry registry
(``serving_report()``), profiler spans and ``restage`` come in later
slices; ``report()`` keeps plain counters.
"""
from __future__ import annotations

import itertools as _itertools
import weakref

from ..base import MXNetError

__all__ = ["Predictor", "DynamicBatcher", "ServingFuture", "ServingError",
           "Overloaded", "DeadlineExceeded", "Cancelled", "decode",
           "loadgen"]


class ServingError(MXNetError):
    """Base class for serving-path failures."""


class Overloaded(ServingError):
    """Request rejected at admission: the batcher queue is at its bound.
    Raised immediately at ``submit()`` so the client can back off."""


class DeadlineExceeded(ServingError):
    """The request's deadline expired before its micro-batch ran."""


class Cancelled(ServingError):
    """The server stopped while this request was in flight: a generation
    mid-stream at ``stop(drain=False)`` keeps its already-streamed tokens,
    then ends with this error. A future is always completed."""


# live DecodePredictors (WeakSet: a dropped engine never pins its device
# buffers), each with a process-unique id; the telemetry registry, when
# the port has one, reads this set
_DECODERS: "weakref.WeakSet" = weakref.WeakSet()
_DECODE_SEQ = _itertools.count()


def _register_decoder(d):
    """DecodePredictor registration (decode/engine.py): a stable
    ``telemetry_id`` and a place in the live set."""
    d.telemetry_id = f"{d.name or 'decode'}#{next(_DECODE_SEQ)}"
    _DECODERS.add(d)


from .predictor import Predictor                      # noqa: E402
from .batcher import DynamicBatcher, ServingFuture    # noqa: E402
from . import loadgen                                 # noqa: E402
from . import decode                                  # noqa: E402
