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
variables (config.py).

Observability: ``serving_report()`` is the ``serving`` collector of the
telemetry registry, one entry per live Predictor, DynamicBatcher and
DecodePredictor (each tagged with a stable process-unique ``id``,
sorted by it) plus the load generator's client counters. The
per-replica series live in the registry as ``serving::<id>::...``
(per-bucket latency, batches, time to first token, inter-token time,
tokens) and are removed when their owner is collected. With
``MXTPU_TRACE_DIR`` set each request is a ``serving:request`` span with
its ``serving:batch`` and ``serving:bucket<b>`` spans under it (the
decode batcher's ``decode:prefill`` / ``decode:step``); with
``MXTPU_TELEMETRY_DIR`` set the batchers write ``serving_batch``,
``serving_overloaded``, ``serving_deadline`` and
``serving_generation`` events carrying the requests' trace ids. Each
captured bucket and the decode KV-cache have a ``memory_report()`` row.

Not ported: the persistent compile cache, ``restage``, and the fleet
router, autoscaler and tenancy (``fleet``, ``autoscale``, ``tenancy``).
"""
from __future__ import annotations

import itertools as _itertools
import weakref

from ..base import MXNetError

__all__ = ["Predictor", "DynamicBatcher", "ServingFuture", "ServingError",
           "Overloaded", "DeadlineExceeded", "Cancelled", "decode",
           "loadgen", "serving_report"]


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


# live Predictor / DynamicBatcher / DecodePredictor instances, which
# serving_report() walks (WeakSets: a dropped server never pins its
# device buffers). Every instance gets a stable process-unique id at
# registration, so two replicas in one process never merge into one
# series
_PREDICTORS: "weakref.WeakSet" = weakref.WeakSet()
_BATCHERS: "weakref.WeakSet" = weakref.WeakSet()
_DECODERS: "weakref.WeakSet" = weakref.WeakSet()
_PRED_SEQ = _itertools.count()
_BATCH_SEQ = _itertools.count()
_DECODE_SEQ = _itertools.count()


def _register_predictor(p):
    p.telemetry_id = f"{p.symbol.name or 'predictor'}#{next(_PRED_SEQ)}"
    _PREDICTORS.add(p)
    # the id is process-unique, so every serving::<id>::... series is
    # this replica's: drop them when it dies, or replica churn grows the
    # registry (and every report) without bound
    weakref.finalize(p, _treg.remove, f"serving::{p.telemetry_id}::")


def _register_batcher(b):
    b.telemetry_id = f"{b.name}#{next(_BATCH_SEQ)}"
    _BATCHERS.add(b)


def _register_decoder(d):
    """DecodePredictor registration (decode/engine.py): the same stable
    id and registry cleanup as a predictor, its own report section."""
    d.telemetry_id = f"{d.name or 'decode'}#{next(_DECODE_SEQ)}"
    _DECODERS.add(d)
    weakref.finalize(d, _treg.remove, f"serving::{d.telemetry_id}::")


def _collect(reset: bool = False) -> dict:
    """Serving observability: one entry per live Predictor (per-bucket
    call / row / pad counters, retraces), DynamicBatcher (per-bucket
    p50 / p99 latency, queue depth, occupancy, shed and deadline
    counters) and DecodePredictor, each tagged with its ``id`` and
    sorted by it, and the load generator's client counters.
    ``reset=True`` clears the windows and counters after reading,
    including the ``serving::`` registry series."""
    out = {
        "predictors": sorted(
            (p.report(reset=reset) for p in list(_PREDICTORS)),
            key=lambda r: r["id"]),
        "batchers": sorted(
            (b.report(reset=reset) for b in list(_BATCHERS)),
            key=lambda r: r["id"]),
        "decoders": sorted(
            (d.report(reset=reset) for d in list(_DECODERS)),
            key=lambda r: r["id"]),
        "clients": loadgen.client_report(reset=reset),
    }
    if reset:
        _treg.reset(prefix="serving::")
    return out


from ..telemetry import registry as _treg  # noqa: E402

serving_report = _treg.collector_view("serving", _collect)


from .predictor import Predictor                      # noqa: E402
from .batcher import DynamicBatcher, ServingFuture    # noqa: E402
from . import loadgen                                 # noqa: E402
from . import decode                                  # noqa: E402
