"""Autoregressive decode serving: KV-cache programs and continuous
batching (counterpart of ``mxnet_tpu/serving/decode``).

- ``model``: the transformer LM as functions on tensors:
  ``prefill_step`` (fills a lane of the KV-cache from a prompt),
  ``decode_step`` (one token for every lane against the cache),
  ``verify_step`` (up to K tokens a lane, for speculative decoding) and
  ``reprefill_step`` (the cacheless baseline of the bytes comparison).
  Decode and verify attention run on D1, the decode-attention kernel
  (``ops/decode_attention.py``), for the f32 and the int8 cache.
- ``engine.DecodePredictor``: per-bucket prefill, one decode and per-width
  verify programs, each a captured CUDA graph on the card, over a KV-cache
  that is persistent device state updated in place.
- ``batcher.DecodeBatcher``: continuous batching (requests join and leave
  per token, freed lanes backfill mid-flight), ``StreamFuture`` streams,
  the disaggregated ``prefill`` / ``decode`` roles and speculative
  stepping.
- ``spec.SpecDecodePredictor``: a draft proposes, one batched verify
  checks, the accepted prefix commits; ``make_draft_spec``.

``build_symbol`` and ``distill_draft`` come with the port's training of
this model. Config: ``MXTPU_DECODE_SLOTS``, ``MXTPU_DECODE_SEQ_BUCKETS``,
``MXTPU_DECODE_KV_DTYPE``, ``MXTPU_DECODE_MAX_WAIT_US``,
``MXTPU_DECODE_MAX_QUEUE``, ``MXTPU_SPEC_K``, ``MXTPU_SPEC_DISABLE_BELOW``,
``MXTPU_SPEC_PROBE_STEPS``, ``MXTPU_SPEC_WINDOW``.
"""
from . import model
from .model import TransformerLMSpec, init_params
from .engine import DecodePredictor
from .batcher import DecodeBatcher, StreamFuture
from .spec import SpecDecodePredictor, make_draft_spec

__all__ = ["model", "TransformerLMSpec", "init_params", "DecodePredictor",
           "DecodeBatcher", "StreamFuture", "SpecDecodePredictor",
           "make_draft_spec"]
