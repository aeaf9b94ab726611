"""Captured programs: keys, registry and the retrace guard (counterpart
of ``mxnet_tpu/compile/``).

The JAX package compiles its fused training step and each Predictor
bucket into one XLA program. On the card the counterpart is a CUDA
graph: the step and each bucket are captured once and replayed.

- :mod:`.key`: canonical program identity, sha256 over (symbol JSON,
  input shapes and dtypes, optimizer config, fusion flag and pipeline
  outcome, backend identity).
- :mod:`.registry`: :class:`CapturedProgram` (capture, replay, launch
  counts that count replays), per-program records, the retrace guard and
  :func:`compile_report`.

Not ported: ``cache.py`` (the persistent ``.mxprog`` cache), its CLI,
``load_or_compile`` and ``guarded_loaded_program`` (loads from disk), since
a CUDA graph cannot be serialized (``compile_report()["cache"]`` says
so); ``JitProgram`` and ``donation_supported`` (XLA buffer donation).
:class:`CapturedProgram` takes their place; :func:`shared_programs`
shares a bound Executor's captured programs between equal keys.
"""
from __future__ import annotations

from .key import (ProgramKey, program_key, arg_signature,
                  optimizer_fingerprint, symbol_digest)
from .registry import (ProgramRecord, CapturedProgram, note_entry_point,
                       compile_report, reset, shared_programs)

__all__ = [
    "ProgramKey", "program_key", "arg_signature", "optimizer_fingerprint",
    "symbol_digest", "ProgramRecord", "CapturedProgram", "note_entry_point",
    "compile_report", "reset", "shared_programs",
]
