"""Deterministic fault-injection harness (counterpart of
``mxnet_tpu/faultinject.py``).

Faults are armed by site and ordinal, never randomly: a spec names a
site plus the exact coordinate at which it fires (byte offset, step
index, batch index, call ordinal). The sites the port consults:

- ``ckpt_write`` (``base.atomic_write``, through :func:`guarded_write`):
  ``byte=N`` writes the first N bytes of the file for real, then raises
  (or, with ``action=kill``, SIGKILLs the process): a torn write that the
  rename discipline must survive. ``match=substr`` arms only files whose
  name contains it; ``call=N`` only the N-th matching file.
- ``ckpt_truncate`` (``CheckpointManager``, through
  :func:`maybe_truncate`): ``bytes=N`` truncates a payload file after
  its manifest committed, storage tearing below the rename that the
  manifest's CRC must catch on load.
- ``nan_grad`` (``module/fused.py``): ``step=N`` multiplies the float
  data inputs of the step whose ``num_update`` is N by NaN, so the same
  captured program replays with NaN gradients and the in-step guard is
  exercised without a new capture.
- ``data_iter`` (``io.DataIter.__next__``): ``batch=B`` raises at an
  iterator's B-th batch (1-based), the stand-in for a dying input
  worker.
- ``decode_step`` (``serving/decode/engine.py``): consulted before each
  decode program launch, ``token=N`` the engine-wide step ordinal. A
  raise fails the in-flight generations with the KV-cache un-advanced;
  ``action=sleep:ms=N`` stretches the step (the slow-decode drill) and
  the program still runs; ``action=kill`` is the SIGKILL-mid-decode
  drill.
- ``spec_verify`` (``serving/decode/spec.py``): consulted once per
  speculative round (``round=N``). A fire is a divergence storm: the
  round's proposals are replaced by wrong tokens, the verify program
  runs for real, acceptance records zero and the windowed degrade
  policy must drop to plain decode; the stream stays exact.
- ``kv_handoff`` (``serving/decode/batcher.py``): consulted at every
  prefill-to-decode lane transfer. A fire loses the exported lane: the
  decode side re-prefills from the prompt, zero tokens dropped.
- ``sparse_update`` (``module/fused.py``): consulted before every step
  of a fused step with routed row-sparse tables (``step=N``, the step's
  ``num_update``), where the rows' update would commit. A fire raises
  before the step runs (nothing of it lands), so a checkpoint resume
  must restore the tables and their lazy optimizer state bit for bit;
  ``action=kill`` is the SIGKILL drill.
- ``data_worker`` (``data/pipeline.py``): consulted in a data-pipeline
  worker for every batch it takes (``batch=B``, the 1-based ordinal of
  the epoch's batch; ``worker=W``). A fire raises in the worker, and the
  error surfaces at the consumer's ``next()``; ``action=kill`` is the
  dying-input-worker drill.

- ``slow_step`` (``module/fused.py``): consulted at the top of every
  fused step (``step=N``); ``action=sleep:ms=N`` stretches the step,
  the straggler drill the step timeline must show.
- ``telemetry_write`` (``telemetry/export.py``): consulted on every
  event-log write (``event=N``) and rotation (``rotation=K``). A raise
  drops that event (counted in ``fault::telemetry.write_errors``) and
  the next write reopens the log; ``action=kill`` tears it mid-write.

The JAX package's other sites come with the subsystems that consult
them (ROADMAP.md). The same spec always produces the same failure.

Two arming surfaces, merged innermost-wins: the env
``MXTPU_FAULT_INJECT`` (``"site:key=val[:key=val];site2:..."``,
inherited by subprocesses) and the :class:`inject` context manager.
Sites are consulted through :func:`fire` (or :func:`guarded_write` for
byte-budgeted storage writes); an unarmed site costs one list check and
one env lookup. Firing raises :class:`FaultInjected` (an ``OSError``, so
storage sites take the path of real I/O errors) or, with
``action=kill``, SIGKILLs the process.
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time

__all__ = ["FaultInjected", "inject", "parse_spec", "active", "fire",
           "guarded_write", "maybe_truncate", "reset", "fired"]


class FaultInjected(OSError):
    """Raised at an armed fault site."""

    def __init__(self, site, **ctx):
        detail = ", ".join(f"{k}={v}" for k, v in sorted(ctx.items()))
        super().__init__(f"injected fault at site '{site}' ({detail})")
        self.site = site
        self.ctx = ctx


_lock = threading.Lock()
_stack = []        # programmatic layers: list of {site: params}
_consults = {}     # site -> times fire() was consulted (the implicit 'call')
_fired = {}        # site -> times the site actually fired
_env_cache = (None, {})   # (raw MXTPU_FAULT_INJECT string, parsed spec)


def parse_spec(spec):
    """``"site:k=v:k2=v2;site2:..."`` -> {site: {k: v}} (ints parsed)."""
    out = {}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        params = {}
        for kv in fields[1:]:
            k, _, v = kv.partition("=")
            try:
                params[k.strip()] = int(v)
            except ValueError:
                params[k.strip()] = v.strip()
        out[fields[0].strip()] = params
    return out


def active(site):
    """The armed params for ``site`` (innermost ``inject`` layer wins,
    then the env spec), or None when unarmed."""
    global _env_cache
    if _stack:
        with _lock:
            for layer in reversed(_stack):
                if site in layer:
                    return dict(layer[site])
    env = os.environ.get("MXTPU_FAULT_INJECT")
    if not env:
        return None
    if _env_cache[0] != env:
        _env_cache = (env, parse_spec(env))
    return _env_cache[1].get(site)


class inject:
    """Arm fault sites for a ``with`` scope::

        with faultinject.inject("nan_grad:step=3"):
            ...
        with faultinject.inject(nan_grad={}):      # every step
            ...

    Layers nest; site counters reset on entry so ordinals are scoped to
    the injection, not the process."""

    def __init__(self, spec=None, **sites):
        layer = parse_spec(spec) if isinstance(spec, str) \
            else dict(spec or {})
        for site, params in sites.items():
            layer[site] = dict(params)
        self._layer = layer

    def __enter__(self):
        with _lock:
            _stack.append(self._layer)
            for site in self._layer:
                _consults.pop(site, None)
                _fired.pop(site, None)
        return self

    def __exit__(self, *exc):
        with _lock:
            _stack.remove(self._layer)


def _matches(params, ctx):
    """Every armed coordinate present in ``ctx`` must equal it; ``times``,
    ``action``, ``byte``, ``bytes``, ``match`` and ``ms`` are modifiers,
    not coordinates."""
    for k, v in params.items():
        if k in ("times", "action", "byte", "bytes", "match", "ms"):
            continue
        if k in ctx and ctx[k] != v:
            return False
    return True


def _record_fire(site):
    """Count one firing (call under ``_lock``)."""
    from . import fault
    _fired[site] = _fired.get(site, 0) + 1
    fault.count(f"injected.{site}")


def fire(site, **ctx):
    """Consult a site. True exactly when the armed coordinates match
    ``ctx`` (an implicit 1-based ``call`` ordinal is supplied). Honours
    ``times=N`` (fire at most N times); ``action=kill`` SIGKILLs the
    process, ``action=sleep`` sleeps ``ms`` milliseconds (default 10)
    before returning True."""
    params = active(site)
    if params is None:
        return False
    with _lock:
        _consults[site] = _consults.get(site, 0) + 1
        ctx.setdefault("call", _consults[site])
        if not _matches(params, ctx):
            return False
        if "times" in params and _fired.get(site, 0) >= params["times"]:
            return False
        _record_fire(site)
    action = params.get("action")
    if action == "kill":
        _sigkill(site)
    elif action == "sleep":
        time.sleep(max(0, params.get("ms", 10)) / 1000.0)
    return True


def fired(site):
    """How many times ``site`` has fired."""
    with _lock:
        return _fired.get(site, 0)


def reset():
    """Clear every ordinal and fired counter."""
    with _lock:
        _consults.clear()
        _fired.clear()


def _sigkill(site):
    print(f"faultinject: SIGKILL at site '{site}'", flush=True)
    sys.stdout.flush()
    os.kill(os.getpid(), signal.SIGKILL)


class _ByteBudgetFile:
    """File proxy that dies after ``byte`` bytes: the prefix that fits is
    written for real (a torn write), then the armed action runs."""

    def __init__(self, fobj, site, params, path):
        self._f = fobj
        self._site = site
        self._params = params
        self._path = path
        self._written = 0
        self._budget = params.get("byte")

    def write(self, data):
        if self._budget is not None and \
                self._written + len(data) > self._budget:
            keep = max(0, self._budget - self._written)
            if keep:
                self._f.write(data[:keep])
            self._f.flush()
            self._written += keep
            with _lock:
                _record_fire(self._site)
            if self._params.get("action") == "kill":
                os.fsync(self._f.fileno())
                _sigkill(self._site)
            raise FaultInjected(self._site, path=self._path,
                                byte=self._budget)
        self._written += len(data)
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)


def guarded_write(fobj, path=None, site="ckpt_write"):
    """Wrap an open file with the ``ckpt_write`` byte-budget site (the
    file itself when unarmed or when ``match=`` misses ``path``)."""
    params = active(site)
    if params is None:
        return fobj
    match = params.get("match")
    if match and (path is None or match not in os.path.basename(path)):
        return fobj
    if "call" in params:
        with _lock:
            _consults[site] = _consults.get(site, 0) + 1
            if _consults[site] != params["call"]:
                return fobj
    return _ByteBudgetFile(fobj, site, params, path)


def maybe_truncate(path, site="ckpt_truncate"):
    """``ckpt_truncate:bytes=N[:match=substr]``: truncate a file that
    already landed to N bytes."""
    params = active(site)
    if params is None:
        return
    match = params.get("match")
    if match and match not in os.path.basename(path):
        return
    n = params.get("bytes", 0)
    if os.path.getsize(path) <= n:
        return
    with _lock:
        _record_fire(site)
    with open(path, "rb+") as f:
        f.truncate(n)
