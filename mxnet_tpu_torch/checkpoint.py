"""Atomic, self-validating training checkpoints with auto-resume
(counterpart of ``mxnet_tpu/checkpoint.py``).

- **Atomicity.** Every file is written temp + fsync + rename
  (``base.atomic_write``), and a CRC-checksummed ``MANIFEST.json`` is
  written last: a checkpoint without a valid manifest (stopped mid-save)
  or whose bytes do not match it (torn or corrupted storage) is invalid,
  and the loader falls back to the previous one.
- **Completeness.** One checkpoint holds params, aux, optimizer state,
  the epoch / batch cursor, the RNG stream and the train iterator's
  cursor: enough to resume with no epoch retrained and the stream an
  uninterrupted run would draw. The epoch's metric rides along pickled.
- **Retention.** The ``keep`` newest valid checkpoints survive
  (``MXTPU_CKPT_KEEP``, default 3); older and corrupt ones are pruned.
- **Async save.** ``async_save=True`` (``MXTPU_CKPT_ASYNC``) takes the
  host copy of the state at once (so the next step may overwrite the
  card's) and writes the files on a background thread; a failure there
  is raised by ``wait()`` or the next save.

Layout (one directory per checkpoint, ``<prefix>-NNNNNN/``), the JAX
package's, so either package restores the other's checkpoint:

    params.params      arg:/aux: map, the .params format
    optimizer.states   the Module's optimizer states (optional): the fused
                       step's get_states() bytes, or the Updater's
    extra.pkl          RNG snapshot + pickled metric + user extras
    MANIFEST.json      {tag, epoch, nbatch, files: {name: {crc32, size}}}

The RNG snapshot is the port's own (``random.get_state()``: the torch
generators' states as numpy arrays). A checkpoint of the JAX package
restores everything else and logs that the RNG stream was not restored.
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import threading
import time
import zlib

from . import fault
from .base import MXNetError, atomic_write, host_numpy

__all__ = ["CheckpointManager", "CheckpointState"]

_MANIFEST = "MANIFEST.json"
_PARAMS = "params.params"
_OPT = "optimizer.states"
_EXTRA = "extra.pkl"


class CheckpointState:
    """A loaded (validated) checkpoint."""

    def __init__(self, path, tag, meta, arg_params, aux_params,
                 opt_states=None, rng=None, metric=None, extra=None):
        self.path = path
        self.tag = tag
        self.epoch = int(meta.get("epoch", tag))
        self.nbatch = int(meta.get("nbatch", 0))
        self.num_update = int(meta.get("num_update", 0))
        self.meta = meta
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.opt_states = opt_states
        self.rng = rng
        self.metric = metric
        self.extra = extra

    def __repr__(self):
        return (f"CheckpointState(tag={self.tag}, epoch={self.epoch}, "
                f"nbatch={self.nbatch}, path={self.path!r})")

    @property
    def data_state(self):
        """The train iterator's ``get_state()`` cursor saved with this
        checkpoint, or None."""
        if isinstance(self.extra, dict):
            return self.extra.get("data_state")
        return None


def _crc_file(path):
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


class CheckpointManager:
    """See the module docstring. One producer calls :meth:`save_module`;
    readers validate and load."""

    def __init__(self, directory, prefix="ckpt", keep=None, async_save=None,
                 save_optimizer_states=True, logger=None):
        from . import config
        self.directory = os.fspath(directory)
        self.prefix = prefix
        self.keep = int(config.get("MXTPU_CKPT_KEEP")) if keep is None \
            else int(keep)
        self.async_save = bool(config.get("MXTPU_CKPT_ASYNC")) \
            if async_save is None else bool(async_save)
        self.save_optimizer_states = save_optimizer_states
        self.logger = logger or logging.getLogger(
            "mxnet_tpu_torch.checkpoint")
        os.makedirs(self.directory, exist_ok=True)
        self._thread = None
        self._bg_error = None
        self._lock = threading.Lock()
        self._valid_tags = set()   # tags this process wrote or validated
        self.last_save_s = None
        from . import profiler
        self._dom = profiler.Domain("ft")

    # -- naming ---------------------------------------------------------------
    def _dir_for(self, tag):
        return os.path.join(self.directory, f"{self.prefix}-{tag:06d}")

    def _tags(self):
        """Existing checkpoint tags, newest first."""
        pre = self.prefix + "-"
        tags = []
        for name in os.listdir(self.directory):
            if name.startswith(pre) and name[len(pre):].isdigit() and \
                    os.path.isdir(os.path.join(self.directory, name)):
                tags.append(int(name[len(pre):]))
        return sorted(tags, reverse=True)

    # -- save -----------------------------------------------------------------
    def save_module(self, module, epoch, nbatch=0, eval_metric=None,
                    extra=None, data_state=None):
        """Snapshot a bound, initialized Module into checkpoint ``epoch``
        (the tag is the resume cursor: the next epoch to run). The state
        is copied to the host here, behind the steps already queued;
        with ``async_save`` the files are then written on a background
        thread. ``data_state`` (a train iterator's ``get_state()``)
        rides in ``extra``."""
        from . import compile as compile_mod
        from . import random as _random
        if data_state is not None:
            extra = dict(extra or {})
            extra["data_state"] = data_state
        arg_params, aux_params = module.get_params()
        names = list(arg_params) + list(aux_params)
        host = dict(zip(names, host_numpy(
            [arg_params[k] for k in arg_params] +
            [aux_params[k] for k in aux_params])))
        args_np = {k: host[k] for k in arg_params}
        auxs_np = {k: host[k] for k in aux_params}
        opt_state = None
        if self.save_optimizer_states and \
                getattr(module, "optimizer_initialized", False):
            # the host copy now, the pickling with the other files
            opt_state = module._opt_states_snapshot()
        payload = {"rng": _random.get_state(),
                   "metric": _pickle_or_none(eval_metric),
                   "extra": extra}
        meta = {"tag": int(epoch), "epoch": int(epoch),
                "nbatch": int(nbatch),
                "num_update": int(module._optimizer.num_update
                                  if getattr(module, "_optimizer", None)
                                  is not None else 0),
                "time": time.time(),
                "compile": compile_mod.compile_report()["totals"]}
        sym_path = os.path.join(self.directory,
                                f"{self.prefix}-symbol.json")
        if not os.path.exists(sym_path):
            module.symbol.save(sym_path)
        return self.save_state(args_np, auxs_np, meta, opt_state, payload)

    def save_state(self, args_np, auxs_np, meta, opt_state=None,
                   payload=None):
        """Write one checkpoint from host state (``opt_state``: the
        optimizer state's bytes, or a snapshot to pickle)."""
        self.wait()  # one background save at a time
        if self.async_save:
            t = threading.Thread(
                target=self._write_guarded,
                args=(args_np, auxs_np, meta, opt_state, payload),
                name="mxnet-ckpt-save", daemon=True)
            with self._lock:
                self._thread = t
            t.start()
            fault.count("ckpt.async_saves")
            return self._dir_for(meta["tag"])
        return self._write(args_np, auxs_np, meta, opt_state, payload)

    def wait(self):
        """Join the background save, if any; raise its failure."""
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join()
        with self._lock:
            err, self._bg_error = self._bg_error, None
        if err is not None:
            raise err

    def _write_guarded(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # raised again by wait()
            with self._lock:
                self._bg_error = e
            fault.count("ckpt.save_errors")

    def _write(self, args_np, auxs_np, meta, opt_state, payload):
        from . import faultinject
        from .ndarray.param_file import dumps_params
        tag = meta["tag"]
        ckpt_dir = self._dir_for(tag)
        t0 = time.perf_counter()
        with self._dom.new_task("save"):
            os.makedirs(ckpt_dir, exist_ok=True)
            self._valid_tags.discard(tag)
            stale = os.path.join(ckpt_dir, _MANIFEST)
            if os.path.exists(stale):
                os.unlink(stale)  # a re-save of a tag: invalidate first
            # each payload is serialized in memory and its CRC taken from
            # the exact bytes before they reach the disk (validate() is
            # the read side's check)
            save_dict = {f"arg:{k}": v for k, v in args_np.items()}
            save_dict.update({f"aux:{k}": v for k, v in auxs_np.items()})
            blobs = {_PARAMS: dumps_params(list(save_dict.values()),
                                           list(save_dict.keys())),
                     _EXTRA: pickle.dumps(payload or {})}
            if opt_state is not None:
                blobs[_OPT] = opt_state if isinstance(opt_state, bytes) \
                    else pickle.dumps(opt_state)
            for name in (_PARAMS, _OPT, _EXTRA):
                # a re-save writing fewer files must not leave an earlier
                # save's payload behind, outside the new manifest's CRCs
                p = os.path.join(ckpt_dir, name)
                if name not in blobs and os.path.exists(p):
                    os.unlink(p)
            files = {}
            for name, blob in blobs.items():
                with atomic_write(os.path.join(ckpt_dir, name)) as f:
                    f.write(blob)
                files[name] = {"crc32": zlib.crc32(blob) & 0xFFFFFFFF,
                               "size": len(blob)}
            manifest = dict(meta, files=files, version=1)
            # the commit point: the checkpoint is valid iff this file
            # lands intact and the payloads match its checksums
            with atomic_write(os.path.join(ckpt_dir, _MANIFEST),
                              mode="w") as f:
                json.dump(manifest, f, indent=1)
            # 'ckpt_truncate' tears a payload after the manifest
            # committed: storage failing below the rename, which the CRC
            # must catch
            for name in files:
                faultinject.maybe_truncate(os.path.join(ckpt_dir, name))
        fault.count("ckpt.saves")
        self._valid_tags.add(tag)
        self.last_save_s = time.perf_counter() - t0
        from .telemetry import export as _texp
        if _texp.enabled():
            _texp.emit_event("checkpoint", action="save", path=ckpt_dir,
                             epoch=meta.get("epoch"),
                             secs=round(self.last_save_s, 4))
        self.logger.info("Saved checkpoint '%s' (epoch %s, %.3fs)",
                         ckpt_dir, meta.get("epoch"), self.last_save_s)
        self.prune()
        return ckpt_dir

    # -- validate / load -------------------------------------------------------
    def validate(self, ckpt_dir):
        """True iff the manifest parses and every payload file matches
        its recorded CRC32 and size."""
        mpath = os.path.join(ckpt_dir, _MANIFEST)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            files = manifest["files"]
            if _PARAMS not in files:
                return False
            for name, rec in files.items():
                p = os.path.join(ckpt_dir, name)
                if os.path.getsize(p) != rec["size"] or \
                        _crc_file(p) != rec["crc32"]:
                    return False
            return True
        except (OSError, ValueError, KeyError):
            return False

    def load(self, tag):
        """Load one checkpoint by tag; raises if it is invalid."""
        ckpt_dir = self._dir_for(tag)
        if not self.validate(ckpt_dir):
            raise MXNetError(f"checkpoint '{ckpt_dir}' is missing or "
                             "corrupt (manifest/CRC mismatch)")
        return self._load_dir(ckpt_dir, tag)

    def _load_dir(self, ckpt_dir, tag):
        from . import ndarray as nd
        with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
            meta = json.load(f)
        # only the files the manifest lists belong to the checkpoint
        listed = meta.get("files", {})
        arg_params, aux_params = {}, {}
        for k, v in nd.load(os.path.join(ckpt_dir, _PARAMS)).items():
            tp, name = k.split(":", 1)
            (arg_params if tp == "arg" else aux_params)[name] = v
        opt_states = None
        if _OPT in listed:
            with open(os.path.join(ckpt_dir, _OPT), "rb") as f:
                opt_states = f.read()
        payload = {}
        if _EXTRA in listed:
            with open(os.path.join(ckpt_dir, _EXTRA), "rb") as f:
                payload = pickle.loads(f.read())
        return CheckpointState(ckpt_dir, tag, meta, arg_params, aux_params,
                               opt_states=opt_states,
                               rng=payload.get("rng"),
                               metric=payload.get("metric"),
                               extra=payload.get("extra"))

    def load_latest(self):
        """The newest valid checkpoint, or None. Corrupt, truncated and
        partial checkpoints are counted, logged and skipped."""
        self.wait()
        with self._dom.new_task("load"):
            for tag in self._tags():
                ckpt_dir = self._dir_for(tag)
                if self.validate(ckpt_dir):
                    self._valid_tags.add(tag)
                    return self._load_dir(ckpt_dir, tag)
                fault.count("ckpt.corrupt_detected")
                fault.count("ckpt.fallbacks")
                self.logger.warning(
                    "checkpoint '%s' failed validation (torn write or "
                    "corruption); falling back to the previous one",
                    ckpt_dir)
        return None

    # -- restore ---------------------------------------------------------------
    def restore(self, module, state=None, load_optimizer=True,
                restore_rng=True):
        """Apply a checkpoint to a bound module: params and aux always
        (copied into the step's tensors), the optimizer state when the
        optimizer is initialized, the RNG stream when the checkpoint
        carries the port's. Returns the state used, or None when no
        valid checkpoint exists."""
        from . import random as _random
        if state is None:
            state = self.load_latest()
        if state is None:
            return None
        module.set_params(state.arg_params, state.aux_params)
        if load_optimizer and state.opt_states is not None and \
                getattr(module, "optimizer_initialized", False):
            module._set_opt_states(state.opt_states)
        if restore_rng and state.rng is not None:
            if "generators" in state.rng:
                _random.set_state(state.rng)
            else:
                self.logger.warning(
                    "checkpoint '%s' carries another package's RNG "
                    "snapshot: the RNG stream was not restored",
                    state.path)
        fault.count("ckpt.restores")
        from .telemetry import export as _texp
        if _texp.enabled():
            _texp.emit_event("checkpoint", action="restore",
                             path=state.path, epoch=state.epoch)
        return state

    # -- retention -------------------------------------------------------------
    def prune(self):
        """Keep the ``keep`` newest valid checkpoints; remove older ones
        and every invalid directory older than a valid one."""
        if self.keep <= 0:
            return
        valid_seen = 0
        for tag in self._tags():
            ckpt_dir = self._dir_for(tag)
            # checkpoints this process wrote or validated skip the CRC
            # re-read; load_latest always validates
            if tag in self._valid_tags or self.validate(ckpt_dir):
                self._valid_tags.add(tag)
                valid_seen += 1
                if valid_seen > self.keep:
                    shutil.rmtree(ckpt_dir, ignore_errors=True)
                    self._valid_tags.discard(tag)
                    fault.count("ckpt.pruned")
            elif valid_seen > 0:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
                fault.count("ckpt.pruned_corrupt")


def _pickle_or_none(obj):
    """The pickled metric, or None for one that cannot be pickled (a
    ``CustomMetric`` over a lambda)."""
    if obj is None:
        return None
    try:
        return pickle.dumps(obj)
    except (pickle.PicklingError, TypeError, AttributeError):
        return None
