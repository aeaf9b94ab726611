"""KVStore: the key-value store that Module, Trainer and user scripts
program against (counterpart of ``mxnet_tpu/kvstore.py``; reference:
python/mxnet/kvstore.py, src/kvstore/kvstore_local.h).

One process on one device: ``local``, ``device``, ``nccl`` and the
``local_allreduce_*`` names all give the single-process store. ``push``
sums the copies of a value (a list) and either keeps the sum for a later
``pull`` or, once an optimizer or updater is set ("update on kvstore"),
feeds it to the updater against the stored weight. ``init`` and ``set``
copy the value, as the reference does, so the store owns its arrays.
``pull`` writes into the targets in place (a target of another shape is
rebound to a copy), so a Gluon parameter stays the leaf that autograd
differentiates. ``row_sparse_pull`` gathers the requested rows into dense
targets; row-sparse targets and the ``dist*`` types are not ported and
raise, naming ROADMAP.md A6 and A11. The optimizer-state files are the
``optimizer.Updater``'s pickle, which either package reads.
"""
from __future__ import annotations

import numpy as np
import torch

from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "create"]

_LOCAL_TYPES = ("local", "device", "nccl", "local_allreduce_cpu",
                "local_allreduce_device")
_DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_async", "dist")
# the types the reference compresses for (a 'local' store has no wire)
_COMPRESSIBLE = ("device", "dist", "dist_sync", "dist_async",
                 "dist_sync_device", "dist_device_sync")


def _as_nd(v):
    """An NDArray of a value: an NDArray as is, a tensor wrapped (no
    copy), anything else through numpy as float32 where it is float64."""
    if isinstance(v, NDArray):
        return v
    if isinstance(v, torch.Tensor):
        return NDArray(v.detach())
    a = np.asarray(v)
    return NDArray(torch.from_numpy(
        a.astype(np.float32) if a.dtype == np.float64 else a.copy()))


def _check_dense(t):
    if getattr(t, "stype", "default") != "default":
        raise NotImplementedError(
            f"KVStore: a {t.stype} target needs sparse storage, which is "
            "not ported (ROADMAP.md A6)")


def _write(t, value):
    """``value`` (a tensor) into the NDArray ``t``: in place when the
    shapes agree, else ``t`` is rebound to a copy."""
    _check_dense(t)
    if tuple(t.shape) == tuple(value.shape):
        with torch.no_grad():
            t._data.copy_(value)
    else:
        t._data = value.detach().to(t._data.device, copy=True)


def _as_key_list(key, value):
    """Parallel lists of keys and values (reference: kvstore.py
    _ctype_key_value)."""
    if isinstance(key, (list, tuple)):
        return list(key), list(value)
    return [key], [value]


def _key_int(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


class KVStore:
    """The single-process key-value store (reference: kvstore.py:55)."""

    def __init__(self, kv_type="local"):
        if "dist" in kv_type:
            raise NotImplementedError(
                f"kvstore {kv_type!r}: the distributed stores are not "
                "ported (ROADMAP.md A11)")
        self.type = kv_type
        self._data = {}
        self._merged = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._compression_params = None

    # -- basic -----------------------------------------------------------------
    def init(self, key, value):
        """Store a copy of each key's value; a key already there keeps
        its value (reference: kvstore.py:93)."""
        for k, v in zip(*_as_key_list(key, value)):
            if k in self._data:
                continue
            v0 = v[0] if isinstance(v, (list, tuple)) else v
            self._data[k] = _as_nd(v0).copy()

    def set(self, key, value):
        """Overwrite each key's stored value with a copy of ``value``
        (a checkpoint restore into a store that holds the weights)."""
        for k, v in zip(*_as_key_list(key, value)):
            v0 = v[0] if isinstance(v, (list, tuple)) else v
            self._data[k] = _as_nd(v0).copy()

    def push(self, key, value, priority=0):
        """Sum each key's copies (a list), compress the sum when
        compression is set, then run the updater on it against the
        stored value, or keep it for ``pull`` (reference:
        KVStoreLocal::Push)."""
        for k, v in zip(*_as_key_list(key, value)):
            vals = [_as_nd(x) for x in
                    (v if isinstance(v, (list, tuple)) else [v])]
            for x in vals:
                _check_dense(x)
            agg = vals[0]
            for extra in vals[1:]:
                agg = agg + extra
            agg = self._apply_compression(k, agg)
            if self._updater is not None:
                if k not in self._data:
                    raise ValueError(f"key {k} not initialized")
                self._updater(_key_int(k), agg, self._data[k])
            else:
                self._merged[k] = agg

    def _source(self, k):
        if self._updater is None and k in self._merged:
            return self._merged[k]
        return self._data[k]

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Write each key's value into ``out`` (an NDArray or a list):
        the last pushed sum, or the stored (updated) value (reference:
        kvstore.py:164)."""
        for k, o in zip(*_as_key_list(key, out)):
            src = self._source(k)._data
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                _write(t, src)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """The rows ``row_ids`` of each key's value, stacked in that order
        into dense targets (reference: kvstore.py:195)."""
        assert row_ids is not None, "row_ids is required for row_sparse_pull"
        keys, outs = _as_key_list(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        for k, o, r in zip(keys, outs,
                           rids * (len(keys) // max(len(rids), 1) or 1)):
            src = self._source(k)._data
            r_np = r.asnumpy() if isinstance(r, NDArray) else np.asarray(r)
            idx = torch.as_tensor(r_np.astype(np.int64).reshape(-1),
                                  device=src.device)
            rows = src[idx]
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                _write(t, rows)

    # -- optimizer ---------------------------------------------------------------
    def set_updater(self, updater):
        """Run ``updater(key, grad, weight)`` on every push (reference:
        kvstore.py:360)."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` in the store: "update on kvstore"
        (reference: kvstore.py:323)."""
        from . import optimizer as opt
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback on every pushed sum
        (reference: kvstore.py set_gradient_compression); a 'local' store
        refuses it, as the reference's does."""
        from .gradient_compression import GradientCompression
        if self.type not in _COMPRESSIBLE:
            raise ValueError("Gradient compression is not supported for "
                             f"this type of kvstore: {self.type!r}")
        self._compression_params = dict(compression_params)
        self._compression = GradientCompression(**self._compression_params)

    def _apply_compression(self, k, agg):
        comp = self._compression
        if comp is None or not comp.active:
            return agg
        return NDArray(comp.compress(k, agg._data))

    # -- topology ----------------------------------------------------------------
    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    @property
    def is_distributed(self):
        return "dist" in self.type

    def barrier(self):
        """Nothing to wait for in one process."""

    # -- optimizer states --------------------------------------------------------
    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The updater's states, pickled as ``optimizer.Updater`` does."""
        assert self._updater is not None, "Cannot save states for " \
            "distributed training"
        from .base import atomic_write
        with atomic_write(fname) as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Load a ``save_optimizer_states`` file (either package's) onto
        the stored values' device."""
        assert self._updater is not None, "Cannot load states for " \
            "distributed training"
        dev = next((v._data.device for v in self._data.values()), None)
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), device=dev)


def create(name="local"):
    """A KVStore by name (reference: kvstore.py:628). The ``dist*``
    types raise ``NotImplementedError`` (ROADMAP.md A11)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    valid = _LOCAL_TYPES + _DIST_TYPES
    if name not in valid:
        raise ValueError(f"unknown kvstore type {name!r}; valid: {valid}")
    return KVStore(name)
