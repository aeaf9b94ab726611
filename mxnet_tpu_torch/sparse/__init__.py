"""Sparse embedding subsystem (counterpart of ``mxnet_tpu/sparse/``).

A rows-only gradient carrier with static shapes (:mod:`.rowsparse`),
the ``SparseEmbedding`` op with a deduplicated backward and the fused
step's site scan (:mod:`.embedding`). The fused Module step
(``module/fused.py``) routes the detected sites through these
primitives; the lazy row rules live in ``parallel/functional_opt.py``.
The JAX package's mesh-sharded tables (``sparse/sharding.py``) are not
ported (ROADMAP.md queue A, item 10).

Observability: ``sparse::`` metrics in the telemetry registry
(``touched_rows`` / ``ids_total`` / ``steps`` counters, ``dedup_ratio``
/ ``gather_bytes`` / ``scatter_bytes`` gauges of the last step,
``sites`` and ``dense_fallback``) and the ``sparse_report()`` view.

The per-step id statistics need the ids on the host, so
``MXTPU_SPARSE_STATS`` gates them: ``1`` on (a CUDA-only ids tensor is
then read back, a sync of the step), ``0`` off, ``auto`` (the default)
on where the feed has a host copy of the ids (a CPU tensor or array in
the feed, or the host batch a ``DataPipeline`` staged from) and off for
ids that live only on a CUDA device: ``auto`` never reads a device
tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from .rowsparse import (RowSparseRows, dedup_rows, segment_rows,
                        scatter_rows, densify)
from .embedding import sparse_embedding, SparseSite, find_sites
from ..telemetry import registry as _treg

__all__ = ["RowSparseRows", "dedup_rows", "segment_rows", "scatter_rows",
           "densify", "sparse_embedding", "SparseSite", "find_sites",
           "stats_enabled", "note_step_ids", "sparse_report"]


def stats_mode():
    """``MXTPU_SPARSE_STATS`` as ``"on"``, ``"off"`` or ``"auto"``."""
    from .. import config as _config
    v = str(_config.get("MXTPU_SPARSE_STATS", "auto")).strip().lower()
    if v in ("1", "true", "yes", "on"):
        return "on"
    if v in ("0", "false", "no", "off"):
        return "off"
    return "auto"


def stats_enabled():
    """Whether per-step id statistics may be taken at all (``1`` or
    ``auto``); under ``auto`` only host copies of the ids are read
    (:func:`note_step_ids`)."""
    return stats_mode() != "off"


def _host_ids(v, force):
    """The ids ``v`` as a flat numpy array when they can be read without
    touching the card (or ``force``), else None."""
    if isinstance(v, torch.Tensor):
        if v.device.type != "cpu" and not force:
            return None
        return v.detach().cpu().numpy().reshape(-1)
    if hasattr(v, "_data"):          # an NDArray
        return _host_ids(v._data, force)
    return np.asarray(v).reshape(-1)


def note_step_ids(sites, feed, host=None):
    """Record one step's sparse telemetry from its ids: total ids, unique
    rows touched, the dedup ratio, and the gather / scatter bytes (the
    rows read and the rows written). ``host`` ({name: host tensor or
    array}) is the host copy of the feed where one exists; a device
    tensor is read only when ``MXTPU_SPARSE_STATS=1``."""
    force = stats_mode() == "on"
    ids_total = touched = gather_b = scatter_b = 0
    for site in sites:
        arr = None
        if host is not None and site.ids_name in host:
            arr = _host_ids(host[site.ids_name], force)
        if arr is None and site.ids_name in feed:
            arr = _host_ids(feed[site.ids_name], force)
        if arr is None:
            continue
        arr = arr.astype(np.int64)
        ids_total += arr.size
        u = int(np.unique(arr).size)
        touched += u
        gather_b += arr.size * site.dim * 4
        scatter_b += u * site.dim * 4
    if ids_total == 0:
        return
    _treg.counter("sparse::steps").inc()
    _treg.counter("sparse::ids_total").inc(ids_total)
    _treg.counter("sparse::touched_rows").inc(touched)
    _treg.gauge("sparse::dedup_ratio").set(touched / float(ids_total))
    _treg.gauge("sparse::gather_bytes").set(gather_b)
    _treg.gauge("sparse::scatter_bytes").set(scatter_b)


def _collect(reset):
    snap = _treg.snapshot(reset=reset, prefix="sparse::")
    return {name.split("::", 1)[1]: vals.get("value")
            for name, vals in snap.items()}


sparse_report = _treg.collector_view("sparse", _collect)
