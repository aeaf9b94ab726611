"""Row-sparse gradient carrier and its dedup primitives (counterpart of
``mxnet_tpu/sparse/rowsparse.py``).

The gradient of an embedding lookup touches only the rows that appear
in the batch, so the fused step carries it as sorted unique row ids and
their summed rows instead of a dense ``(vocab, dim)`` tensor.

Everything here has a static shape and reads nothing back to the host,
so it runs inside a captured CUDA graph: ``dedup_rows`` always returns
``capacity`` slots (by default the id count ``n``, the case of no
duplicate), and unused slots carry the sentinel id ``num_rows`` with
zero rows. The dedup is a stable sort of the ids, a first-occurrence
mask and its ``cumsum`` (each sorted id's slot), a scatter of the sorted
ids into a ``(capacity,)`` buffer pre-filled with the sentinel, and the
inverse permutation (each occurrence's slot); no ``unique``, ``nonzero``
or boolean indexing, whose sizes depend on the data.

Sums are deterministic: every segment-sum is ``embedding_dense_backward``
over the slot ids, which adds each slot's occurrences in a fixed order
without atomics on the card (the same op as ``F.embedding``'s
backward, so a routed table's rows equal the dense table gradient's rows
bit for bit). An index outside the table cannot be dropped by the
scatter as JAX's ``mode="drop"`` does (on the card it is a device-side
assert that ends the context): it is sent to one extra slot past the
end, which is then cut off.
"""
from __future__ import annotations

import torch

__all__ = ["RowSparseRows", "dedup_rows", "segment_rows", "scatter_rows",
           "densify"]


class RowSparseRows:
    """A rows-touched-only gradient for one ``(num_rows, dim)`` table.

    ``ids``: int64 ``(capacity,)``, sorted unique row ids padded at the
    tail with the sentinel ``num_rows``. ``rows``: ``(capacity, dim)``,
    the summed gradient rows aligned with ``ids`` (zero at sentinel
    slots)."""

    __slots__ = ("ids", "rows", "num_rows")

    def __init__(self, ids, rows, num_rows):
        self.ids = ids
        self.rows = rows
        self.num_rows = int(num_rows)

    def __repr__(self):
        return (f"RowSparseRows(capacity={self.ids.shape[0]}, "
                f"dim={self.rows.shape[-1]}, num_rows={self.num_rows})")


def _sum_into(values, index, n):
    """``out[index[i]] += values[i]`` into ``n`` rows, in a fixed order;
    ``index`` must lie in ``[0, n)``."""
    return torch.ops.aten.embedding_dense_backward(
        values, index, n, -1, False)


def _checked_capacity(ids_flat, cap):
    """Raise when ``cap`` is below the batch's unique id count. Counting
    them reads the ids: done on the CPU, and on the card only outside a
    capture (one sync, and only for an explicit capacity below ``n``)."""
    if ids_flat.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    uniq = int(torch.unique(ids_flat).numel())
    if uniq > cap:
        raise ValueError(
            f"dedup_rows: capacity={cap} is below the {uniq} unique ids in "
            f"the batch; the largest ids' gradient rows would be silently "
            f"dropped. Use capacity >= the unique count (the default, "
            f"capacity=n={ids_flat.numel()}, is always safe).")


def dedup_rows(ids, values, num_rows, capacity=None):
    """Deduplicate ``(ids, values)`` pairs into sorted unique row sums.

    ``ids``: integer (or float, truncated) tensor of any shape with ``n``
    elements; ``values``: ``ids.shape + (dim,)`` rows, one per
    occurrence. Returns :class:`RowSparseRows` with ``capacity`` slots
    (default ``n``): duplicates summed, ids sorted, the tail slots the
    sentinel ``num_rows`` with zero rows. ``capacity`` must be at least
    the batch's unique id count; below ``n`` it is checked where that
    needs no read of a captured stream (see ``_checked_capacity``), and
    inside a capture the largest ids beyond it are dropped, as in the
    JAX package's jit."""
    ids_flat = ids.reshape(-1).to(torch.int64)
    n = ids_flat.shape[0]
    dim = values.shape[-1]
    vals = values.reshape(n, dim)
    cap = int(capacity) if capacity is not None else n
    if capacity is not None and cap < n:
        _checked_capacity(ids_flat, cap)
    srt, perm = torch.sort(ids_flat, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=ids_flat.device)
    first[1:] = srt[1:] != srt[:-1]
    # slot of each sorted id; ids past the capacity go to slot ``cap``,
    # which is cut off below
    slot_sorted = (torch.cumsum(first, 0) - 1).clamp_max_(cap)
    uids = torch.full((cap + 1,), num_rows, dtype=torch.int64,
                      device=ids_flat.device)
    uids.scatter_(0, slot_sorted, srt)
    slot_of = torch.empty_like(slot_sorted).scatter_(0, perm, slot_sorted)
    rows = _sum_into(vals, slot_of, cap + 1)
    return RowSparseRows(uids[:cap], rows[:cap], num_rows)


def segment_rows(values, segment_ids, num_segments):
    """Sum ``values`` rows into ``num_segments`` buckets; segment ids
    outside ``[0, num_segments)`` contribute nothing (the dedup's
    building block, registered as ``_contrib_sparse_segment_sum``)."""
    n = int(num_segments)
    seg = segment_ids.reshape(-1).to(torch.int64)
    vals = values.reshape(seg.shape[0], -1)
    seg = torch.where((seg >= 0) & (seg < n), seg, n)
    out = _sum_into(vals, seg, n + 1)[:n]
    return out.reshape((n,) + tuple(values.shape[segment_ids.dim():]))


def _table_index(ids, num_rows):
    """Row index of each id as JAX's ``.at[ids]`` with ``mode="drop"``
    reads it: ``[-num_rows, -1]`` wraps, anything else out of range goes
    to ``num_rows`` (a row past the end)."""
    idx = ids.to(torch.int64)
    idx = torch.where(idx < 0, idx + num_rows, idx)
    return torch.where((idx >= 0) & (idx < num_rows), idx, num_rows)


def scatter_rows(table, rs: RowSparseRows, scale=1.0):
    """``table[rs.ids] += scale * rs.rows`` with the sentinel and other
    out-of-range slots dropped: a new table."""
    n = table.shape[0]
    add = _sum_into((scale * rs.rows).to(table.dtype),
                    _table_index(rs.ids, n), n + 1)[:n]
    return table + add


def densify(rs: RowSparseRows, dim=None):
    """The dense ``(num_rows, dim)`` gradient (the op-level backward's
    contract and a test oracle; the fused step never builds it)."""
    d = int(dim) if dim is not None else rs.rows.shape[-1]
    n = rs.num_rows
    return _sum_into(rs.rows.reshape(-1, d), _table_index(rs.ids, n),
                     n + 1)[:n]
