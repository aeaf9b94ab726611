"""The ``.params`` file format: the dmlc-binary NDArray map, byte for byte
the JAX package's (counterpart of ``mxnet_tpu/ndarray/param_file.py``),
so a file written by either package loads in the other.

Format (little-endian):

file container:
    uint64  0x112 (list magic)
    uint64  0 (reserved)
    uint64  n_arrays, then per array: one record
    uint64  n_names,  then per name: uint64 length + bytes

per array (V2 record):
    uint32  0xF993fac9 (V2 magic)
    int32   storage type (0 dense / 1 row_sparse / 2 csr)
    [sparse only] storage shape: uint32 ndim + int64[ndim] (values shape)
    shape:  uint32 ndim + int64[ndim]
    int32   dev_type (1 = CPU), int32 dev_id
    int32   type flag (0 f32, 1 f64, 2 f16, 3 u8, 4 i32, 5 i8, 6 i64)
    [sparse only] per aux array: int32 aux type flag + aux shape
    raw data bytes (values for sparse)
    [sparse only] per aux array: raw bytes

Aux order: row_sparse = [indices]; csr = [indptr, indices].

The format has no flag for bfloat16. Master weights and optimizer
state are fp32, so nothing bf16 is saved; a bf16 array raises
``KeyError``, as the JAX package's flag lookup does. Arrays load to the
host (the record's device is always the CPU): dense ones as numpy
arrays, sparse ones as :class:`RowSparseStorage` / :class:`CSRStorage`.
"""
from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["RowSparseStorage", "CSRStorage", "dumps_params",
           "save_params", "load_params"]

_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_V1_MAGIC = 0xF993FAC8

_TYPE_FLAGS = {
    np.dtype("float32"): 0, np.dtype("float64"): 1, np.dtype("float16"): 2,
    np.dtype("uint8"): 3, np.dtype("int32"): 4, np.dtype("int8"): 5,
    np.dtype("int64"): 6,
}
_FLAG_TYPES = {v: k for k, v in _TYPE_FLAGS.items()}
_STYPES = {"default": 0, "row_sparse": 1, "csr": 2}


class RowSparseStorage:
    """A row-sparse array as stored: ``data`` (the rows present),
    ``indices`` (their row ids) and the logical ``shape``."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape):
        self._data = np.asarray(data)
        self._indices = np.asarray(indices, np.int64)
        self.shape = tuple(int(d) for d in shape)

    def asnumpy(self):
        out = np.zeros(self.shape, self._data.dtype)
        out[self._indices] = self._data
        return out


class CSRStorage:
    """A CSR matrix as stored: ``data``, column ``indices``, row
    ``indptr`` and the logical ``shape``."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape):
        self._data = np.asarray(data)
        self._indices = np.asarray(indices, np.int64)
        self._indptr = np.asarray(indptr, np.int64)
        self.shape = tuple(int(d) for d in shape)

    def asnumpy(self):
        out = np.zeros(self.shape, self._data.dtype)
        for r in range(self.shape[0]):
            lo, hi = self._indptr[r], self._indptr[r + 1]
            out[r, self._indices[lo:hi]] = self._data[lo:hi]
        return out


def _dense_numpy(arr):
    """A dense array (NDArray, torch tensor or array-like) as numpy on
    the host."""
    t = getattr(arr, "_data", arr) if hasattr(arr, "asnumpy") else arr
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            raise KeyError(f"{t.dtype}: the .params format has no type "
                           "flag for bfloat16")
        return t.detach().cpu().numpy()
    if hasattr(arr, "asnumpy"):
        return arr.asnumpy()
    return np.asarray(arr)


def _w_shape(out: list, shape: Sequence[int]):
    out.append(struct.pack("<I", len(shape)))
    out.append(np.asarray(shape, "<i8").tobytes())


def _r_shape(buf: memoryview, pos: int) -> Tuple[Tuple[int, ...], int]:
    (ndim,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    dims = np.frombuffer(buf, "<i8", ndim, pos)
    return tuple(int(d) for d in dims), pos + 8 * ndim


def _save_one(out: list, arr):
    """Serialize one array (dense, or a sparse one with ``stype``,
    ``_data``, ``_indices`` and, for csr, ``_indptr``)."""
    stype = getattr(arr, "stype", "default")
    out.append(struct.pack("<Ii", _V2_MAGIC, _STYPES[stype]))
    if stype == "default":
        data = _dense_numpy(arr)
        if data.ndim == 0:
            # the format has no 0-d arrays: ndim 0 means "none" and ends
            # the record, so a scalar is written as shape (1,)
            data = data.reshape(1)
        _w_shape(out, data.shape)
        out.append(struct.pack("<ii", 1, 0))  # CPU, dev_id 0
        out.append(struct.pack("<i", _TYPE_FLAGS[data.dtype]))
        out.append(np.ascontiguousarray(data).tobytes())
        return
    values = np.asarray(arr._data)
    if stype == "row_sparse":
        auxes = [np.asarray(arr._indices, "<i8")]
    else:
        auxes = [np.asarray(arr._indptr, "<i8"),
                 np.asarray(arr._indices, "<i8")]
    _w_shape(out, values.shape)          # storage shape (values)
    _w_shape(out, arr.shape)             # logical shape
    out.append(struct.pack("<ii", 1, 0))
    out.append(struct.pack("<i", _TYPE_FLAGS[values.dtype]))
    for a in auxes:
        out.append(struct.pack("<i", 6))  # aux type int64
        _w_shape(out, a.shape)
    out.append(np.ascontiguousarray(values).tobytes())
    for a in auxes:
        out.append(np.ascontiguousarray(a).tobytes())


def _load_one(buf: memoryview, pos: int):
    (magic,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if magic == _V2_MAGIC:
        (stype,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        storage_shape = None
        if stype != 0:
            storage_shape, pos = _r_shape(buf, pos)
        shape, pos = _r_shape(buf, pos)
    elif magic == _V1_MAGIC:
        stype = 0
        shape, pos = _r_shape(buf, pos)
    else:
        # legacy record: the "magic" is the ndim of a uint32 shape
        stype = 0
        ndim = magic
        dims = np.frombuffer(buf, "<u4", ndim, pos)
        shape = tuple(int(d) for d in dims)
        pos += 4 * ndim
    if not shape:
        # a "none" array: the record ends right after the shape
        return np.zeros((), np.float32), pos
    pos += 8  # device: int32 dev_type + int32 dev_id (always the host)
    (type_flag,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    dtype = _FLAG_TYPES[type_flag]
    if stype != 0:
        aux = []
        for _ in range(1 if stype == 1 else 2):
            (aflag,) = struct.unpack_from("<i", buf, pos)
            pos += 4
            ashape, pos = _r_shape(buf, pos)
            aux.append((_FLAG_TYPES[aflag], ashape))
        n_vals = int(np.prod(storage_shape)) if storage_shape else 0
        values = np.frombuffer(buf, dtype, n_vals, pos) \
            .reshape(storage_shape).copy()
        pos += n_vals * dtype.itemsize
        aux_data = []
        for adtype, ashape in aux:
            n = int(np.prod(ashape)) if ashape else 0
            aux_data.append(np.frombuffer(buf, adtype, n, pos)
                            .reshape(ashape).copy())
            pos += n * adtype.itemsize
        if stype == 1:
            return RowSparseStorage(values, aux_data[0], shape), pos
        return CSRStorage(values, aux_data[1], aux_data[0], shape), pos
    n = int(np.prod(shape))
    data = np.frombuffer(buf, dtype, n, pos).reshape(shape)
    return data.copy(), pos + n * dtype.itemsize


def dumps_params(arrays: Sequence, names: Sequence[str]) -> bytes:
    """The ``.params`` bytes of ``arrays`` under ``names`` (``[]`` for an
    unnamed list), in memory: CheckpointManager checksums these exact
    bytes before they reach the disk."""
    out: List[bytes] = [struct.pack("<QQ", _LIST_MAGIC, 0),
                        struct.pack("<Q", len(arrays))]
    for a in arrays:
        _save_one(out, a)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode("utf-8")
        out.append(struct.pack("<Q", len(b)) + b)
    return b"".join(out)


def save_params(fname: str, arrays: Sequence, names: Sequence[str]):
    """Write a ``.params`` file (through ``base.atomic_write``)."""
    from ..base import atomic_write
    with atomic_write(fname) as f:
        f.write(dumps_params(arrays, names))


def load_params(fname: str) -> Tuple[list, List[str]]:
    """Read a ``.params`` file: ``(arrays, names)``, names ``[]`` for an
    unnamed list."""
    with open(fname, "rb") as f:
        buf = memoryview(f.read())
    header, _reserved = struct.unpack_from("<QQ", buf, 0)
    if header != _LIST_MAGIC:
        raise ValueError(f"{fname}: not an MXNet NDArray file "
                         f"(bad magic {header:#x})")
    pos = 16
    (n_arr,) = struct.unpack_from("<Q", buf, pos)
    pos += 8
    arrays = []
    for _ in range(n_arr):
        arr, pos = _load_one(buf, pos)
        arrays.append(arr)
    (n_names,) = struct.unpack_from("<Q", buf, pos)
    pos += 8
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        names.append(bytes(buf[pos:pos + ln]).decode("utf-8"))
        pos += ln
    return arrays, names
