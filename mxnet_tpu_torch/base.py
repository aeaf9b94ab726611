"""Base helpers of the port (counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

import contextlib
import os
import tempfile

import torch

__all__ = ["MXNetError", "torch_dtype", "atomic_write", "host_numpy"]


class MXNetError(RuntimeError):
    """Error raised by the framework (``mxnet.base.MXNetError``'s role)."""


_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "half": torch.float16,
}


def torch_dtype(dtype):
    """A ``torch.dtype`` from a dtype name or a ``torch.dtype``; None
    stays None (no compute-dtype cast)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).lower().replace("torch.", "")
    if name not in _DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r}; known: "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


# probed once at import (single-threaded): os.umask is a set-and-read
# global, and atomic_write runs concurrently on checkpoint writer
# threads, where a per-call probe and restore would race
_UMASK = os.umask(0)
os.umask(_UMASK)


@contextlib.contextmanager
def atomic_write(fname, mode="wb"):
    """Crash-safe file write: a temp file in the target directory, then
    flush, ``fsync``, ``os.rename`` into place and a directory fsync. A
    process killed at any byte of the write leaves the previous file
    untouched: the rename is the commit point. Every checkpoint-shaped
    write of the port (``nd.save``, ``.params``, ``-symbol.json``,
    optimizer ``.states``, CheckpointManager files) goes through here.

    Yields the file object to write to; the ``ckpt_write``
    fault-injection site (faultinject.py) can arm a byte-budgeted
    failure on it (post-commit tearing is the CheckpointManager's
    ``ckpt_truncate`` site)."""
    from . import faultinject
    fname = os.fspath(fname)
    d = os.path.dirname(os.path.abspath(fname))
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix="." + os.path.basename(fname) + ".",
                               suffix=".tmp")
    # mkstemp creates 0600; give the file the permissions a plain open()
    # would, so shared checkpoint directories stay readable
    os.chmod(tmp, 0o666 & ~_UMASK)
    committed = False
    try:
        with os.fdopen(fd, mode) as f:
            yield faultinject.guarded_write(f, path=fname)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, fname)
        committed = True
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    finally:
        if not committed and os.path.exists(tmp):
            os.unlink(tmp)


def host_numpy(tensors):
    """Numpy copies of ``tensors`` on the host. Device tensors go through
    pinned buffers with asynchronous copies, ordered after the work
    already queued on the current stream, and one wait for them all (a
    blocking copy each would wait once per tensor)."""
    out = [None] * len(tensors)
    pending = []
    for i, t in enumerate(tensors):
        t = t.detach()
        if t.device.type == "cpu":
            out[i] = t.numpy().copy()
            continue
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        pending.append((i, buf))
    if pending:
        torch.cuda.current_stream(tensors[pending[0][0]].device) \
            .synchronize()
    for i, buf in pending:
        out[i] = buf.numpy()
    return out
