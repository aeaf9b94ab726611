"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``
and ``download`` (which raises: the port fetches nothing over the
network)."""
from __future__ import annotations

import hashlib

import torch

from .. import ndarray as nd
from ..base import MXNetError

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split an NDArray along ``batch_axis`` into ``num_slice`` pieces
    (reference: utils.py:38)."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            f"Too many slices for data with shape {data.shape}. Arguments "
            f"are num_slice={num_slice} and batch_axis={batch_axis}.")
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch size "
            f"that's multiple of {num_slice} or set even_split=False to "
            "allow uneven partitioning of data.")
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            size if i == num_slice - 1 and not even_split
                            else (i + 1) * step)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` and put slice i on ``ctx_list[i]`` (reference:
    utils.py:80)."""
    if not isinstance(data, nd.NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Scale the arrays in place so that the 2-norm of all of them
    together is at most ``max_norm``; returns that norm before scaling
    (reference: utils.py:113)."""
    assert len(arrays) > 0
    with torch.no_grad():
        total = torch.sqrt(sum(torch.sum(torch.square(a._data.float()))
                               for a in arrays))
        total_norm = float(total)
        scale = max_norm / (total_norm + 1e-8)
        if scale < 1.0:
            for a in arrays:
                a._data.mul_(scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 hex digest is ``sha1_hash`` (reference:
    utils.py:136)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """Raises: the port has no network access and fetches nothing
    (reference: utils.py:157). Place the file at its path yourself; the
    readers that need one (``data.vision``) take local files."""
    raise MXNetError(
        f"gluon.utils.download({url!r}): the port does not download over "
        "the network; place the file locally and pass its path")
