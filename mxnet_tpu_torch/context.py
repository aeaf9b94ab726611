"""Device contexts (counterpart of ``mxnet_tpu/context.py``).

``cpu()`` and ``gpu(i)`` are ``Context`` objects that name a torch device
(``cpu``, ``cuda:i``) and work as ``with`` scopes, like the reference's
(``with mx.cpu(): ...``). Without a scope, ``current_context()`` is
``gpu(0)`` and raises when CUDA is absent: there is no silent switch to
the CPU. Entry points also take a ``torch.device`` or a device string.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus",
           "default_device", "as_device", "as_context"]


class Context:
    """A device context: ``device_type`` is ``cpu`` or ``gpu``; usable
    as a ``with`` scope that sets ``current_context()``."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in self.devstr2type:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_typeid = self.devstr2type[device_type]
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    @property
    def device(self):
        """The ``torch.device`` this context names."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return isinstance(other, Context) and \
            self.device_typeid == other.device_typeid and \
            self.device_id == other.device_id

    def __str__(self):
        return f"{self.device_type}({self.device_id})"

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count()


def current_context():
    """The context of the innermost ``with`` scope, else ``gpu(0)``;
    raises when there is no scope and this process sees no CUDA
    device."""
    ctx = getattr(Context._default_ctx, "value", None)
    if ctx is not None:
        return ctx
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' (or "
            "mxnet_tpu_torch.cpu()), or run inside `with mx.cpu():`, to "
            "run on the CPU")
    return gpu(0)


def default_device():
    """The torch device of ``current_context()``."""
    return current_context().device


def as_device(device):
    """A ``torch.device`` from None (the current context), a
    ``Context``, a string or a ``torch.device``."""
    if device is None:
        return default_device()
    if isinstance(device, Context):
        return device.device
    return torch.device(device)


def as_context(device):
    """A ``Context`` from None (the current context), a ``Context``, a
    string or a ``torch.device``."""
    if device is None:
        return current_context()
    if isinstance(device, Context):
        return device
    d = torch.device(device)
    if d.type == "cpu":
        return cpu()
    if d.type == "cuda":
        return gpu(0 if d.index is None else d.index)
    raise MXNetError(f"unsupported device {device!r}")
