"""Device contexts (counterpart of ``mxnet_tpu/context.py``): ``cpu()``
is ``torch.device("cpu")`` and ``gpu(i)`` is ``cuda:i``. Entry points
take an explicit device; without one they run on ``cuda:0`` and raise
when CUDA is absent — there is no silent switch to the CPU."""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "as_device"]


def cpu(device_id=0):
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


def default_device():
    """``cuda:0``; raises when this process sees no CUDA device."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' (or "
            "mxnet_tpu_torch.cpu()) to run on the CPU")
    return gpu(0)


def as_device(device):
    """A ``torch.device`` from None (the default device), a string or a
    ``torch.device``."""
    if device is None:
        return default_device()
    return torch.device(device)
