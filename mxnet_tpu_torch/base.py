"""Base helpers of the port (counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

import torch

__all__ = ["MXNetError", "torch_dtype"]


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
