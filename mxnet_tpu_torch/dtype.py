"""Dtype name resolution (counterpart of ``mxnet_tpu/dtype.py``): names,
numpy dtypes, torch dtypes and mshadow codes to ``torch.dtype``, and
back to the numpy dtype an NDArray reports."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_dtype", "numpy_dtype"]

_ALIASES = {
    "float32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "float16": torch.float16,
    "half": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "uint32": torch.uint32, "bool": torch.bool,
}
# mshadow type codes (reference: include/mxnet/base.h / mshadow base.h)
_CODE2DTYPE = {0: torch.float32, 1: torch.float64, 2: torch.float16,
               3: torch.uint8, 4: torch.int32, 5: torch.int8, 6: torch.int64}
_TORCH2NP = {torch.float32: np.float32, torch.float64: np.float64,
             torch.float16: np.float16, torch.uint8: np.uint8,
             torch.int8: np.int8, torch.int32: np.int32,
             torch.int64: np.int64, torch.uint32: np.uint32,
             torch.bool: np.bool_}


def resolve_dtype(dtype):
    """A ``torch.dtype`` from a name, a numpy dtype or type, a torch
    dtype or an mshadow code; None is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, int):
        return _CODE2DTYPE[dtype]
    if isinstance(dtype, str) and dtype.replace("torch.", "") in _ALIASES:
        return _ALIASES[dtype.replace("torch.", "")]
    name = np.dtype(dtype).name
    if name not in _ALIASES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _ALIASES[name]


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype; bfloat16, which numpy lacks,
    stays ``torch.bfloat16``."""
    t = resolve_dtype(dtype)
    return np.dtype(_TORCH2NP[t]) if t in _TORCH2NP else t

