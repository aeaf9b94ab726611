"""Shape ops (counterpart of ``mxnet_tpu/ops/shape_ops.py``)."""
from __future__ import annotations

from .registry import register_op


@register_op("Flatten", aliases=["flatten"])
def flatten(data, **kw):
    return data.reshape(data.shape[0], -1)
