"""Elementwise ops (counterpart of ``mxnet_tpu/ops/elemwise.py``): the
residual add."""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("broadcast_add")
def broadcast_add(lhs, rhs, **kw):
    return torch.add(lhs, rhs)
