"""Activation layers (counterpart of
``mxnet_tpu/gluon/nn/activations.py``): ``Activation``."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """relu / sigmoid / tanh / softrelu / softsign (reference:
    activations.py:24)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._act_type})"
