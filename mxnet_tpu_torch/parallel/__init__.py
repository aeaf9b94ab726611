"""Parallel training pieces of the port (counterpart of
``mxnet_tpu/parallel``): so far only the functional optimizer rules the
one-device fused step applies."""
from . import functional_opt

__all__ = ["functional_opt"]
