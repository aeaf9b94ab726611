"""Modules: symbolic training (counterpart of ``mxnet_tpu/module``)."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
