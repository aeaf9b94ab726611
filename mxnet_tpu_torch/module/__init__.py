"""Modules: symbolic training (counterpart of ``mxnet_tpu/module``)."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule"]
