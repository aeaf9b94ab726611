"""Vision data (counterpart of ``mxnet_tpu/gluon/data/vision/``):
datasets and transforms."""
from .datasets import *  # noqa: F401,F403
from . import transforms  # noqa: F401
