"""Gluon layers (counterpart of ``mxnet_tpu/gluon/nn/``): those ResNet
v1/v2 and the tests use."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403

from . import activations, basic_layers, conv_layers

__all__ = (activations.__all__ + basic_layers.__all__ +  # noqa: F405
           conv_layers.__all__)  # noqa: F405
