"""Gluon RNN layers and cells (counterpart of
``mxnet_tpu/gluon/rnn/__init__.py``). The convolutional cells
(``conv_rnn_cell.py``) are not ported yet (ROADMAP.md)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403

from . import rnn_cell, rnn_layer

__all__ = rnn_cell.__all__ + rnn_layer.__all__  # noqa: F405
