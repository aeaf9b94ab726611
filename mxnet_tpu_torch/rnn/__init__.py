"""The legacy symbolic RNN namespace (counterpart of
``mxnet_tpu/rnn/__init__.py``; reference: python/mxnet/rnn/):
``BucketSentenceIter``, the symbolic cells with ``FusedRNNCell``, and
the Gluon modifier cells under their Gluon names. The convolutional
cells are not ported yet (ROADMAP.md)."""
from .io import BucketSentenceIter
from .rnn_cell import (RNNParams, BaseRNNCell, FusedRNNCell, RNNCell,
                       LSTMCell, GRUCell, SequentialRNNCell, DropoutCell,
                       BidirectionalCell)
from ..gluon.rnn import ZoneoutCell, ResidualCell

__all__ = ["BucketSentenceIter", "RNNParams", "BaseRNNCell",
           "FusedRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]
