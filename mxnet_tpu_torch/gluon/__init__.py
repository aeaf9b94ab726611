"""Gluon, the imperative high-level API (counterpart of
``mxnet_tpu/gluon/__init__.py``)."""
from . import parameter
from .parameter import Parameter, Constant, ParameterDict
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import rnn
from . import loss
from . import trainer
from .trainer import Trainer
from . import utils
from . import data
from . import model_zoo
