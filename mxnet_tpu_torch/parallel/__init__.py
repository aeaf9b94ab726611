"""Parallel training pieces of the port (counterpart of
``mxnet_tpu/parallel``): the functional optimizer rules and
``TrainStep``, the training step of a Gluon block, on one device (the
mesh and its collectives are ROADMAP.md A10)."""
from . import functional_opt, step
from .step import TrainStep, softmax_ce_loss, l2_loss

__all__ = ["functional_opt", "step", "TrainStep", "softmax_ce_loss",
           "l2_loss"]
