"""The port's operator set: every op a ResNet symbol needs in serving,
plus the two fused ops the rewrite passes substitute."""
from .registry import get_op, has_op, register_op, parse_attr
from . import nn, elemwise, shape_ops, fused_bn_conv

__all__ = ["get_op", "has_op", "register_op", "parse_attr",
           "nn", "elemwise", "shape_ops", "fused_bn_conv"]
