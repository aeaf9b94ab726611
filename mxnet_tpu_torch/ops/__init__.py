"""The port's operator set: the ops a ResNet symbol needs in serving
and training, the two fused ops the rewrite passes substitute, and the
elementwise, shape and reduction ops behind NDArray and Gluon; and the
decode-attention kernel's wrapper of the decode serving programs."""
from .registry import get_op, has_op, register_op, parse_attr
from . import nn, elemwise, shape_ops, reduce, fused_bn_conv
from . import decode_attention

__all__ = ["get_op", "has_op", "register_op", "parse_attr",
           "nn", "elemwise", "shape_ops", "reduce", "fused_bn_conv",
           "decode_attention"]
