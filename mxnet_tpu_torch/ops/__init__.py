"""The port's operator set, under the JAX package's module names: the
nn layers and heads, the elementwise, shape, reduction, creation and
ordering, linear-algebra and sampling ops, the optimizer updates, the
surface utilities, the two fused ops the rewrite passes substitute, and
the decode-attention kernel's wrapper of the decode serving programs,
and the contrib detection and vision ops with the wrappers of their
greedy NMS and matching kernels (``nms``). The image, quantization and
eager sparse-storage ops of the JAX package are not here yet (ROADMAP
A5)."""
from .registry import get_op, has_op, register_op, parse_attr
from . import nn, elemwise, shape_ops, reduce, fused_bn_conv
from . import decode_attention, optimizer_ops
from . import creation, linalg, random_ops, surface, nms, contrib

__all__ = ["get_op", "has_op", "register_op", "parse_attr",
           "nn", "elemwise", "shape_ops", "reduce", "fused_bn_conv",
           "decode_attention", "optimizer_ops", "creation", "linalg",
           "random_ops", "surface", "nms", "contrib"]
