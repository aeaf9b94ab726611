"""Residual-chain fusion: BN(+ReLU)→conv of any geometry (counterpart
of ``mxnet_tpu/symbol/passes/residual_fusion.py``; same match rules,
site records and bail-out reasons).

Any ``BatchNorm → [ReLU →] Convolution`` site the 1×1 pass did not
claim (3×3, strided, padded, and tile-bailed 1×1s) rewrites onto
``_FusedBNReLUConvK`` (ops/fused_bn_conv.py): on CUDA its forward is the
hand-written BN-apply prologue kernel followed by the convolution. Runs
after pallas_fusion so the fused 1×1 kernel keeps its sites.
"""
from __future__ import annotations

from .base import (GraphPass, embedding_skip_reason, fused_bn_conv_graph,
                   match_bn_relu_conv)

__all__ = ["ResidualFusionPass"]

_CONV_OPS = ("Convolution", "Convolution_v1")


def _conv_general_matches(node, attrs) -> bool:
    """Any-geometry ungrouped NCHW convolution with plain positional
    inputs (data, weight[, bias])."""
    if node.op not in _CONV_OPS:
        return False
    if "__input_names__" in node.attrs:
        return False
    if len(node.inputs) not in (2, 3):
        return False
    return (int(attrs.get("num_group", 1) or 1) == 1
            and attrs.get("layout") in (None, "NCHW"))


class ResidualFusionPass(GraphPass):
    name = "residual_fusion"
    flag = "MXTPU_PASS_RESIDUAL_FUSION"
    modes = ("train", "infer", "serving")

    def precheck(self, ctx):
        return embedding_skip_reason(ctx)

    def apply(self, sym, shapes, ctx):
        def site_fields(node, cattrs, dshape, node_shapes):
            return {"kernel": cattrs.get("kernel"),
                    "stride": cattrs.get("stride"),
                    "batch": int(dshape[0]), "k": int(dshape[1])}

        sites, report = match_bn_relu_conv(sym, shapes,
                                           _conv_general_matches,
                                           site_fields)
        if not sites:
            return None, report
        graph = fused_bn_conv_graph(
            sym, sites, "_FusedBNReLUConvK",
            ("kernel", "stride", "pad", "dilate", "num_group"))
        return graph, report
