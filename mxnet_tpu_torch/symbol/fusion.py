"""Graph-rewrite fusion: BN(+ReLU)→1×1-conv onto the fused kernel
(counterpart of ``mxnet_tpu/symbol/fusion.py``; the match rules, site
records and bail-out reasons are the JAX package's).

It pattern-matches

    BatchNorm → Activation(act_type=relu) → Convolution(1×1, stride 1,
    pad 0, dilate 1, groups 1, NCHW)

and the bare ``BatchNorm → 1×1 Convolution`` variant, and substitutes
the ``_FusedBNReLUConv`` op (ops/fused_bn_conv.py), whose forward is the
hand-written fused BN+ReLU+1×1-conv kernel on CUDA. Match rules (each
failure bails that site, recorded in the report):

- conv kernel (1,1), stride (1,1), pad (0,0), dilate (1,1), num_group 1,
  layout NCHW, 4-D data;
- the BN (and ReLU, when present) intermediate is consumed ONLY by the
  next node in the pattern and is not a graph output;
- BN axis is 1 (channel) and its batch-stat outputs have no graph
  consumers;
- shapes are known and pass ``select_conv_tiles`` — the TPU kernel's
  tile rule, kept so both packages rewrite the same sites.

The rewrite is non-destructive: it returns a new graph sharing
unaffected nodes, with the same argument/auxiliary names.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..ops.fused_bn_conv import conv_tile_failure, select_conv_tiles
from .passes.base import fused_bn_conv_graph, match_bn_relu_conv
from .symbol import Symbol

__all__ = ["fuse_symbol"]


def _norm_tup(v) -> Optional[tuple]:
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return (int(v), int(v))
    return tuple(int(x) for x in v)


def _conv_matches(node, attrs) -> bool:
    """1×1/s1/p0/d1 ungrouped NCHW convolution with plain positional
    inputs (data, weight[, bias])."""
    if node.op not in ("Convolution", "Convolution_v1"):
        return False
    if "__input_names__" in node.attrs:
        return False
    if len(node.inputs) not in (2, 3):
        return False
    return (_norm_tup(attrs.get("kernel")) == (1, 1)
            and _norm_tup(attrs.get("stride")) in (None, (1, 1))
            and _norm_tup(attrs.get("pad")) in (None, (0, 0))
            and _norm_tup(attrs.get("dilate")) in (None, (1, 1))
            and int(attrs.get("num_group", 1) or 1) == 1
            and attrs.get("layout") in (None, "NCHW"))


def fuse_symbol(sym: Symbol, shapes: Dict[str, tuple]
                ) -> Tuple[Symbol, dict]:
    """Rewrite matched BN(+ReLU)→1×1-conv subgraphs of ``sym`` onto the
    fused ``_FusedBNReLUConv`` op. ``shapes`` maps variable names
    (arguments and aux) to concrete shapes, so the tile bail-out is
    decided here.

    Returns ``(new_sym, report)``; when nothing matched, ``new_sym`` is
    ``sym`` itself. The report lists rewritten sites and per-site
    bail-out reasons."""

    def site_fields(node, cattrs, dshape, node_shapes):
        b, c, h, w = dshape
        nf = cattrs.get("num_filter")
        wshape = node_shapes.get((id(node.inputs[1][0]),
                                  node.inputs[1][1]))
        out_c = int(nf) if nf is not None else (
            int(wshape[0]) if wshape else None)
        if out_c is None:
            return "num_filter unknown"
        tiles = select_conv_tiles(out_c, h * w)
        if tiles is None:
            return conv_tile_failure(out_c, h * w)
        return {"batch": int(b), "spatial": int(h * w), "k": int(c),
                "n": out_c, "bo_tile": tiles[0], "bs_tile": tiles[1]}

    sites, report = match_bn_relu_conv(sym, shapes, _conv_matches,
                                       site_fields)
    if not sites:
        return sym, report
    return fused_bn_conv_graph(sym, sites, "_FusedBNReLUConv", ()), report
