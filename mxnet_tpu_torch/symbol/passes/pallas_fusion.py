"""The BN(+ReLU)→1×1-conv fusion pass (counterpart of
``mxnet_tpu/symbol/passes/pallas_fusion.py``): the framework adapter of
``symbol/fusion.py``'s matcher, behind ``MXTPU_PALLAS_FUSION``. The name
stays ``pallas_fusion`` so both packages' pass reports line up; here
the fused op runs the hand-written CUDA kernel."""
from __future__ import annotations

from .base import GraphPass, embedding_skip_reason

__all__ = ["PallasFusionPass"]


class PallasFusionPass(GraphPass):
    name = "pallas_fusion"
    flag = "MXTPU_PALLAS_FUSION"
    modes = ("train", "infer", "serving")

    def precheck(self, ctx):
        return embedding_skip_reason(ctx)

    def apply(self, sym, shapes, ctx):
        from ..fusion import fuse_symbol
        new_sym, rep = fuse_symbol(sym, shapes)
        return (new_sym if rep["sites"] else None), rep
