"""SparseEmbedding: the lookup op with a rows-only backward (counterpart
of ``mxnet_tpu/sparse/embedding.py``).

- :func:`sparse_embedding` is the op behind ``_contrib_SparseEmbedding``:
  the forward is ``Embedding``'s (``ops/shape_ops.embedding``: ids in
  ``[-n, -1]`` wrap, other out-of-range ids give NaN rows), and the
  backward deduplicates to unique rows (``dedup_rows``) before it builds
  the dense ``(vocab, dim)`` gradient that autograd's contract asks for.
  The Executor, ``Module(fused=False)`` and the imperative path take it.
- :func:`find_sites` is the graph scan of the fused Module step, which
  routes a site's gradient around the dense table gradient: it
  differentiates a zero perturbation of the gathered rows and applies
  the deduplicated rows with the lazy rule (``module/fused.py``).
"""
from __future__ import annotations

import torch

from .rowsparse import dedup_rows, densify

__all__ = ["sparse_embedding", "SparseSite", "find_sites"]


class _SparseEmbedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, weight):
        from ..ops.shape_ops import embedding
        ctx.save_for_backward(data)
        ctx.vocab = weight.shape[0]
        return embedding(data, weight)

    @staticmethod
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None
        rs = dedup_rows(data, g, num_rows=ctx.vocab)
        return None, densify(rs).to(g.dtype)


def sparse_embedding(data, weight):
    """``weight[data]`` with the JAX package's semantics; the weight's
    gradient is built from deduplicated rows (ids take none)."""
    return _SparseEmbedding.apply(data, weight)


class SparseSite:
    """One SparseEmbedding node the fused step can route: its ids input
    is a data variable and its weight a parameter variable."""

    __slots__ = ("node", "weight_name", "ids_name", "vocab", "dim")

    def __init__(self, node, weight_name, ids_name, vocab, dim):
        self.node = node
        self.weight_name = weight_name
        self.ids_name = ids_name
        self.vocab = int(vocab)
        self.dim = int(dim)

    def describe(self):
        """Hashable description for program keys and reports."""
        return (self.node.name, self.weight_name, self.ids_name,
                self.vocab, self.dim)


def find_sites(sym, param_names, input_names, shapes=None,
               fallbacks=None):
    """The SparseEmbedding nodes of ``sym`` the fused step can route
    row-sparse: the ids input is a variable in ``input_names`` and the
    weight input a variable in ``param_names``; ``shapes`` (name ->
    shape) gives vocab and dim where the node's attrs do not.

    A routed table takes no gradient but its sites' rows, so a table is
    routed only when every consumer of its variable is a qualifying
    site reading it at the weight position (several sites may share a
    table: their rows merge). A weight that feeds any other node (tied
    input and output embeddings, a dense op) or is itself an output
    stays on the dense path; each such site is appended to
    ``fallbacks`` (if given) as ``{"weight", "node", "reason"}``."""
    from ..ops.registry import parse_attr
    params = set(param_names)
    inputs = set(input_names)
    nodes = sym._topo_nodes()
    consumers = {}
    for node in nodes:
        for pos, (p, _) in enumerate(node.inputs):
            if p.op is None and p.name in params:
                consumers.setdefault(p.name, []).append((node, pos))
    out_vars = {s._node.name for s in sym._output_symbols()
                if s._node.op is None}
    candidates = []
    for node in nodes:
        if node.op != "_contrib_SparseEmbedding" or len(node.inputs) != 2:
            continue
        ids_node, _ = node.inputs[0]
        w_node, _ = node.inputs[1]
        if ids_node.op is not None or w_node.op is not None:
            continue
        if ids_node.name not in inputs or w_node.name not in params:
            continue
        attrs = {k: parse_attr(v) for k, v in node.attrs.items()
                 if not k.startswith("__")}
        vocab = attrs.get("input_dim")
        dim = attrs.get("output_dim")
        if (vocab is None or dim is None) and shapes is not None:
            wshape = shapes.get(w_node.name)
            if wshape is not None and len(wshape) == 2:
                vocab = vocab if vocab is not None else wshape[0]
                dim = dim if dim is not None else wshape[1]
        if vocab is None or dim is None:
            continue
        candidates.append(SparseSite(node, w_node.name, ids_node.name,
                                     vocab, dim))
    qualifying = {id(s.node) for s in candidates}
    sites = []
    for s in candidates:
        tied = s.weight_name in out_vars or any(
            id(n) not in qualifying or pos != 1
            for n, pos in consumers.get(s.weight_name, ()))
        if tied:
            if fallbacks is not None:
                fallbacks.append({"weight": s.weight_name,
                                  "node": s.node.name,
                                  "reason": "shared_weight"})
            continue
        sites.append(s)
    return sites
