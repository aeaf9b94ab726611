"""Pass framework primitives: GraphPass, PassContext, shared rebuild
(counterpart of ``mxnet_tpu/symbol/passes/base.py``).

A pass is a non-destructive rewrite over the symbol graph: it matches
subgraphs, checks applicability, and returns a new graph sharing every
untouched node. Flag truth table (the JAX package's): ``1`` force on,
``0`` force off, ``auto`` = on when the program's device is CUDA (the
JAX package meant a TPU backend).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from ... import config
from ..symbol import Symbol, Group, _Node

__all__ = ["GraphPass", "PassContext", "resolve_flag", "flag_active",
           "rebuild_graph", "match_bn_relu_conv", "fused_bn_conv_graph",
           "embedding_skip_reason"]


def resolve_flag(value):
    """Normalize an env-flag value to ``on`` / ``off`` / ``auto``."""
    v = str(value).strip().lower()
    if v in ("1", "true", "yes", "on"):
        return "on"
    if v in ("0", "false", "no", "off", ""):
        return "off"
    return "auto"


def flag_active(resolved, device):
    """``auto`` resolves to on when ``device`` is a CUDA device."""
    if resolved == "on":
        return True
    if resolved == "off":
        return False
    return device is not None and device.type == "cuda"


class PassContext:
    """What the caller knows about the program being rewritten: the
    entry point (``tag``), its kind (``mode`` = ``train`` / ``infer`` /
    ``serving``), its device, its compute dtype, its bound shapes and
    the graph as it stands before the pass (``symbol``, set by the
    manager pass by pass for the prechecks)."""

    __slots__ = ("tag", "mode", "device", "compute_dtype", "shapes",
                 "data_names", "symbol")

    def __init__(self, tag, mode="serving", device=None, compute_dtype=None,
                 shapes=None, data_names=None, symbol=None):
        self.tag = tag
        self.mode = mode
        self.device = device
        self.compute_dtype = compute_dtype
        self.shapes = shapes or {}
        self.data_names = set(data_names) if data_names else None
        self.symbol = symbol


class GraphPass:
    """One rewrite over the symbol graph. Subclasses set ``name``,
    ``flag`` (the controlling env var; None = always on) and ``modes``,
    and implement ``apply(sym, shapes, ctx) -> (new_sym | None,
    {"sites": [...], "bailouts": [...]})``. A pass must share untouched
    nodes and keep the argument/auxiliary name set."""

    name = "?"
    flag: Optional[str] = None
    default = "auto"
    modes = ("train", "infer", "serving")

    def resolve(self):
        if self.flag is None:
            return "on"
        return resolve_flag(config.get(self.flag, self.default))

    def precheck(self, ctx):
        """Applicability from the context and the current graph: a
        string is the reason the pass is ``skipped``."""
        return None

    def apply(self, sym, shapes, ctx):  # pragma: no cover - interface
        raise NotImplementedError


_EMBEDDING_OPS = frozenset({"Embedding", "_contrib_SparseEmbedding"})
# the convolution anchors the conv-era rewrites match around; the fused
# ops count, so a later pass still sees the tower an earlier one rewrote
_CONV_ANCHOR_OPS = frozenset({"Convolution", "_FusedBNReLUConv",
                              "_FusedBNReLUConvK"})


def embedding_skip_reason(ctx):
    """``embedding_graph`` for a graph with an embedding lookup and no
    convolution (the LM): the conv-era rewrites have nothing to fuse
    there, and say so as a skip rather than a ``no_match``. A mixed graph
    (a conv tower beside a lookup) keeps every rewrite."""
    sym = ctx.symbol
    if sym is None:
        return None
    has_emb = has_conv = False
    for node in sym._topo_nodes():
        if node.op in _EMBEDDING_OPS:
            has_emb = True
        elif node.op in _CONV_ANCHOR_OPS:
            has_conv = True
    return "embedding_graph" if has_emb and not has_conv else None


def rebuild_graph(sym: Symbol, anchors: Dict[int, dict],
                  build_anchor: Callable) -> Symbol:
    """Non-destructive rebuild shared by the passes: a new symbol sharing
    every node not reachable through an anchor rewrite.

    For each anchored node ``build_anchor(node, site, map_out, outmap)``
    builds its replacement with ``map_out(parent, idx)`` for inputs,
    registers redirects ``outmap[(id(node), idx)] = (new_node, new_idx)``
    and returns the node standing in for the anchor. Unanchored nodes
    copy structurally (same uid); untouched subgraphs are shared."""
    memo: Dict[int, _Node] = {}
    outmap: Dict[tuple, tuple] = {}

    def map_out(p, i):
        if (id(p), i) in outmap:
            return outmap[(id(p), i)]
        n = build(p)
        if (id(p), i) in outmap:   # an anchor build redirected it
            return outmap[(id(p), i)]
        return n, i

    def build(node):
        if id(node) in memo:
            return memo[id(node)]
        if node.op is None:
            memo[id(node)] = node
            return node
        if id(node) in anchors:
            new = build_anchor(node, anchors[id(node)], map_out, outmap)
            memo[id(node)] = new
            return new
        new_inputs = [map_out(p, i) for p, i in node.inputs]
        if all(np_ is p and ni == i for (np_, ni), (p, i)
               in zip(new_inputs, node.inputs)):
            memo[id(node)] = node
            return node
        nn = _Node(node.op, node.name, attrs=node.attrs,
                   inputs=new_inputs, num_outputs=node.num_outputs,
                   user_attrs=node.user_attrs)
        nn.uid = node.uid
        memo[id(node)] = nn
        return nn

    new_outs = []
    for s in sym._output_symbols():
        n2, i2 = map_out(s._node, s._out_index)
        new_outs.append(Symbol(n2, i2))
    if len(new_outs) == 1 and sym._group is None:
        return new_outs[0]
    return Group(new_outs)


def match_bn_relu_conv(sym, shapes, conv_pred, site_fields):
    """Find ``BatchNorm -> [ReLU ->] Convolution`` sites — the walk both
    fusion passes share (the JAX package's match rules and bail-out
    reasons). ``conv_pred(node, attrs)`` accepts the conv;
    ``site_fields(node, attrs, data_shape, node_shapes)`` returns the
    site's extra report fields, or a string: the bail-out reason.
    Returns ``(sites: {id(conv): info}, report)``."""
    _, node_shapes = sym._propagate_shapes(dict(shapes))
    nodes = sym._topo_nodes()
    heads = {(id(s._node), s._out_index) for s in sym._output_symbols()}
    uses: Dict[tuple, int] = {}
    for n in nodes:
        for p, i in n.inputs:
            uses[(id(p), i)] = uses.get((id(p), i), 0) + 1

    def sole_feed(node, consumer):
        """node's output 0 feeds only ``consumer``, exactly once, and is
        not a graph head."""
        k = (id(node), 0)
        if k in heads or uses.get(k, 0) != 1:
            return False
        return sum(1 for p, i in consumer.inputs
                   if p is node and i == 0) == 1

    sites: Dict[int, dict] = {}
    report = {"sites": [], "bailouts": []}
    claimed = set()                  # ids of bn/relu nodes already matched
    for node in nodes:
        cattrs = node.op_attrs()
        if not conv_pred(node, cattrs):
            continue
        src, src_idx = node.inputs[0]
        if src_idx != 0 or id(src) in claimed:
            continue
        relu = None
        if src.op == "Activation" and \
                src.op_attrs().get("act_type", "relu") == "relu":
            relu = src
            bn, bn_idx = relu.inputs[0]
            if bn_idx != 0 or id(bn) in claimed:
                continue
        elif src.op in ("BatchNorm", "BatchNorm_v1"):
            bn = src
        else:
            continue

        def bail(reason):
            report["bailouts"].append({"conv": node.name, "bn": bn.name,
                                       "reason": reason})

        battrs = bn.op_attrs()
        if bn.op not in ("BatchNorm", "BatchNorm_v1"):
            continue
        if "__input_names__" in bn.attrs or len(bn.inputs) != 5:
            bail("BatchNorm with non-standard inputs")
            continue
        if int(battrs.get("axis", 1) or 1) != 1:
            bail(f"BatchNorm axis={battrs.get('axis')} (need channel "
                 "axis 1)")
            continue
        if relu is not None and not sole_feed(relu, node):
            bail("activation output has other consumers")
            continue
        if not sole_feed(bn, relu if relu is not None else node):
            bail("BatchNorm output has other consumers")
            continue
        if any(uses.get((id(bn), i), 0) or (id(bn), i) in heads
               for i in (1, 2)):
            bail("BatchNorm batch statistics are consumed in-graph")
            continue
        dshape = node_shapes.get((id(bn.inputs[0][0]), bn.inputs[0][1]))
        if dshape is None or len(dshape) != 4:
            bail(f"data shape unknown or not NCHW 4-D ({dshape})")
            continue
        fields = site_fields(node, cattrs, dshape, node_shapes)
        if isinstance(fields, str):
            bail(fields)
            continue
        claimed.update({id(bn)} | ({id(relu)} if relu is not None
                                   else set()))
        sites[id(node)] = {"bn": bn, "relu": relu, "battrs": battrs,
                           "cattrs": cattrs}
        report["sites"].append({
            "conv": node.name, "bn": bn.name,
            "activation": relu.name if relu is not None else None,
            **fields})
    return sites, report


def fused_bn_conv_graph(sym, sites, op_name, conv_attr_names):
    """Rebuild ``sym`` with each matched site's BatchNorm(+ReLU)+conv
    replaced by one ``op_name`` node: BatchNorm's five inputs, the conv
    weight (and bias), BatchNorm's attributes and the conv attributes
    named in ``conv_attr_names``. The node mirrors BatchNorm's (out,
    mean, var) outputs and keeps the conv's name and uid."""

    def build_anchor(node, m, map_out, outmap):
        bn, relu = m["bn"], m["relu"]
        battrs, cattrs = m["battrs"], m["cattrs"]
        inputs = [map_out(*bn.inputs[j]) for j in range(5)]
        inputs.append(map_out(*node.inputs[1]))
        no_bias = bool(cattrs.get("no_bias", False))
        if len(node.inputs) > 2 and not no_bias:
            inputs.append(map_out(*node.inputs[2]))
        else:
            no_bias = True
        attrs = {
            "eps": battrs.get("eps", 1e-3),
            "momentum": battrs.get("momentum", 0.9),
            "fix_gamma": battrs.get("fix_gamma", True),
            "use_global_stats": battrs.get("use_global_stats", False),
            "act_type": "relu" if relu is not None else None,
            **{k: cattrs.get(k) for k in conv_attr_names},
            "num_filter": cattrs.get("num_filter"),
            "no_bias": no_bias,
        }
        fused = _Node(op_name, node.name, attrs=attrs, inputs=inputs,
                      num_outputs=3, user_attrs=node.user_attrs)
        fused.uid = node.uid
        outmap[(id(node), 0)] = (fused, 0)
        return fused

    return rebuild_graph(sym, sites, build_anchor)
