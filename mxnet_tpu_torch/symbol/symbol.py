"""Symbol: the declarative graph API (counterpart of
``mxnet_tpu/symbol/symbol.py``).

The same DAG of ``_Node`` objects as the JAX package, with the same
composition, naming, argument/auxiliary lists and JSON format, so a
symbol saved by either package loads in the other. Shape inference runs
each op on ``meta`` tensors (the JAX package uses ``jax.eval_shape``).
``eval_arrays`` is the eval-mode graph walk over torch tensors;
``eval_arrays_ex`` walks in either mode and returns the BatchNorm
running-statistics fold (``_bn_aux_updates``) beside the outputs.
Executors, segmented evaluation and device placement are not ported.
"""
from __future__ import annotations

import itertools
import json

import torch

from ..base import MXNetError
from ..ops import get_op, has_op
from ..ops.registry import parse_attr
from .op_info import op_input_names

__all__ = ["Symbol", "var", "Variable", "Group", "load_json", "load"]

_node_uid = itertools.count()
# ops whose result depends on the walk's mode (batch statistics)
_TRAINING_AWARE = ("BatchNorm", "_FusedBNReLUConv", "_FusedBNReLUConvK")


class _Node:
    """One graph node (op or variable)."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs",
                 "user_attrs", "uid", "_parsed")

    def __init__(self, op, name, attrs=None, inputs=(), num_outputs=1,
                 user_attrs=None):
        self.op = op  # None for variables
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)  # list of (Node, out_index)
        self.num_outputs = num_outputs
        self.user_attrs = dict(user_attrs or {})
        self.uid = next(_node_uid)
        self._parsed = None

    def op_attrs(self):
        """The op's attributes, parsed, without ``__``-internal keys
        (parsed once: the serving walk calls this per node per batch)."""
        if self._parsed is None:
            self._parsed = {k: parse_attr(v) for k, v in self.attrs.items()
                            if not k.startswith("__")}
        return self._parsed


class Symbol:
    """A node-output handle in the symbolic graph."""

    def __init__(self, node, out_index=0, outputs=None):
        self._node = node
        self._out_index = out_index
        self._group = outputs  # for Group symbols

    # -- identity ------------------------------------------------------------
    @property
    def name(self):
        if self._group is not None:
            return None
        return self._node.name

    @property
    def output_name(self):
        node = self._node
        if node.op is None:
            return node.name
        if node.num_outputs > 1:
            return f"{node.name}_output{self._out_index}"
        return f"{node.name}_output"

    def __repr__(self):
        if self._group is not None:
            names = ", ".join(s.name or "?" for s in self._group)
            return f"<Symbol group [{names}]>"
        return f"<Symbol {self.name}>"

    # -- graph walk ----------------------------------------------------------
    def _roots(self):
        return [s._node for s in self._group] if self._group is not None \
            else [self._node]

    def _topo_nodes(self):
        seen = set()
        order = []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for parent, _ in node.inputs:
                visit(parent)
            order.append(node)

        for r in self._roots():
            visit(r)
        return order

    def list_arguments(self):
        """Variable (argument) names in topological order."""
        return [n.name for n in self._topo_nodes()
                if n.op is None and not n.attrs.get("__is_aux__")]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo_nodes()
                if n.op is None and n.attrs.get("__is_aux__")]

    def list_outputs(self):
        if self._group is not None:
            return [name for s in self._group for name in s.list_outputs()]
        return [self.output_name]

    # -- composition ----------------------------------------------------------
    def __add__(self, other):
        if not isinstance(other, Symbol):
            raise MXNetError("the port adds symbols only (scalar ops are "
                             "not ported yet)")
        from . import _symbol_op
        return _symbol_op("broadcast_add", [self, other], {})

    def _output_symbols(self):
        return list(self._group) if self._group is not None else [self]

    def attr_dict(self):
        """{node_name: attrs} of the user attributes over the graph
        (``__lr_mult__``, ``__wd_mult__``, ...)."""
        return {node.name: {k: str(v) for k, v in node.user_attrs.items()}
                for node in self._topo_nodes() if node.user_attrs}

    # -- evaluation ----------------------------------------------------------
    @staticmethod
    def _apply_node_op(node, ins, training=False):
        """Dispatch one op node on its input values; returns (outputs
        tuple, the attributes the op was called with)."""
        opdef = get_op(node.op)
        attrs = node.op_attrs()
        if node.op in _TRAINING_AWARE:
            attrs = dict(attrs, training=training)
        innames = node.attrs.get("__input_names__")
        if innames:
            res = opdef.fn(**dict(zip(parse_attr(innames), ins)), **attrs)
        else:
            res = opdef.fn(*ins, **attrs)
        return (res if isinstance(res, tuple) else (res,)), attrs

    @staticmethod
    def _bn_aux_updates(node, outs, attrs, training, resolve_var):
        """[(aux var name, new value)]: the BatchNorm running-statistics
        fold ``momentum*old + (1-momentum)*batch_stat`` (the functional
        form of the reference's in-place aux update). ``resolve_var(p)``
        gives the variable's current value. The fused ops mirror
        BatchNorm's layout — moving statistics at input positions 3/4,
        batch statistics at outputs 1/2 — so the fold applies to them
        unchanged. The statistics are taken detached: the fold is not
        differentiated."""
        if not training or node.op not in _TRAINING_AWARE \
                or attrs.get("use_global_stats"):
            return []
        momentum = attrs.get("momentum", 0.9)
        ups = []
        for pos, stat_idx in ((3, 1), (4, 2)):
            p, _ = node.inputs[pos]
            if p.op is None:
                old = resolve_var(p)
                ups.append((p.name, momentum * old
                            + (1 - momentum) * outs[stat_idx].detach()))
        return ups

    def eval_arrays_ex(self, arg_arrays, training=False, preset=None,
                       capture=()):
        """Evaluate the outputs from tensors for every variable; returns
        ``(outputs, aux_updates, captured)``.

        ``training`` reaches the training-aware ops (BatchNorm and the
        fused ops take batch statistics); ``aux_updates`` maps each aux
        variable to its folded running statistic (empty in eval mode).
        ``preset``: optional ``{(id(node), out_idx): value}`` seed for
        the evaluation cache; a preset output short-circuits its
        subgraph, so variables only reachable through it need not be in
        ``arg_arrays``. ``capture``: (node, out_idx) pairs whose values
        are returned in ``captured``, in order (the implicit-loss heads'
        inputs)."""
        cache = dict(preset) if preset else {}
        aux_updates = {}

        def node_out(node, idx):
            key = (id(node), idx)
            if key in cache:
                return cache[key]
            if node.op is None:
                if node.name not in arg_arrays:
                    raise MXNetError(
                        f"missing argument '{node.name}' for eval")
                cache[key] = arg_arrays[node.name]
                return cache[key]
            ins = [node_out(p, i) for p, i in node.inputs]
            outs, attrs = Symbol._apply_node_op(node, ins, training)
            for i, o in enumerate(outs):
                cache[(id(node), i)] = o
            aux_updates.update(Symbol._bn_aux_updates(
                node, outs, attrs, training, lambda p: node_out(p, 0)))
            return cache[key]

        outputs = [node_out(s._node, s._out_index)
                   for s in self._output_symbols()]
        captured = [node_out(n, i) for n, i in capture]
        # node_out is a recursive closure, so it and its cell form a
        # reference cycle that outlives this call until the cyclic
        # collector runs; emptying the cache keeps that cycle from
        # holding every intermediate tensor (and, in training, the
        # autograd graph) alive past the step
        cache.clear()
        return outputs, aux_updates, captured

    def eval_arrays(self, arg_arrays, preset=None):
        """Evaluate the outputs in eval mode (moving statistics) — see
        ``eval_arrays_ex``."""
        return self.eval_arrays_ex(arg_arrays, preset=preset)[0]

    # -- shape inference ------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the known input
        shapes, positional in ``list_arguments`` order or by name."""
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        known = {n: tuple(s) for n, s in zip(arg_names, args)
                 if s is not None}
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes, node_out_shapes = self._propagate_shapes(known)
        arg_shapes = [shapes.get(n) for n in arg_names]
        aux_shapes = [shapes.get(n) for n in aux_names]
        out_shapes = [node_out_shapes.get((id(s._node), s._out_index))
                      for s in self._output_symbols()]
        if any(s is None for s in arg_shapes + out_shapes):
            missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
            raise MXNetError(
                f"infer_shape incomplete; unknown: {missing}. Provide input "
                "shapes for all data variables.")
        return arg_shapes, out_shapes, aux_shapes

    def _propagate_shapes(self, known):
        """Forward shape propagation from known variable shapes, shared by
        ``infer_shape`` and the rewrite passes. Returns ``(var_shapes,
        node_out_shapes)``; the latter maps ``(id(node), out_idx)`` to a
        shape for every node it could resolve."""
        shapes = dict(known)
        node_out_shapes = {}

        def try_node(node):
            if node.op is None:
                if node.name in shapes:
                    node_out_shapes[(id(node), 0)] = shapes[node.name]
                elif "__shape__" in node.attrs:
                    # Variable(shape=...) seeds only when fully known
                    s = tuple(parse_attr(node.attrs["__shape__"]))
                    if all(int(d) > 0 for d in s):
                        shapes[node.name] = s
                        node_out_shapes[(id(node), 0)] = s
                return
            in_shapes = [node_out_shapes.get((id(p), i))
                         for p, i in node.inputs]
            if any(s is None for s in in_shapes):
                hinted = _hint_param_shapes(node, in_shapes,
                                            node.op_attrs())
                for (p, i), s in (hinted or {}).items():
                    node_out_shapes[(id(p), i)] = s
                    if p.op is None:
                        shapes[p.name] = s
                in_shapes = [node_out_shapes.get((id(p), i))
                             for p, i in node.inputs]
            if any(s is None for s in in_shapes):
                return
            metas = [torch.empty(s, dtype=torch.float32, device="meta")
                     for s in in_shapes]
            try:
                outs, _ = Symbol._apply_node_op(node, metas)
            except (RuntimeError, ValueError, TypeError, IndexError,
                    KeyError, MXNetError):
                return  # unresolved, as the JAX walk leaves it
            for i, o in enumerate(outs):
                node_out_shapes[(id(node), i)] = tuple(o.shape)

        for node in self._topo_nodes():
            try_node(node)
        return shapes, node_out_shapes

    # -- serialization (MXNet JSON graph format) ------------------------------
    def tojson(self):
        """Serialize to the JSON graph format the JAX package writes."""
        nodes = self._topo_nodes()
        idx = {id(n): i for i, n in enumerate(nodes)}
        jnodes = [{
            "op": n.op if n.op is not None else "null",
            "name": n.name,
            "attrs": {k: str(v) for k, v in n.attrs.items()
                      if not k.startswith("__")},
            "inputs": [[idx[id(p)], i, 0] for p, i in n.inputs],
        } for n in nodes]
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.op is None],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[idx[id(s._node)], s._out_index, 0]
                      for s in self._output_symbols()],
            "attrs": {"mxnet_version": ["int", 10100]},
        }, indent=2)

    def save(self, fname):
        """Write the JSON graph to ``fname`` (through
        ``base.atomic_write``)."""
        from ..base import atomic_write
        with atomic_write(fname, mode="w") as f:
            f.write(self.tojson())


def _hint_param_shapes(node, in_shapes, attrs):
    """Weight/bias/aux/label shapes of layer ops from the data shape."""
    if not node.inputs or in_shapes[0] is None:
        return None
    data_shape = in_shapes[0]
    names, _ = op_input_names(node.op)
    if node.op == "FullyConnected":
        num_hidden = int(attrs.get("num_hidden"))
        in_units = 1
        for d in data_shape[1:]:
            in_units *= int(d)
        if not attrs.get("flatten", True):
            in_units = data_shape[-1]
        want = {"weight": (num_hidden, in_units), "bias": (num_hidden,)}
    elif node.op == "Convolution":
        kernel = attrs.get("kernel")
        kernel = tuple(kernel) if isinstance(kernel, (tuple, list)) \
            else (kernel,)
        num_filter = int(attrs.get("num_filter"))
        num_group = int(attrs.get("num_group", 1))
        want = {"weight": (num_filter, data_shape[1] // num_group) + kernel,
                "bias": (num_filter,)}
    elif node.op == "BatchNorm":
        c = data_shape[int(attrs.get("axis", 1))]
        want = {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
                "moving_var": (c,)}
    elif node.op in ("SoftmaxOutput", "Softmax"):
        if attrs.get("multi_output"):
            want = {"label": (data_shape[0],) + tuple(data_shape[2:])}
        else:
            want = {"label": tuple(data_shape[:-1])}
    else:
        return None
    hints = {}
    for pos, nm in enumerate(names[:len(node.inputs)]):
        if in_shapes[pos] is None and nm in want:
            hints[node.inputs[pos]] = want[nm]
    # aux inputs follow the argument inputs
    for pos in range(len(names), len(node.inputs)):
        if in_shapes[pos] is None:
            p, _ = node.inputs[pos]
            aux_nm = p.name.rsplit("_", 1)[-1]
            full = "moving_" + aux_nm if not aux_nm.startswith("moving") \
                else aux_nm
            for cand in (full, "moving_mean", "moving_var"):
                if cand in want:
                    hints[node.inputs[pos]] = want[cand]
                    break
    return hints


def var(name, attr=None, shape=None, **kwargs):
    """Create a variable symbol."""
    attrs = {}
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    node = _Node(None, name, attrs=attrs)
    if attr:
        node.user_attrs.update(attr)
    from ..attribute import apply_scope_attrs
    apply_scope_attrs(node)
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            node.user_attrs[k] = v
    return Symbol(node)


Variable = var


def Group(symbols):
    """Group outputs into one symbol."""
    flat = []
    for s in symbols:
        flat.extend(s._output_symbols())
    return Symbol(flat[0]._node, 0, outputs=flat)


def load_json(json_str):
    """Parse the JSON graph format (as written by either package)."""
    data = json.loads(json_str)
    jnodes = data["nodes"]
    nodes = []
    aux_markers = set()
    for jn in jnodes:
        if jn["op"] != "null":
            names, aux = op_input_names(jn["op"])
            if names is not None and aux:
                for pos, (nid, _i, _) in enumerate(jn["inputs"]):
                    if pos >= len(names):
                        aux_markers.add(nid)
    from . import _node_num_outputs
    for i, jn in enumerate(jnodes):
        opname = jn["op"]
        attrs = jn.get("attrs", jn.get("param", {})) or {}
        if opname == "null":
            node = _Node(None, jn["name"], attrs=dict(attrs))
            if i in aux_markers:
                node.attrs["__is_aux__"] = True
        else:
            if not has_op(opname):
                raise MXNetError(f"op '{opname}' in JSON graph is not "
                                 "registered in mxnet_tpu_torch")
            node = _Node(opname, jn["name"], attrs=dict(attrs),
                         inputs=[(nodes[nid], out_i)
                                 for nid, out_i, _ in jn["inputs"]],
                         num_outputs=_node_num_outputs(get_op(opname)))
        nodes.append(node)
    heads = data.get("heads", [[len(nodes) - 1, 0, 0]])
    outs = [Symbol(nodes[nid], out_i) for nid, out_i, _ in heads]
    return outs[0] if len(outs) == 1 else Group(outs)



def load(fname):
    """The symbol of a JSON graph file (``Symbol.save``'s, or the JAX
    package's)."""
    with open(fname) as f:
        return load_json(f.read())
