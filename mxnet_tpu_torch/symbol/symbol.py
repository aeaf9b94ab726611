"""Symbol: the declarative graph API (counterpart of
``mxnet_tpu/symbol/symbol.py``).

The same DAG of ``_Node`` objects as the JAX package, with the same
composition, naming, argument/auxiliary lists and JSON format, so a
symbol saved by either package loads in the other. Shape inference runs
each op on ``meta`` tensors (the JAX package uses ``jax.eval_shape``).
``eval_arrays`` is the eval-mode graph walk over torch tensors;
``eval_arrays_ex`` walks in either mode and returns the BatchNorm
running-statistics fold (``_bn_aux_updates``) beside the outputs.
``simple_bind`` / ``bind`` give a bound ``executor.Executor``; ``eval``
binds and runs a forward. Segmented evaluation and device placement
(``group2ctx``) are not ported.
"""
from __future__ import annotations

import itertools
import json

import numpy as np
import torch

from ..base import MXNetError
from ..ops import get_op, has_op
from ..ops.registry import parse_attr
from .op_info import op_input_names

__all__ = ["Symbol", "var", "Variable", "Group", "load_json", "load"]

_node_uid = itertools.count()
# ops whose result depends on the walk's mode: batch statistics (the BN
# ops, whose running statistics the walk folds) and dropout
_BN_OPS = ("BatchNorm", "_FusedBNReLUConv", "_FusedBNReLUConvK")
_TRAINING_AWARE = _BN_OPS + ("Dropout", "RNN")


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

    def get_internals(self):
        """A group over every node output."""
        outs = []
        for node in self._topo_nodes():
            for i in range(node.num_outputs):
                outs.append(Symbol(node, i))
        return Group(outs)

    def get_children(self):
        if not self._node.inputs:
            return None
        return Group([Symbol(p, i) for p, i in self._node.inputs])

    def __getitem__(self, index):
        if self._group is not None:
            if isinstance(index, str):
                for s in self._group:
                    if index in (s.name, s.output_name):
                        return s
                raise ValueError(f"no output named {index}")
            return self._group[index]
        if isinstance(index, str):
            return self.get_internals()[index]
        outs = [Symbol(self._node, i)
                for i in range(self._node.num_outputs)]
        return outs[index]

    def __iter__(self):
        if self._group is not None:
            return iter(self._group)
        return iter([Symbol(self._node, i)
                     for i in range(self._node.num_outputs)])

    def __len__(self):
        if self._group is not None:
            return len(self._group)
        return self._node.num_outputs

    # -- composition ----------------------------------------------------------
    def _binop(self, op_name, other, rev=False):
        from . import _symbol_op
        if isinstance(other, Symbol):
            a, b = (other, self) if rev else (self, other)
            return _symbol_op(op_name, [a, b], {})
        scalar_ops = {
            "broadcast_add": "_plus_scalar", "broadcast_sub":
            ("_rminus_scalar" if rev else "_minus_scalar"),
            "broadcast_mul": "_mul_scalar", "broadcast_div":
            ("_rdiv_scalar" if rev else "_div_scalar"),
            "broadcast_power":
            ("_rpower_scalar" if rev else "_power_scalar"),
        }
        return _symbol_op(scalar_ops[op_name], [self], {"scalar": other})

    def __add__(self, other):
        return self._binop("broadcast_add", other)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop("broadcast_sub", other)

    def __rsub__(self, other):
        return self._binop("broadcast_sub", other, rev=True)

    def __mul__(self, other):
        return self._binop("broadcast_mul", other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop("broadcast_div", other)

    def __rtruediv__(self, other):
        return self._binop("broadcast_div", other, rev=True)

    def __pow__(self, other):
        return self._binop("broadcast_power", other)

    def __neg__(self):
        from . import _symbol_op
        return _symbol_op("negative", [self], {})

    def _unop(self, op_name, **attrs):
        from . import _symbol_op
        return _symbol_op(op_name, [self],
                          {k: v for k, v in attrs.items() if v is not None})

    def reshape(self, *shape, **kwargs):
        if "shape" in kwargs:
            shape = kwargs.pop("shape")
        elif len(shape) == 1:
            shape = shape[0]
        if isinstance(shape, int):
            shape = (shape,)
        return self._unop("Reshape", shape=tuple(shape), **kwargs)

    def flatten(self):
        return self._unop("Flatten")

    def transpose(self, axes=None):
        return self._unop("transpose", axes=axes)

    def swapaxes(self, dim1, dim2):
        return self._unop("SwapAxis", dim1=dim1, dim2=dim2)

    def expand_dims(self, axis):
        return self._unop("expand_dims", axis=axis)

    def squeeze(self, axis=None):
        return self._unop("squeeze", axis=axis)

    def astype(self, dtype):
        return self._unop("Cast", dtype=str(np.dtype(dtype)))

    def sum(self, axis=None, keepdims=False):
        return self._unop("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._unop("mean", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._unop("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._unop("min", axis=axis, keepdims=keepdims)

    def clip(self, a_min, a_max):
        return self._unop("clip", a_min=a_min, a_max=a_max)

    def slice_axis(self, axis, begin, end):
        return self._unop("slice_axis", axis=axis, begin=begin, end=end)

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
        if not training or node.op not in _BN_OPS \
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
                       capture=(), internals=None):
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
        inputs). ``internals``: a dict filled with every op node's
        outputs by output name (the Monitor's interpreted walk)."""
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
                if internals is not None:
                    suffix = "_output" if i == 0 else f"_output{i}"
                    internals[node.name + suffix] = o
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

    def infer_type(self, *args, **kwargs):
        """Every argument, output and aux state is fp32, as in the JAX
        package."""
        dt = np.float32
        return ([dt] * len(self.list_arguments()),
                [dt] * len(self._output_symbols()),
                [dt] * len(self.list_auxiliary_states()))

    # -- binding -------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Allocate fp32 arrays for the shapes inferred from ``kwargs``
        on ``ctx`` (default ``cuda:0``) and bind them: gradients unless
        ``grad_req`` is ``'null'``. Arrays named in ``shared_buffer`` are
        taken from it (the rest go into it)."""
        from ..executor import Executor
        from ..ndarray import NDArray
        from ..context import as_device
        if group2ctx:
            raise NotImplementedError("group2ctx placement is not ported")
        dev = as_device(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)

        def _alloc(shape):
            return NDArray(torch.zeros(shape, dtype=torch.float32,
                                       device=dev))

        args = {}
        for n, sh in zip(self.list_arguments(), arg_shapes):
            if shared_buffer is not None and n in shared_buffer and \
                    tuple(shared_buffer[n].shape) == tuple(sh):
                args[n] = shared_buffer[n]
            else:
                args[n] = _alloc(sh)
                if shared_buffer is not None:
                    shared_buffer[n] = args[n]
        reqs = grad_req if isinstance(grad_req, dict) else \
            {n: grad_req for n in args}
        grads = {n: _alloc(sh) for n, sh in zip(self.list_arguments(),
                                                 arg_shapes)
                 if reqs.get(n, "null") != "null"}
        aux = {n: _alloc(sh) for n, sh in
               zip(self.list_auxiliary_states(), aux_shapes)}
        return Executor(self, dev, args, grads, grad_req, aux)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind the given arrays (dicts by name, or lists in
        ``list_arguments`` / ``list_auxiliary_states`` order)."""
        from ..executor import Executor
        from ..context import as_device
        if group2ctx:
            raise NotImplementedError("group2ctx placement is not ported")
        arg_names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.list_auxiliary_states(), aux_states))
        return Executor(self, as_device(ctx), args or {}, args_grad,
                        grad_req, aux_states or {})

    def eval(self, ctx=None, **kwargs):
        """Bind ``kwargs`` with no gradient and run one forward."""
        return self.bind(ctx, kwargs, grad_req="null").forward()

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
    elif node.op in ("BatchNorm", "LayerNorm"):
        c = data_shape[int(attrs.get("axis",
                                     1 if node.op == "BatchNorm" else -1))]
        want = {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
                "moving_var": (c,)}
    elif node.op in ("Embedding", "_contrib_SparseEmbedding"):
        want = {"weight": (int(attrs.get("input_dim")),
                           int(attrs.get("output_dim")))}
    elif node.op in ("SoftmaxOutput", "Softmax", "SVMOutput"):
        if attrs.get("multi_output"):
            want = {"label": (data_shape[0],) + tuple(data_shape[2:])}
        else:
            want = {"label": tuple(data_shape[:-1])}
    elif node.op in ("LinearRegressionOutput", "LogisticRegressionOutput",
                     "MAERegressionOutput"):
        want = {"label": tuple(data_shape)}
    elif node.op == "RNN":
        # the flat parameter vector and the (L*dirs, N, H) states from
        # the (T, N, C) data (reference: rnn-inl.h GetRnnParamSize)
        from ..ops.nn import rnn_param_size
        h = int(attrs.get("state_size"))
        layers = int(attrs.get("num_layers", 1))
        bi = bool(attrs.get("bidirectional", False))
        st = (layers * (2 if bi else 1), data_shape[1], h)
        want = {"parameters": (rnn_param_size(attrs.get("mode", "lstm"),
                                              layers, data_shape[2], h,
                                              bi),),
                "state": st, "state_cell": st}
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


def var(name, attr=None, shape=None, init=None, **kwargs):
    """Create a variable symbol. ``init`` (an initializer, its name or
    its ``dumps()``) goes into the ``__init__`` attribute that
    ``Module.init_params`` dispatches on."""
    attrs = {}
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    node = _Node(None, name, attrs=attrs)
    if attr:
        node.user_attrs.update(attr)
    if init is not None:
        node.user_attrs["__init__"] = init if isinstance(init, str) \
            else init.dumps()
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
                         num_outputs=_node_num_outputs(get_op(opname),
                                                       attrs))
        nodes.append(node)
    heads = data.get("heads", [[len(nodes) - 1, 0, 0]])
    outs = [Symbol(nodes[nid], out_i) for nid, out_i, _ in heads]
    return outs[0] if len(outs) == 1 else Group(outs)



def load(fname):
    """The symbol of a JSON graph file (``Symbol.save``'s, or the JAX
    package's)."""
    with open(fname) as f:
        return load_json(f.read())
