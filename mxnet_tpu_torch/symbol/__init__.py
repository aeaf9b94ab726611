"""``mxnet_tpu_torch.sym`` — the symbolic op namespace (counterpart of
``mxnet_tpu/symbol/__init__.py``).

Every registered op is a symbol-building function; missing weight-like
inputs auto-create variables named ``{name}_{input}``, as in the JAX
package, so the same model code gives the same graph and the same
JSON.
"""
from __future__ import annotations

import sys

from ..name import NameManager
from ..ops.registry import _OPS
from .op_info import op_input_names
from .symbol import Symbol, var, Variable, Group, load_json, load, _Node

__all__ = ["Symbol", "var", "Variable", "Group", "load_json", "load"]


def _node_num_outputs(opdef, attrs=None):
    """The output count; for ops whose arity depends on attributes
    (registry ``num_outputs=-1``): SliceChannel's ``num_outputs``,
    RNN's ``state_outputs``."""
    if opdef.num_outputs > 0:
        return opdef.num_outputs
    attrs = attrs or {}
    from ..ops.registry import parse_attr
    if opdef.name == "SliceChannel":
        return int(parse_attr(attrs.get("num_outputs", 1)))
    if opdef.name == "RNN" and parse_attr(attrs.get("state_outputs",
                                                    False)):
        return 3 if parse_attr(attrs.get("mode", "lstm")) == "lstm" else 2
    return 1


def _symbol_op(op_name, sym_inputs, attrs, name=None, attr=None):
    """Create an op node from symbol inputs + attrs."""
    opdef = _OPS[op_name]
    name = NameManager.current.get(name, op_name.lower())
    node = _Node(op_name, name, attrs=attrs,
                 inputs=[(s._node, s._out_index) for s in sym_inputs],
                 num_outputs=_node_num_outputs(opdef, attrs),
                 user_attrs=attr)
    from ..attribute import apply_scope_attrs
    apply_scope_attrs(node)
    return Symbol(node)


# data-like inputs are never auto-created as variables; passing None for
# one of them means "genuinely omitted". Weight-like inputs (bias, gamma,
# ...) auto-create even when passed as None.
_NEVER_AUTO_CREATE = frozenset(("data", "lhs", "rhs", "state_cell"))


def _make_sym_func(opdef):
    arg_names, aux_names = op_input_names(opdef.name)

    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        # positional symbols; None is a placeholder for an omitted input
        # and consumes its input name
        pos = [a for a in args if isinstance(a, Symbol) or a is None]
        if arg_names is None:
            return _symbol_op(opdef.name, pos,
                              {k: v for k, v in kwargs.items()
                               if v is not None}, name=name, attr=attr)
        resolved = {}
        omitted = set()
        for n in arg_names + aux_names:
            if n in kwargs and isinstance(kwargs[n], Symbol):
                resolved[n] = kwargs.pop(n)
            elif n in kwargs and kwargs[n] is None:
                kwargs.pop(n)
                if n in _NEVER_AUTO_CREATE:
                    omitted.add(n)
        it = iter(pos)
        for n in arg_names + aux_names:
            if n not in resolved:
                nxt = next(it, StopIteration)
                if nxt is StopIteration:
                    break
                if nxt is None:
                    if n in _NEVER_AUTO_CREATE:
                        omitted.add(n)
                else:
                    resolved[n] = nxt
        opname = NameManager.current.get(name, opdef.name.lower())
        no_bias = kwargs.get("no_bias", False)
        full = []
        for n in arg_names + aux_names:
            if n in resolved:
                full.append((n, resolved[n]))
            elif n in omitted or (n == "bias" and no_bias) \
                    or n in _NEVER_AUTO_CREATE:
                continue
            else:
                # 'label' is auto-created too ({name}_label), as in the
                # JAX package's softmax_label convention
                v = var(f"{opname}_{n}")
                if n in aux_names:
                    v._node.attrs["__is_aux__"] = True
                full.append((n, v))
        node_attrs = {k: v for k, v in kwargs.items() if v is not None}
        bound = [n for n, _ in full]
        if bound != (arg_names + aux_names)[:len(bound)]:
            # a middle input was omitted: eval binds by keyword
            node_attrs["__input_names__"] = bound
        return _symbol_op(opdef.name, [s for _, s in full], node_attrs,
                          name=opname, attr=attr)

    fn.__name__ = opdef.name
    fn.__doc__ = opdef.fn.__doc__
    return fn


_mod = sys.modules[__name__]
for _name in list(_OPS):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_sym_func(_OPS[_name]))
