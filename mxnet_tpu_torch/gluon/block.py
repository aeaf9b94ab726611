"""Gluon Block / HybridBlock / SymbolBlock (counterpart of
``mxnet_tpu/gluon/block.py``; reference: python/mxnet/gluon/block.py).

Blocks, name scopes and parameter collection are the JAX package's, so
the same model code gives the same parameter names. ``hybridize()``
makes a HybridBlock called outside another block's staged forward run
as captured programs (``cached_op.CachedOp``): its forward, and under
``autograd.record()`` its backward, as CUDA graphs on the card, keyed
and counted by ``compile/`` (kind ``gluon``); on the CPU the same path
runs eagerly and still keys its programs. The JAX package stages the
same forward into one ``jax.jit`` (block.py:453-550).
``HybridBlock.staged_forward(training)`` is that forward as a function
of (parameter tensors, input tensors, generator) returning the outputs
and the BatchNorm running-statistics writes (``stateful_write``)
instead of applying them (``parallel.TrainStep`` differentiates and
captures it). Deferred initialization runs on the first forward, which
is eager, as the JAX package's is. A HybridBlock called on a ``Symbol``
builds the graph with ``F = sym``; ``export`` writes that graph and the
parameters as ``<path>-symbol.json`` and ``<path>-NNNN.params``,
``SymbolBlock`` runs such a graph as a block, and
``save_parameters`` / ``load_parameters`` (structural names) and
``save_params`` / ``load_params`` (prefixed names) write and read the
``.params`` format of ``ndarray/param_file.py``, both packages'.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd
from .. import ndarray as nd_module
from .. import random as _random
from ..ndarray.ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "stateful_write"]


class _BlockScope:
    """Name manager of Blocks (reference: block.py:30-85)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """The prefix and the ParameterDict of a new Block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                from ..name import NameManager
                prefix = NameManager.current.get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        from ..name import Prefix
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        if self._name_scope is not None:
            self._name_scope.__exit__(ptype, value, trace)
            self._name_scope = None
        _BlockScope._current.value = self._old_scope


class Block:
    """Base class of layers and models (reference: block.py:123)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def __repr__(self):
        modstr = "\n".join(f"  ({key}): {_indent(repr(block), 2)}"
                           for key, block in self._children.items())
        return f"{self.__class__.__name__}(\n{modstr}\n)"

    def __setattr__(self, name, value):
        """Register parameters and child blocks (reference:
        block.py:180)."""
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)) and \
                    not isinstance(existing, type(value)):
                raise TypeError(
                    f"Changing attribute type for {self.name} from "
                    f"{type(existing)} to {type(value)} is not allowed.")
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            assert name not in self._reg_params or \
                self._reg_params[name] is value, \
                "Overriding Parameter attribute %s is not allowed." % name
            self._reg_params[name] = value
            self._params._params.setdefault(value.name, value)
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """A name-scope context manager (reference: block.py:237)."""
        return self._scope

    @property
    def params(self):
        """This Block's own ParameterDict (reference: block.py:245)."""
        return self._params

    def collect_params(self, select=None):
        """The ParameterDict of this Block and all its children
        (reference: block.py:252)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret._params.update({name: value for name, value in
                                self.params.items() if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def apply(self, fn):
        """Apply ``fn`` to every child, then to this block (reference:
        block.py:318)."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from .. import initializer as _init
        init = init if init is not None else _init.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    # -- parameter files ------------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        """{structural name ("0.weight", "features.1.gamma"): Parameter}
        (reference: block.py _collect_params_with_prefix)."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename):
        """Write the parameters under their structural names, which do
        not depend on the block's prefix (reference: block.py:200)."""
        params = self._collect_params_with_prefix()
        nd_module.save(filename, {k: v._check_and_get()
                                  for k, v in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Read a ``save_parameters`` file: each value is copied into its
        parameter's storage (a parameter not initialized yet takes it as
        its initial value, on ``ctx`` when given), so captured programs
        read the loaded values (reference: block.py:214)."""
        loaded = nd_module.load(filename)
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise IOError(f"Parameter '{name}' is missing in file "
                                  f"'{filename}'")
        for name, v in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise IOError(
                        f"Parameter '{name}' loaded from file '{filename}' "
                        "is not present in this Block")
                continue
            set_param(params[name], v, ctx)

    def save_params(self, filename):
        """The prefixed-name form of ``save_parameters`` (reference:
        block.py save_params)."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Read a ``save_params`` file (reference: block.py load_params)."""
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, self.prefix)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print each block and its parameter count (reference: block.py
        summary; the JAX package's table)."""
        rows = []

        def visit(block, depth):
            for child in block._children.values():
                n = sum(int(np.prod(p.shape)) for p in child.params.values()
                        if p.shape_is_known())
                rows.append(("  " * depth + child.__class__.__name__
                             + f"({child.name})", n))
                visit(child, depth + 1)

        total = sum(int(np.prod(p.shape))
                    for p in self.collect_params().values()
                    if p.shape_is_known())
        rows.append((self.__class__.__name__ + f"({self.name})", total))
        visit(self, 1)
        width = max(len(r[0]) for r in rows) + 4
        lines = [f"{'Layer':<{width}}Params", "-" * (width + 8)]
        lines += [f"{name:<{width}}{n}" for name, n in rows]
        print("\n".join(lines))


def set_param(param, value, ctx=None):
    """Set ``param`` from a loaded NDArray: copied into its storage when
    it has one, else its initial value on ``ctx`` (or the deferred
    init's device)."""
    if param._data is not None:
        value = NDArray(value._data.to(param._data._data.device))
    elif ctx is not None:
        from ..context import as_context
        ctx = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        value = NDArray(value._data.to(as_context(ctx).device))
        if param._deferred_init:
            init, _, default_init, data = param._deferred_init
            param._deferred_init = (init, [as_context(ctx)], default_init,
                                    data)
    param.set_data(value)


def _indent(s, num_spaces):
    lines = s.split("\n")
    if len(lines) == 1:
        return s
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line for line in lines)


class _TraceState:
    """The parameter writes of one staged forward (thread-local)."""

    _current = threading.local()

    def __init__(self):
        self.writes = OrderedDict()   # Parameter -> tensor

    @staticmethod
    def active():
        return getattr(_TraceState._current, "value", None)


def stateful_write(param, value):
    """Write ``value`` (a tensor or NDArray) into Parameter ``param``:
    in place, outside the graph, in an eager forward; inside a staged
    forward the write is recorded and returned by it instead (the JAX
    package's ``stateful_write``, block.py:233-248)."""
    if isinstance(value, NDArray):
        value = value._data
    tr = _TraceState.active()
    if tr is not None:
        tr.writes[param] = value
        return
    with torch.no_grad():
        param._check_and_get()._data.copy_(value)


_sym_trace_vars = threading.local()
# set while a hybridized block's first, eager forward runs
_eager_init = threading.local()


class HybridBlock(Block):
    """A Block whose ``hybrid_forward`` is written against an op
    namespace ``F``: ``nd`` on NDArrays, ``sym`` on Symbols (reference:
    block.py:376)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}
        self._cached_op = None
        self._cached_param_list = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Run this block (and its HybridBlock children, each where it is
        called outside a parent's staged forward) as captured programs
        (see ``cached_op``). ``static_alloc`` / ``static_shape`` are
        accepted for the reference's signature: a CUDA graph plans its
        memory and shapes statically anyway."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._clear_cached_op()
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _clear_cached_op(self):
        """Drop the captured programs (reference: block.py:347)."""
        self._cached_op = None
        self._cached_param_list = None

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def register_child(self, block, name=None):
        super().register_child(block, name)
        self._clear_cached_op()

    def infer_shape(self, *args):
        """Complete parameter shapes from the inputs (deferred init).
        Built-in layers override it."""
        raise NotImplementedError(
            f"{self.__class__.__name__} has parameters with unknown shape. "
            "Override infer_shape() to support deferred initialization, or "
            "construct with fully-specified shapes.")

    def infer_type(self, *args):
        """Give this block's parameters the dtype of the first input
        (reference: block.py:372)."""
        for p in self._reg_params.values():
            p.dtype = args[0].dtype

    def _gather_params(self):
        return {name: p.data() for name, p in self._reg_params.items()}

    def _get_param_list(self):
        """Every parameter of the block and its children, sorted by name
        (the JAX package's ``_get_param_list``)."""
        if self._cached_param_list is None:
            self._cached_param_list = [
                p for _, p in sorted(self.collect_params().items())]
        return self._cached_param_list

    def _staged_call(self, param_list, pvals, args, training, generator):
        """The forward on NDArray ``args`` with tensors ``pvals`` standing
        in for ``param_list``'s parameters: ``(outputs, [(Parameter,
        write)])``. It runs in training or predict mode as ``training``
        says, recording for autograd when torch's grad mode is on, its
        random ops drawing from ``generator`` (None: the device's); the
        BatchNorm writes are returned, not applied, and the Parameters
        keep their tensors."""
        saved = [p._check_and_get()._data for p in param_list]
        tr = _TraceState()
        prev_tr = _TraceState.active()
        _TraceState._current.value = tr
        prev_r = autograd.set_recording(torch.is_grad_enabled())
        prev_t = autograd.set_training(training)
        try:
            for p, v in zip(param_list, pvals):
                p._data._data = v
            with _random.use_generator(generator):
                out = self.forward(*args)
        finally:
            autograd.set_training(prev_t)
            autograd.set_recording(prev_r)
            _TraceState._current.value = prev_tr
            for p, v in zip(param_list, saved):
                p._data._data = v
        return out, list(tr.writes.items())

    def staged_forward(self, training=True):
        """The forward as a function ``staged(pvals, args, generator=None)
        -> (outputs, writes)`` (the counterpart of ``_build_jit``,
        block.py:447-550): ``pvals`` are tensors standing in for
        ``_get_param_list()``'s parameters (all initialized), ``args``
        the input tensors; see ``_staged_call``. ``outputs`` is a tuple
        of tensors, ``writes`` the BatchNorm running-statistics writes
        as ``[(Parameter, tensor)]``. A list among the outputs (a
        layer's states) is flattened into them."""
        block = self
        param_list = self._get_param_list()

        def staged(pvals, args, generator=None):
            out, writes = block._staged_call(
                param_list, pvals, [NDArray(a) for a in args], training,
                generator)
            flat = []
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                flat.extend(o if isinstance(o, (tuple, list)) else (o,))
            return tuple(o._data for o in flat), writes

        staged.param_list = param_list
        return staged

    def _finish_deferred(self, *args):
        self.infer_shape(*args)
        for p in self._reg_params.values():
            if p._deferred_init:
                p._finish_deferred_init()

    def __call__(self, *args):
        from ..symbol.symbol import Symbol
        if args and isinstance(args[0], Symbol):
            return self.forward(*args)
        if self._active and _TraceState.active() is None and \
                not getattr(_eager_init, "active", False):
            return self._call_cached(*args)
        return self.forward(*args)

    def _call_cached(self, *args):
        """The captured call (``cached_op.CachedOp``); the first call
        with a deferred parameter runs the eager forward, which
        initializes it (the JAX package's :500-509)."""
        from .cached_op import CachedOp
        try:
            for p in self._get_param_list():
                p._check_and_get()
        except DeferredInitializationError:
            # children run eagerly inside this forward too
            prev = getattr(_eager_init, "active", False)
            _eager_init.active = True
            try:
                out = self.forward(*args)
            finally:
                _eager_init.active = prev
            self._clear_cached_op()
            return out
        if self._cached_op is None:
            self._cached_op = CachedOp(self)
        return self._cached_op(*args)

    def forward(self, x, *args):
        """Gather this block's params and call ``hybrid_forward``
        (reference: block.py:541). On a Symbol the parameters become
        variables named by their full names, those with ``grad_req``
        "null" marked auxiliary, one node per Parameter in a trace."""
        from ..symbol.symbol import Symbol
        if isinstance(x, Symbol):
            from .. import symbol as sym_module
            return self.hybrid_forward(sym_module, x, *args,
                                       **self._symbol_params())
        try:
            params = self._gather_params()
        except DeferredInitializationError:
            self._finish_deferred(x, *args)
            params = self._gather_params()
        return self.hybrid_forward(nd_module, x, *args, **params)

    def _symbol_params(self):
        from ..symbol.symbol import var
        cache = getattr(_sym_trace_vars, "vars", None)
        if cache is None:
            # a direct net(symbol) call outside _trace_symbol: one node
            # per Parameter name on this thread
            if not hasattr(_sym_trace_vars, "fallback"):
                _sym_trace_vars.fallback = {}
            cache = _sym_trace_vars.fallback
        params = {}
        for name, p in self._reg_params.items():
            v = cache.get(p.name)
            if v is not None and bool(v._node.attrs.get("__is_aux__")) != \
                    (p.grad_req == "null"):
                v = None   # its grad_req changed since: a fresh node
            if v is None:
                v = var(p.name)
                if p.grad_req == "null":
                    v._node.attrs["__is_aux__"] = True
                cache[p.name] = v
            params[name] = v
        return params

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # -- the symbolic graph and export ---------------------------------------
    def _trace_symbol(self, num_inputs=1):
        """This block's graph in predict mode, on inputs named ``data``
        (one) or ``data0`` ... (several), as the reference's export
        names them (reference: block.py _get_graph)."""
        from ..symbol.symbol import Group, var
        inputs = [var("data")] if num_inputs == 1 else \
            [var(f"data{i}") for i in range(num_inputs)]
        _sym_trace_vars.vars = {}
        prev_t = autograd.set_training(False)
        prev_r = autograd.set_recording(False)
        try:
            out = self.forward(*inputs)
        finally:
            autograd.set_recording(prev_r)
            autograd.set_training(prev_t)
            _sym_trace_vars.vars = None
        return Group(list(out)) if isinstance(out, tuple) else out

    def export(self, path, epoch=0, num_inputs=1):
        """Write ``<path>-symbol.json`` and ``<path>-NNNN.params`` (the
        pair ``Module.load`` / ``SymbolBlock`` / a ``Predictor`` take;
        reference: block.py:590). Parameters are keyed ``arg:`` or
        ``aux:`` by the traced graph's arguments and auxiliary states,
        by ``grad_req`` for one the graph does not use."""
        sym = self._trace_symbol(num_inputs=num_inputs)
        sym.save(f"{path}-symbol.json")
        aux_names = set(sym.list_auxiliary_states())
        arg_names = set(sym.list_arguments())
        params = {}
        for name, p in self.collect_params().items():
            if name in aux_names:
                key = "aux:" + name
            elif name in arg_names:
                key = "arg:" + name
            else:
                key = ("aux:" if p.grad_req == "null" else "arg:") + name
            params[key] = p._check_and_get()
        nd_module.save(f"{path}-{epoch:04d}.params", params)
        return sym


class SymbolBlock(HybridBlock):
    """A block that runs a Symbol graph (reference: block.py:599): its
    arguments other than ``inputs`` become parameters named as in the
    graph (no prefix), its auxiliary states parameters with
    ``grad_req`` "null". In training mode the BatchNorm nodes fold their
    running statistics into those parameters. Hybridized, it runs
    captured like any HybridBlock."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        self._outputs = outputs
        self._inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self._params = ParameterDict("", shared=self._params._shared
                                     if params is None else params)
        input_names = {i.name for i in self._inputs}
        for name in outputs.list_arguments():
            if name not in input_names:
                self._reg_params[name] = self.params.get(
                    name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            self._reg_params[name] = self.params.get(
                name, grad_req="null", allow_deferred_init=True)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock from an exported ``-symbol.json`` and its
        ``.params`` file (reference: block.py SymbolBlock.imports)."""
        from .. import symbol as sym_module
        sym = sym_module.load(symbol_file)
        names = [input_names] if isinstance(input_names, str) \
            else list(input_names)
        block = SymbolBlock(sym, [sym_module.var(n) for n in names])
        if param_file is not None:
            block.collect_params().load(param_file, ctx=ctx)
        return block

    def infer_shape(self, *args):
        """Parameter shapes from the graph's shape inference on the
        inputs' shapes."""
        known = {i.name: a.shape for i, a in zip(self._inputs, args)}
        shapes, _ = self._outputs._propagate_shapes(known)
        for name, p in self._reg_params.items():
            if name in shapes:
                p._infer_shape(shapes[name])

    def forward(self, *args):
        arrays = {i.name: a._data for i, a in zip(self._inputs, args)}
        try:
            params = self._gather_params()
        except DeferredInitializationError:
            self._finish_deferred(*args)
            params = self._gather_params()
        for name, p in params.items():
            arrays[name] = p._data
        training = autograd.is_training()
        with torch.set_grad_enabled(autograd.is_recording()):
            outs, aux_updates, _ = self._outputs.eval_arrays_ex(
                arrays, training=training)
        for name, value in aux_updates.items():
            stateful_write(self._reg_params[name], value.detach())
        res = [NDArray(o) for o in outs]
        return res[0] if len(res) == 1 else tuple(res)

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError
