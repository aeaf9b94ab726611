"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``;
reference: python/mxnet/gluon/block.py).

Blocks, name scopes and parameter collection are the JAX package's, so
the same model code gives the same parameter names. ``hybridize()``
keeps its flags but runs the same eager forward: the JAX package stages
the whole forward into one ``jax.jit`` (block.py:453-541), which has no
counterpart yet (a captured CUDA graph is future work). Deferred
initialization runs on the first eager forward, as the JAX package's
does. ``export``, ``SymbolBlock`` and parameter files are not ported
yet.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from .. import ndarray as nd_module
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


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

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


def _indent(s, num_spaces):
    lines = s.split("\n")
    if len(lines) == 1:
        return s
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line for line in lines)


class HybridBlock(Block):
    """A Block whose ``hybrid_forward`` is written against an op
    namespace ``F`` (reference: block.py:376); here ``F`` is always
    ``nd``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Keeps the flags; the forward stays eager (see the module
        docstring)."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def infer_shape(self, *args):
        """Complete parameter shapes from the inputs (deferred init).
        Built-in layers override it."""
        raise NotImplementedError(
            f"{self.__class__.__name__} has parameters with unknown shape. "
            "Override infer_shape() to support deferred initialization, or "
            "construct with fully-specified shapes.")

    def _gather_params(self):
        return {name: p.data() for name, p in self._reg_params.items()}

    def _finish_deferred(self, *args):
        self.infer_shape(*args)
        for p in self._reg_params.values():
            if p._deferred_init:
                p._finish_deferred_init()

    def forward(self, x, *args):
        """Gather this block's params and call ``hybrid_forward``
        (reference: block.py:541)."""
        try:
            params = self._gather_params()
        except DeferredInitializationError:
            self._finish_deferred(x, *args)
            params = self._gather_params()
        return self.hybrid_forward(nd_module, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
