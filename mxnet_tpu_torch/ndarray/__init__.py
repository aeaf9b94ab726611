"""``mxnet_tpu_torch.nd`` — the imperative op namespace (counterpart of
``mxnet_tpu/ndarray/__init__.py``).

Every op of the port's registry becomes a function over NDArrays
(``nd.<op>``), as the reference generates them from its op registry
(python/mxnet/ndarray/register.py); ops registered later
(``operator.register_kernel``) are added when they register. Creation
functions put their result on ``ctx``, the current context when None.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..context import as_context
from ..dtype import resolve_dtype
from ..ops.registry import _OPS
from ..symbol.op_info import op_input_names
from .ndarray import NDArray, array, empty, waitall, _invoke_fn, _invoke_op

__all__ = ["NDArray", "array", "empty", "waitall", "zeros", "ones", "full",
           "arange", "moveaxis", "onehot_encode", "save", "load", "random"]


def _make_op_func(opdef):
    arg_names, aux_names = op_input_names(opdef.name)
    names = list(arg_names or ()) + list(aux_names or ())

    def fn(*args, **kwargs):
        ctx = kwargs.pop("ctx", None)
        args = list(args)
        while args and args[-1] is None:
            args.pop()
        # inputs passed by keyword (data=x, bias=b) take their declared
        # positions after the positional ones
        for n in names[len(args):]:
            if isinstance(kwargs.get(n), NDArray):
                args.append(kwargs.pop(n))
            else:
                break
        nd_args = []
        for a in args:
            if isinstance(a, (list, tuple)) and a and \
                    isinstance(a[0], NDArray):
                nd_args.extend(a)
            elif a is None:
                raise TypeError(f"{opdef.name}: cannot bind a non-trailing "
                                "None input; pass optional inputs by "
                                "keyword")
            else:
                nd_args.append(a)
        if not any(isinstance(a, NDArray) for a in nd_args):
            dev = as_context(ctx).device
            nd_args = [NDArray(torch.as_tensor(np.asarray(a), device=dev))
                       for a in nd_args]
            if not nd_args:
                # a creation op or sampler: it builds on the context
                kwargs["device"] = dev
        return _invoke_op(opdef.name, nd_args, kwargs)

    fn.__name__ = opdef.name
    fn.__doc__ = opdef.fn.__doc__
    return fn


def _add_op(name):
    setattr(sys.modules[__name__], name, _make_op_func(_OPS[name]))


for _name in list(_OPS):
    if _name.isidentifier() and _name not in globals():
        _add_op(_name)


def _shape(shape):
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def zeros(shape, ctx=None, dtype="float32", **kw):
    return NDArray(torch.zeros(_shape(shape), dtype=resolve_dtype(dtype),
                               device=as_context(ctx).device))


def ones(shape, ctx=None, dtype="float32", **kw):
    return NDArray(torch.ones(_shape(shape), dtype=resolve_dtype(dtype),
                              device=as_context(ctx).device))


def full(shape, val, ctx=None, dtype="float32", **kw):
    return NDArray(torch.full(_shape(shape), val, dtype=resolve_dtype(dtype),
                              device=as_context(ctx).device))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=resolve_dtype(dtype),
                     device=as_context(ctx).device)
    if repeat != 1:
        t = t.repeat_interleave(repeat)
    return NDArray(t)


def moveaxis(data, source, destination):
    """``data`` with axis ``source`` moved to ``destination``."""
    return _invoke_fn(lambda d: torch.movedim(d, source, destination),
                      [data])


def onehot_encode(indices, out):
    """Writes the one-hot rows of ``indices`` (depth ``out.shape[1]``)
    into ``out`` and returns it."""
    res = _invoke_op("one_hot", [indices], {"depth": out.shape[1]})
    out._data = res._data.to(out._data.dtype)
    return out


# -- serialization. Two formats by extension, as in the JAX package:
#    *.params  -> the dmlc-binary NDArray map (param_file.py), byte for
#                 byte the JAX package's
#    otherwise -> a numpy .npz container with the names under
#                 ``__mxnet_tpu_names__``
def _split_save_arg(data):
    if isinstance(data, (NDArray, torch.Tensor, np.ndarray)):
        return [data], None
    if isinstance(data, (list, tuple)):
        return list(data), None
    if isinstance(data, dict):
        return list(data.values()), list(data.keys())
    raise TypeError("save requires an NDArray, a list or a dict")


def save(fname, data):
    """Save an NDArray, a list or a {name: array} dict (arrays may also
    be torch tensors or numpy arrays) through ``base.atomic_write``."""
    import os
    from ..base import atomic_write
    from .param_file import _dense_numpy, save_params
    fname = os.fspath(fname)
    arrs, names = _split_save_arg(data)
    if fname.endswith(".params"):
        save_params(fname, arrs, names if names is not None else [])
        return
    names = names if names is not None else [str(i)
                                             for i in range(len(arrs))]
    with atomic_write(fname) as f:
        np.savez(f, __mxnet_tpu_names__=np.array(names, dtype=object),
                 **{f"arr_{i}": _dense_numpy(a) for i, a in enumerate(arrs)})


def _is_dmlc_params(fname):
    """The 8-byte list magic (``.params`` files of the JAX package's
    early builds are npz)."""
    with open(fname, "rb") as f:
        head = f.read(8)
    return len(head) == 8 and int.from_bytes(head, "little") == 0x112


def load(fname):
    """Load what ``save`` wrote (or the JAX package's ``nd.save``): a
    dict for named arrays, else a list. Dense arrays come back as
    NDArrays on the CPU (the file's device); sparse ones as the stored
    parts (``param_file.RowSparseStorage`` / ``CSRStorage``)."""
    import os
    from .param_file import load_params
    fname = os.fspath(fname)

    def wrap(a):
        return NDArray(torch.from_numpy(a)) if isinstance(a, np.ndarray) \
            else a

    if fname.endswith(".params") and _is_dmlc_params(fname):
        raw, names = load_params(fname)
        arrs = [wrap(a) for a in raw]
        return dict(zip(names, arrs)) if names else arrs
    with np.load(fname, allow_pickle=True) as zf:
        names = [str(n) for n in zf["__mxnet_tpu_names__"]]
        arrs = [wrap(zf[f"arr_{i}"]) for i in range(len(names))]
    if all(n.isdigit() for n in names):
        return arrs
    return dict(zip(names, arrs))


from . import random  # noqa: E402,F401
