"""NDArray: the imperative tensor frontend (counterpart of
``mxnet_tpu/ndarray/ndarray.py``; reference: include/mxnet/ndarray.h,
python/mxnet/ndarray/ndarray.py).

An NDArray holds one ``torch.Tensor`` (``.data``) on one device. Ops run
eagerly on PyTorch's stream; ``asnumpy()`` and ``wait_to_read()`` are
the sync points. Each op is a call of a registry function under
``torch.no_grad()``, unless autograd is recording: then torch's own
graph records it (``autograd.py``). Mutation (``+=``, slice assignment,
``copyto``) writes into the tensor in place, outside the graph.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from ..context import Context, as_context, current_context
from ..dtype import numpy_dtype, resolve_dtype
from ..ops.registry import get_op

__all__ = ["NDArray", "array", "empty", "waitall"]

_TRAINING_AWARE_OPS = {"BatchNorm", "Dropout", "RNN"}


class NDArray:
    """An n-dimensional array on a device, with autograd support."""

    __slots__ = ("_data", "_grad", "_grad_req", "_grad_written_seq",
                 "__weakref__")

    def __init__(self, data):
        self._data = data
        self._grad = None
        self._grad_req = "null"
        self._grad_written_seq = None

    # -- basic properties ----------------------------------------------------
    @property
    def data(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return as_context(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return self.transpose()

    # -- sync / host transfer ------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A copy on the host (never a view of the tensor's memory)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __int__(self):
        return int(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __index__(self):
        return int(self.asscalar())

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- autograd ------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a gradient buffer and make this array a fresh leaf
        (any recorded history is cut), as ``MXAutogradMarkVariables``
        does."""
        if stype not in (None, "default"):
            raise NotImplementedError("sparse gradients are not ported")
        autograd.mark_variables([self], [NDArray(torch.zeros_like(
            self._data.detach()))], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph, train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    # -- conversion / movement -----------------------------------------------
    def astype(self, dtype, copy=True):
        dt = resolve_dtype(dtype)
        return _invoke_fn(lambda d: d.to(dt), [self])

    def copy(self):
        return _invoke_fn(torch.clone, [self])

    def copyto(self, other):
        """Copy into another NDArray in place, or onto a context."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.device, copy=True))
        raise TypeError(f"copyto does not support {type(other)}")

    def as_in_context(self, ctx):
        if as_context(ctx) == self.context:
            return self
        return _invoke_fn(lambda d: d.to(as_context(ctx).device), [self])

    as_in_ctx = as_in_context

    def tostype(self, stype):
        if stype != "default":
            raise NotImplementedError(f"sparse storage type '{stype}' is "
                                      "not ported")
        return self

    # -- shape ops as methods ------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _invoke_op("Reshape", [self], {
            "shape": shape, "reverse": kwargs.get("reverse", False)})

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _invoke_op("transpose", [self], {"axes": axes or None})

    def expand_dims(self, axis):
        return _invoke_op("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _invoke_op("squeeze", [self], {"axis": axis})

    def flatten(self):
        return _invoke_op("Flatten", [self], {})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        """``num_outputs`` equal slices along ``axis`` (a list; one
        NDArray when ``num_outputs`` is 1)."""
        out = _invoke_op("SliceChannel", [self], {
            "num_outputs": num_outputs, "axis": axis,
            "squeeze_axis": squeeze_axis})
        return list(out) if isinstance(out, tuple) else out

    def swapaxes(self, dim1, dim2):
        return _invoke_op("SwapAxis", [self], {"dim1": dim1, "dim2": dim2})

    def flip(self, axis):
        return _invoke_op("reverse", [self], {"axis": axis})

    def tile(self, reps):
        return _invoke_op("tile", [self], {"reps": reps})

    def repeat(self, repeats, axis=None):
        return _invoke_op("repeat", [self], {"repeats": repeats,
                                             "axis": axis})

    def pad(self, mode="constant", pad_width=(), constant_value=0.0):
        return _invoke_op("Pad", [self], {"mode": mode,
                                          "pad_width": pad_width,
                                          "constant_value": constant_value})

    def slice(self, begin, end, step=None):
        return _invoke_op("slice", [self], {"begin": begin, "end": end,
                                            "step": step or ()})

    def take(self, indices, axis=0, mode="clip"):
        return _invoke_op("take", [self, indices], {"axis": axis,
                                                    "mode": mode})

    def prod(self, axis=None, keepdims=False):
        return _invoke_op("prod", [self], {"axis": axis,
                                           "keepdims": keepdims})

    def argsort(self, axis=-1, is_ascend=True):
        return _invoke_op("argsort", [self], {"axis": axis,
                                              "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return _invoke_op("sort", [self], {"axis": axis,
                                           "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _invoke_op("topk", [self], {"axis": axis, "k": k,
                                           "ret_typ": ret_typ,
                                           "is_ascend": is_ascend})

    def slice_axis(self, axis, begin, end):
        return _invoke_op("slice_axis", [self],
                          {"axis": axis, "begin": begin, "end": end})

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return _invoke_op("one_hot", [self], {
            "depth": depth, "on_value": on_value, "off_value": off_value,
            "dtype": dtype})

    def clip(self, a_min=None, a_max=None):
        return _invoke_op("clip", [self], {"a_min": a_min, "a_max": a_max})

    def abs(self):
        return _invoke_op("abs", [self], {})

    def sign(self):
        return _invoke_op("sign", [self], {})

    def sqrt(self):
        return _invoke_op("sqrt", [self], {})

    def square(self):
        return _invoke_op("square", [self], {})

    def exp(self):
        return _invoke_op("exp", [self], {})

    def log(self):
        return _invoke_op("log", [self], {})

    def relu(self):
        return _invoke_op("relu", [self], {})

    def sigmoid(self):
        return _invoke_op("sigmoid", [self], {})

    def tanh(self):
        return _invoke_op("tanh", [self], {})

    def softmax(self, axis=-1):
        return _invoke_op("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return _invoke_op("log_softmax", [self], {"axis": axis})

    def sum(self, axis=None, keepdims=False, exclude=False):
        return _invoke_op("sum", [self], {"axis": axis, "keepdims": keepdims,
                                          "exclude": exclude})

    def mean(self, axis=None, keepdims=False, exclude=False):
        return _invoke_op("mean", [self], {"axis": axis,
                                           "keepdims": keepdims,
                                           "exclude": exclude})

    def max(self, axis=None, keepdims=False):
        return _invoke_op("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return _invoke_op("min", [self], {"axis": axis, "keepdims": keepdims})

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke_op("norm", [self], {"ord": ord, "axis": axis,
                                           "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return _invoke_op("argmax", [self], {"axis": axis,
                                             "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return _invoke_op("argmin", [self], {"axis": axis,
                                             "keepdims": keepdims})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _invoke_op("dot", [self, other], {
            "transpose_a": transpose_a, "transpose_b": transpose_b})

    def zeros_like(self):
        return _invoke_op("zeros_like", [self], {})

    def ones_like(self):
        return _invoke_op("ones_like", [self], {})

    # -- indexing ------------------------------------------------------------
    def __getitem__(self, key):
        key = _convert_key(key)
        return _invoke_fn(lambda d: d[key], [self])

    def __setitem__(self, key, value):
        """Writes in place, outside any recorded graph (the buffer must
        not be one that a live graph saved)."""
        if isinstance(value, NDArray):
            value = value._data
        with torch.no_grad():
            if key is None or (isinstance(key, slice)
                               and key == slice(None)):
                if isinstance(value, torch.Tensor):
                    self._data.copy_(value.broadcast_to(self.shape))
                else:
                    self._data.fill_(value)
                return
            self._data[_convert_key(key)] = value

    # -- arithmetic ----------------------------------------------------------
    def _binary(self, other, name, scalar_name):
        if isinstance(other, NDArray):
            return _invoke_op(name, [self, other], {})
        return _invoke_op(scalar_name, [self], {"scalar": other})

    def __add__(self, other):
        return self._binary(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _invoke_op("_rminus_scalar", [self], {"scalar": other})

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _invoke_op("_rdiv_scalar", [self], {"scalar": other})

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return _invoke_op("_rmod_scalar", [self], {"scalar": other})

    def __pow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return _invoke_op("_rpower_scalar", [self], {"scalar": other})

    def __matmul__(self, other):
        return _invoke_op("dot", [self, other], {})

    def __neg__(self):
        return _invoke_op("negative", [self], {})

    def __abs__(self):
        return _invoke_op("abs", [self], {})

    def _inplace(self, out):
        # MXNet rebinds the array to the result (an engine write); on a
        # recording tape the result keeps its history. Outside one, a
        # leaf (a parameter after attach_grad) is written in place, so it
        # stays the leaf that the next backward differentiates
        if self._data.requires_grad and self._data.is_leaf and \
                not autograd.is_recording():
            with torch.no_grad():
                self._data.copy_(out._data)
        else:
            self._data = out._data
        return self

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))

    def __eq__(self, other):
        if other is None:
            return False
        return self._binary(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        if other is None:
            return True
        return self._binary(other, "broadcast_not_equal",
                            "_not_equal_scalar")

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)


def _convert_key(key):
    def conv(k):
        return k._data.to(torch.int64) if isinstance(k, NDArray) else k
    if isinstance(key, tuple):
        return tuple(conv(k) for k in key)
    return conv(key)


def _invoke_fn(fn, nd_inputs, record=True):
    """Run ``fn`` over the inputs' tensors: recorded by torch's graph
    while autograd records (and ``record``), under ``torch.no_grad()``
    otherwise (the counterpart of Imperative::Invoke,
    src/imperative/imperative.cc:86). A tuple result becomes a tuple of
    NDArrays."""
    arrays = [x._data for x in nd_inputs]
    with torch.set_grad_enabled(record and autograd.is_recording()):
        res = fn(*arrays)
    if isinstance(res, tuple):
        return tuple(NDArray(r) for r in res)
    return NDArray(res)


# dispatch hook: the profiler's aggregate table installs a timing
# wrapper here; checking it inside _invoke_op covers every binding of
# the name (methods, generated module functions, nd.random)
_PROFILE_HOOK = None


def _invoke_op(name, nd_inputs, attrs):
    if _PROFILE_HOOK is not None:
        return _PROFILE_HOOK(_invoke_op_impl, name, nd_inputs, attrs)
    return _invoke_op_impl(name, nd_inputs, attrs)


def _invoke_op_impl(name, nd_inputs, attrs):
    """Run registry op ``name``. ``None`` attributes are dropped (except
    the axis-like ones, where None means "all"); ``out=`` writes the
    first result into an existing NDArray; BatchNorm, Dropout and RNN
    take the training flag from autograd (the last two draw from
    ``random.generator`` of the data's device). An op registered
    ``no_grad`` records nothing, as in the JAX package's dispatch."""
    opdef = get_op(name)
    attrs = {k: v for k, v in attrs.items()
             if v is not None or k in ("axis", "axes", "a_min", "a_max")}
    out = attrs.pop("out", None)
    if opdef.name in _TRAINING_AWARE_OPS:
        attrs.setdefault("training", autograd.is_training())
    # arrays passed as attributes (optional inputs given by keyword)
    attrs = {k: v._data if isinstance(v, NDArray) else v
             for k, v in attrs.items()}
    dev = next((x._data.device for x in nd_inputs
                if isinstance(x, NDArray)), None)
    inputs = [x if isinstance(x, NDArray) else NDArray(_as_tensor(x, dev))
              for x in nd_inputs]
    result = _invoke_fn(lambda *a: opdef.fn(*a, **attrs), inputs,
                        record=not opdef.no_grad)
    if isinstance(result, tuple) and len(result) == 1:
        # one output is the NDArray itself, as in the reference
        # (``split(num_outputs=1)``)
        result = result[0]
    if out is not None:
        first = result[0] if isinstance(result, tuple) else result
        out._data = first._data
        return out
    return result


def _as_tensor(x, device):
    """A non-NDArray operand as a tensor; float64 becomes float32, as
    MXNet's default dtype."""
    t = torch.as_tensor(np.asarray(x), device=device)
    return t.float() if t.dtype == torch.float64 else t


# ---------------------------------------------------------------------------
# module-level creation and utility functions
# ---------------------------------------------------------------------------
def array(source_array, ctx=None, dtype=None):
    """An NDArray from any array-like, on ``ctx`` (the current context
    when None). float64 input becomes float32, MXNet's default."""
    dev = (ctx.device if isinstance(ctx, Context) else torch.device(ctx)) \
        if ctx is not None else current_context().device
    if isinstance(source_array, NDArray):
        t = source_array._data.detach()
    elif isinstance(source_array, torch.Tensor):
        t = source_array.detach()
    else:
        a = np.asarray(source_array)
        if dtype is None and a.dtype == np.float64:
            dtype = "float32"
        t = torch.from_numpy(np.ascontiguousarray(a))
    dt = resolve_dtype(dtype) if dtype is not None else t.dtype
    return NDArray(t.to(device=dev, dtype=dt, copy=True))


def empty(shape, ctx=None, dtype=None):
    dev = as_context(ctx).device
    return NDArray(torch.zeros(_shape(shape), dtype=resolve_dtype(dtype),
                               device=dev))


def _shape(shape):
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def waitall():
    """Block until all queued work on the current CUDA device is done
    (reference: engine WaitForAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
