"""Custom operators written by users (counterpart of
``mxnet_tpu/operator.py``; reference: python/mxnet/operator.py:422-627,
python/mxnet/rtc.py).

- ``CustomOp`` / ``CustomOpProp`` / ``register`` and the ``Custom`` op:
  a user's Python forward and backward over NDArrays, run as one
  ``torch.autograd.Function`` (the reference runs them as engine
  callbacks). The JAX package also stages Custom inside ``jit`` through
  ``pure_callback``; the port has no staged path (``hybridize()`` runs
  eagerly), so there is no counterpart of that.
- ``UserKernel`` / ``register_kernel``: K4, the hook that runs a user's
  hand-written GPU kernel as an op, counterpart of the JAX package's
  ``PallasKernel`` / ``register_pallas`` (``pl.pallas_call`` at
  operator.py:222). The kernel is a function of an ``rtc.CudaModule``
  (CUDA C++ compiled at run time for ``sm_90a``) or a ``@triton.jit``
  function. What bounds it is the user's kernel; the hook adds one
  output allocation and one launch.

Calling convention of a user kernel: the input pointers, then the output
pointer, then the output's element count as int64 (a Triton kernel also
gets ``BLOCK=<block>`` as a constexpr). The default launch is one thread
per output element in blocks of 256; ``grid`` and ``block`` (ints or
functions of the input shapes) override it. The output has shape
``out_shape`` (a tuple, or a function of the input shapes) and the first
input's dtype; inputs are made contiguous. With ``vjp``, the op is
differentiable: the backward calls ``vjp(ct, *inputs)`` on tensors, and
the VJP may itself launch a ``UserKernel``.

``plain`` is the counterpart of Pallas' interpret mode: a CUDA kernel
cannot run on the CPU, so on a CPU tensor the hook runs the user's plain
PyTorch version (and raises if there is none). On a CUDA tensor it
launches the kernel or raises; it never falls back to ``plain``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import autograd
from .base import MXNetError
from .context import as_context
from .rtc import CudaFunction

__all__ = ["CustomOp", "CustomOpProp", "register", "get_registered",
           "UserKernel", "register_kernel", "register_pallas"]


class CustomOp:
    """Base class of custom operators (reference: operator.py:422)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` by ``req`` (reference:
        operator.py:459); ``dst`` is a buffer the op owns."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src


class CustomOpProp:
    """A custom op's signature (reference: operator.py:468)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


_registry = {}


def register(reg_name):
    """Class decorator registering a ``CustomOpProp`` under ``op_type``
    (reference: operator.py:602)."""

    def do_register(prop_cls):
        _registry[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_registered(op_type):
    if op_type not in _registry:
        raise KeyError(f"custom op type {op_type!r} is not registered; "
                       "use mx.operator.register")
    return _registry[op_type]


class _CustomFunction(torch.autograd.Function):
    """The ``Custom`` op: the user's forward and backward on NDArrays."""

    @staticmethod
    def forward(ctx, prop, n_args, is_train, *tensors):
        from .dtype import resolve_dtype
        from .ndarray.ndarray import NDArray
        args, aux_t = tensors[:n_args], tensors[n_args:]
        in_shapes = [list(t.shape) for t in args]
        _, out_shapes, _ = prop.infer_shape(in_shapes)
        in_dtypes = [np.dtype(str(t.dtype).replace("torch.", ""))
                     for t in args]
        _, out_dtypes, _ = prop.infer_type(in_dtypes)
        op = prop.create_operator(as_context(args[0].device), in_shapes,
                                  in_dtypes)
        ins = [NDArray(t) for t in args]
        aux = [NDArray(t) for t in aux_t]
        outs = [NDArray(torch.zeros(tuple(s), dtype=resolve_dtype(d),
                                    device=args[0].device))
                for s, d in zip(out_shapes, out_dtypes)]
        with autograd.pause(train_mode=is_train):
            op.forward(is_train, ["write"] * len(outs), ins, outs, aux)
        ctx.op, ctx.ins, ctx.outs, ctx.aux = op, ins, outs, aux
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray
        grads = [NDArray(torch.zeros_like(x._data)) for x in ctx.ins]
        with autograd.pause():
            ctx.op.backward(["write"] * len(grads),
                            [NDArray(c) for c in cts], ctx.ins, ctx.outs,
                            grads, ctx.aux)
        return (None, None, None) + tuple(g._data for g in grads) \
            + (None,) * len(ctx.aux)


def _custom_op_fn(*tensors, op_type=None, **kw):
    """Registry entry of the ``Custom`` op; ``kw`` parameterises the
    prop, as the reference passes them to its constructor."""
    if op_type is None:
        raise ValueError("Custom requires op_type=")
    prop = get_registered(op_type)(**kw)
    n_args = len(prop.list_arguments())
    outs = _CustomFunction.apply(prop, n_args, autograd.is_training(),
                                 *tensors)
    return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------------
# K4: a user's GPU kernel as an op
# ---------------------------------------------------------------------------
def _is_triton_kernel(kernel):
    return hasattr(kernel, "run") and hasattr(kernel, "__getitem__")


def _resolve(v, shapes):
    v = v(shapes) if callable(v) else v
    return tuple(int(x) for x in v) if isinstance(v, (tuple, list)) \
        else int(v)


class _UserKernelFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, uk, *tensors):
        ctx.uk = uk
        ctx.save_for_backward(*tensors)
        return uk._forward(*tensors)

    @staticmethod
    def backward(ctx, ct):
        xs = ctx.saved_tensors
        grads = ctx.uk.vjp(ct, *xs)
        if not isinstance(grads, (tuple, list)):
            grads = (grads,)
        if len(grads) != len(xs):
            raise MXNetError(f"{ctx.uk.name}: the vjp returned "
                             f"{len(grads)} gradients for {len(xs)} inputs")
        return (None,) + tuple(
            None if g is None or not x.is_floating_point() else g
            for g, x in zip(grads, xs))


class UserKernel:
    """A user's CUDA (``rtc.CudaModule`` function) or Triton kernel as
    a callable op; counterpart of ``PallasKernel`` (operator.py:185).
    ``launches`` counts its kernel launches."""

    def __init__(self, kernel, out_shape, name="user_kernel", grid=None,
                 block=None, vjp=None, plain=None):
        self.kernel = kernel
        self.out_shape = out_shape
        self.name = name
        self.grid = grid
        self.block = block
        self.vjp = vjp
        self.plain = plain
        self.launches = 0
        self._checked = False

    def __repr__(self):
        return f"UserKernel({self.name}, {self.kernel!r})"

    def _launch(self, xs):
        shapes = tuple(tuple(x.shape) for x in xs)
        shape = _resolve(self.out_shape, shapes)
        shape = (shape,) if isinstance(shape, int) else shape
        out = torch.empty(shape, dtype=xs[0].dtype, device=xs[0].device)
        n = out.numel()
        if n == 0:
            return out
        block = _resolve(self.block, shapes) if self.block is not None \
            else 256
        if isinstance(self.kernel, CudaFunction):
            block = (block,) if isinstance(block, int) else block
            grid = _resolve(self.grid, shapes) if self.grid is not None \
                else (n + block[0] - 1) // block[0]
            grid = (grid,) if isinstance(grid, int) else grid
            loaded_on = self.kernel.module._device
            if out.device.index != loaded_on:
                raise MXNetError(
                    f"{self.name}: the tensors are on {out.device}, the "
                    f"kernel's module was loaded on cuda:{loaded_on}")
            import ctypes
            args = [ctypes.c_void_p(x.data_ptr()) for x in xs] + \
                [ctypes.c_void_p(out.data_ptr()), ctypes.c_int64(n)]
            self.kernel.launch(
                args, grid, block,
                stream=torch.cuda.current_stream(out.device).cuda_stream)
        elif _is_triton_kernel(self.kernel):
            if not isinstance(block, int):
                raise MXNetError(f"{self.name}: a Triton kernel takes one "
                                 f"int block size, got {block}")
            grid = _resolve(self.grid, shapes) if self.grid is not None \
                else (n + block - 1) // block
            grid = (grid,) if isinstance(grid, int) else grid
            with torch.cuda.device(out.device):
                self.kernel[grid](*xs, out, n, BLOCK=block)
        else:
            raise MXNetError(
                f"{self.name}: {self.kernel!r} is neither a CUDA kernel "
                "(rtc.CudaModule.get_function) nor a Triton kernel; it "
                "cannot run on a CUDA tensor")
        self.launches += 1
        if not self._checked:
            # a fault in the first launch of a kernel shows here, where it
            # happened
            torch.cuda.synchronize(out.device)
            self._checked = True
        return out

    def _forward(self, *tensors):
        devs = {t.device for t in tensors}
        if len(devs) != 1:
            raise MXNetError(f"{self.name}: inputs on several devices "
                             f"{sorted(map(str, devs))}")
        dev = devs.pop()
        if dev.type == "cuda":
            return self._launch([t.contiguous() for t in tensors])
        if self.plain is None:
            raise MXNetError(
                f"{self.name}: a {type(self.kernel).__name__} kernel does "
                f"not run on a {dev.type} tensor, and the op has no plain "
                "version (pass plain=)")
        return self.plain(*tensors)

    def _call_tensors(self, *tensors):
        if self.vjp is not None and torch.is_grad_enabled() and \
                any(t.requires_grad for t in tensors):
            return _UserKernelFunction.apply(self, *tensors)
        with torch.no_grad():
            return self._forward(*tensors)

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray, _invoke_fn
        if inputs and isinstance(inputs[0], NDArray):
            return _invoke_fn(self._call_tensors, list(inputs))
        return self._call_tensors(*inputs)


def register_kernel(name, kernel, out_shape, grid=None, block=None,
                    vjp=None, plain=None, aliases=()):
    """Register a user kernel as an op, callable as ``nd.<name>``
    (counterpart of ``register_pallas``, operator.py:249-264)."""
    import sys
    from .ops.registry import register_op
    uk = UserKernel(kernel, out_shape, name=name, grid=grid, block=block,
                    vjp=vjp, plain=plain)
    register_op(name, aliases=aliases)(
        lambda *tensors, **attrs: uk._call_tensors(*tensors))
    nd_pkg = sys.modules.get(f"{__package__}.ndarray")
    if nd_pkg is not None:
        for n in (name,) + tuple(aliases):
            nd_pkg._add_op(n)
    return uk


def register_pallas(*args, **kwargs):
    """The JAX package's Pallas hook: a Pallas kernel does not run on a
    GPU."""
    raise NotImplementedError(
        "register_pallas: Pallas kernels do not run on a GPU; compile a "
        "CUDA C++ kernel with mxnet_tpu_torch.rtc.CudaModule (or write a "
        "Triton kernel) and register it with "
        "mxnet_tpu_torch.operator.register_kernel")


from .ops.registry import register_op as _register_op  # noqa: E402

_register_op("Custom", aliases=["_Custom"])(_custom_op_fn)
