"""Runtime-compiled CUDA kernels (counterpart of ``mxnet_tpu/rtc.py``;
reference: python/mxnet/rtc.py ``CudaModule``, src/common/rtc.cc).

``CudaModule(source, options=(), exports=())`` holds a user's CUDA C++
source. ``get_function(name)`` compiles it once with ``nvcc -cubin`` for
``sm_90a`` into ``mxnet_tpu_torch/_build/<hash>/`` (keyed on the source
and the options, with the ``ptxas -v`` report kept beside the cubin as
``<hash>.log``), loads the cubin through the CUDA driver API
(``libcuda.so.1`` via ``ctypes``) into the primary context that PyTorch
uses, and returns a ``CudaFunction``. Kernels are looked up by their
``extern "C"`` name; ``exports`` is accepted for MXNet's signature and
not read, since a C++ name is not looked up by its mangled symbol.
Nothing is compiled but the caller's string.

A ``CudaFunction`` launches on the stream it is given, by default
PyTorch's current stream. Wrapping it as
an op (shapes, output allocation, launch geometry, autograd) is
``operator.UserKernel``'s work.

``PallasModule`` is the JAX package's holder for Pallas kernels; a
Pallas kernel does not run on a GPU, so it raises and names
``CudaModule``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from .base import MXNetError

__all__ = ["CudaModule", "CudaFunction", "PallasModule"]

_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
FLAGS = ("-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v")
_LOCK = threading.Lock()
_DRIVER = [None]
CUDA_ERROR_NOT_FOUND = 500


def _driver():
    """``libcuda.so.1`` with the entry points used here, initialised."""
    with _LOCK:
        if _DRIVER[0] is None:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError as e:
                raise MXNetError(f"the CUDA driver library is not "
                                 f"available: {e}") from None
            vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
            lib.cuInit.argtypes = [ctypes.c_uint]
            lib.cuGetErrorString.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
            lib.cuCtxGetCurrent.argtypes = [pp]
            lib.cuCtxSetCurrent.argtypes = [vp]
            lib.cuDeviceGet.argtypes = [ctypes.POINTER(ctypes.c_int),
                                        ctypes.c_int]
            lib.cuDevicePrimaryCtxRetain.argtypes = [pp, ctypes.c_int]
            lib.cuModuleLoad.argtypes = [pp, ctypes.c_char_p]
            lib.cuModuleGetFunction.argtypes = [pp, vp, ctypes.c_char_p]
            lib.cuLaunchKernel.argtypes = [
                vp, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                vp, pp, pp]
            _check(lib, lib.cuInit(0), "cuInit")
            _DRIVER[0] = lib
        return _DRIVER[0]


def _check(lib, res, what):
    if res != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(res, ctypes.byref(msg))
        text = msg.value.decode() if msg.value else "unknown error"
        raise MXNetError(f"{what} failed: CUresult {res} ({text})")


def _current_context(lib, device_index):
    """Make PyTorch's primary context of ``device_index`` current in this
    thread (PyTorch creates it; the driver API needs it current)."""
    import torch
    torch.cuda.init()
    torch.empty(1, device=f"cuda:{device_index}")
    ctx = ctypes.c_void_p()
    _check(lib, lib.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    if not ctx.value:
        dev = ctypes.c_int()
        _check(lib, lib.cuDeviceGet(ctypes.byref(dev), device_index),
               "cuDeviceGet")
        _check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
               "cuDevicePrimaryCtxRetain")
        _check(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return ctx.value


class CudaFunction:
    """One kernel of a loaded ``CudaModule``: ``launch(args, grid,
    block)`` with ``args`` a list of ``ctypes`` values (``c_void_p`` for a
    pointer, ``c_int64`` for a count, ...)."""

    def __init__(self, module, name, handle):
        self.module = module
        self.name = name
        self._handle = handle

    def __repr__(self):
        return f"CudaFunction({self.name})"

    def launch(self, args, grid, block, shared_mem=0, stream=None):
        import torch
        lib = _driver()
        # the autograd engine runs a backward on threads of its own, where
        # the module's context may not be current yet
        cur = ctypes.c_void_p()
        _check(lib, lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
        if cur.value != self.module._ctx:
            _check(lib, lib.cuCtxSetCurrent(self.module._ctx),
                   "cuCtxSetCurrent")
        if stream is None:
            stream = torch.cuda.current_stream().cuda_stream
        grid = tuple(grid) + (1,) * (3 - len(grid))
        block = tuple(block) + (1,) * (3 - len(block))
        # kernelParams: an array of pointers to the argument values, which
        # stay alive in ``args`` through the launch
        params = (ctypes.c_void_p * len(args))(
            *[ctypes.addressof(a) for a in args])
        res = lib.cuLaunchKernel(self._handle, *grid, *block, shared_mem,
                                 stream, params, None)
        _check(lib, res, f"cuLaunchKernel({self.name})")


class CudaModule:
    """A user's CUDA C++ source, compiled at first ``get_function``
    (reference: rtc.py:42 ``CudaModule``)."""

    def __init__(self, source, options=(), exports=()):
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        digest = hashlib.sha256("\0".join(
            (source,) + FLAGS + self.options).encode()).hexdigest()[:16]
        self.cubin = os.path.join(_BUILD, digest, digest + ".cubin")
        self.log_path = self.cubin[:-6] + ".log"
        self.compile_seconds = None
        self._module = None
        self._ctx = None
        self._device = None
        self._functions = {}

    def compile(self):
        """Build the cubin unless it is there already; returns its path."""
        import time
        from .kernels.build import nvcc_path
        if os.path.exists(self.cubin):
            return self.cubin
        nvcc = nvcc_path()
        os.makedirs(os.path.dirname(self.cubin), exist_ok=True)
        src = self.cubin[:-6] + ".cu"
        with open(src, "w") as f:
            f.write(self.source)
        tmp = f"{self.cubin}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *FLAGS, *self.options, "-o", tmp, src],
                              capture_output=True, text=True)
        self.compile_seconds = time.perf_counter() - t0
        with open(self.log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise MXNetError(f"nvcc failed on a CudaModule source:\n"
                             f"{proc.stderr[-4000:]}")
        os.replace(tmp, self.cubin)
        return self.cubin

    def ptxas_log(self):
        """The ``ptxas -v`` report of the build ('' before it)."""
        if not os.path.exists(self.log_path):
            return ""
        with open(self.log_path) as f:
            return f.read()

    def _load(self):
        import torch
        path = self.compile()
        lib = _driver()
        dev = torch.cuda.current_device()
        if self._module is None:
            self._ctx = _current_context(lib, dev)
            mod = ctypes.c_void_p()
            _check(lib, lib.cuModuleLoad(ctypes.byref(mod), path.encode()),
                   "cuModuleLoad")
            self._module, self._device = mod, dev
        elif dev != self._device:
            raise MXNetError(f"CudaModule was loaded on cuda:{self._device}; "
                             f"the current device is cuda:{dev}")
        return lib

    def get_function(self, name):
        """The ``extern "C"`` kernel ``name``. Compiles and loads the
        module first."""
        with _LOCK:
            if name in self._functions:
                return self._functions[name]
        lib = self._load()
        with _LOCK:
            fn = ctypes.c_void_p()
            res = lib.cuModuleGetFunction(ctypes.byref(fn), self._module,
                                          name.encode())
            if res == CUDA_ERROR_NOT_FOUND:
                raise MXNetError(
                    f"kernel {name!r} is not in the module; a kernel is "
                    f"looked up by its name, so declare it extern \"C\"")
            _check(lib, res, f"cuModuleGetFunction({name})")
            f = CudaFunction(self, name, fn)
            self._functions[name] = f
            return f


class PallasModule:
    """The JAX package's holder of Pallas kernels. A Pallas kernel does
    not run on a GPU: write the kernel in CUDA C++ for ``CudaModule`` (or
    in Triton) and wrap it with ``operator.UserKernel``."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "rtc.PallasModule: Pallas kernels do not run on a GPU; compile "
            "a CUDA C++ kernel with mxnet_tpu_torch.rtc.CudaModule (or "
            "write a Triton kernel) and wrap it with "
            "mxnet_tpu_torch.operator.UserKernel / register_kernel")
