"""Build the port's CUDA kernels at first use.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through ``ctypes``. The
output lives in ``mxnet_tpu_torch/_build/<hash>/``, keyed on a hash of
the source text, of every ``csrc/`` header it includes (``#include
"..."``, followed recursively) and of the flags, so an edit to either
rebuilds and an unchanged source loads the library already built.
``ptxas -v`` output (registers, shared memory, spills) is kept beside
each library as ``<name>.log``.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["build_all", "load", "nvcc_path", "SOURCES"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("bn_relu_conv1x1", "bn_relu_matmul", "decode_attention",
           "lstm_step", "greedy_nms")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
_LIBS = {}
_LOCK = threading.Lock()


def nvcc_path():
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, else the one
    on ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), DEFAULT_NVCC]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise MXNetError("nvcc not found: the port's CUDA kernels build on a "
                     "machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _csrc_files(src, seen=None):
    """``src`` and every ``csrc/`` file it includes with ``#include
    "..."``, recursively, each once, in include order."""
    seen = [] if seen is None else seen
    seen.append(src)
    with open(src, "rb") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        path = os.path.join(os.path.dirname(src), inc.decode())
        if os.path.exists(path) and path not in seen:
            _csrc_files(path, seen)
    return seen


def _flags(defines):
    return FLAGS + tuple("-D" + d for d in defines)


def _lib_path(name, defines=()):
    src = os.path.join(_CSRC, name + ".cu")
    digest = hashlib.sha256()
    for path in _csrc_files(src):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + f.read())
    digest.update(" ".join(_flags(defines)).encode())
    return src, os.path.join(_BUILD, digest.hexdigest()[:16],
                             f"lib{name}.so")


def _compile(name, defines=()):
    src, lib = _lib_path(name, defines)
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *_flags(defines), "-o", tmp, src],
                          capture_output=True, text=True)
    with open(lib[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise MXNetError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)       # atomic: a concurrent loader sees all or none
    return lib


def build_all():
    """Compile every source, one ``nvcc`` each, all started together.
    Returns {name: library path}."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as ex:
        return dict(zip(SOURCES, ex.map(_compile, SOURCES)))


def load(name, defines=()):
    """The loaded ``ctypes`` library for ``csrc/<name>.cu``, built first
    if needed; ``defines`` (macro names, ``-D`` each) build a variant of
    its own, such as D1's ``D1_TRACE``."""
    key = (name, tuple(defines))
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = ctypes.CDLL(_compile(name, key[1]))
        return _LIBS[key]


def build_log(name, defines=()):
    """ptxas report of the current build of ``name`` ('' if not built)."""
    log = _lib_path(name, tuple(defines))[1][:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()
