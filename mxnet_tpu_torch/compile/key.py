"""Canonical program keys (counterpart of ``mxnet_tpu/compile/key.py``).

A captured program is reusable exactly when everything that fed the
capture is identical: the graph (symbol JSON), the bound shapes and
dtypes, the optimizer configuration (hyperparameters are constants of
the captured step; only ``lr`` rides as a run-time device scalar), the
fusion-pass flag and the rewrite pipeline's outcome, and the device the
program runs on. ``program_key`` folds all of that into one sha256
digest; the registry keys on it.

Hardware identity (platform, device kind, device count) is part of the
digest: a CPU run and a CUDA run are different programs. Not ported: the
version ``fingerprint`` (it serves the persistent cache) and the mesh
material (the port runs on one device).
"""
from __future__ import annotations

import hashlib
import json

import torch

__all__ = ["ProgramKey", "program_key", "arg_signature",
           "optimizer_fingerprint", "symbol_digest"]

# optimizer attributes that do NOT feed the captured program and so stay
# OUT of the key: the step counters and the base learning rate, which
# the step reads from a device scalar written before every replay
_OPT_MUTABLE = {"num_update", "begin_num_update", "_index_update_count",
                "lr"}


def _backend_identity(device=None):
    """Hardware identity hashed INTO the key: ``{"platform": "cuda" |
    "cpu", "device_kind", "ndev": 1}``."""
    device = torch.device(device) if device is not None \
        else torch.device("cpu")
    if device.type == "cuda":
        return {"platform": "cuda",
                "device_kind": torch.cuda.get_device_name(device),
                "ndev": 1}
    return {"platform": device.type, "device_kind": device.type,
            "ndev": 1}


def symbol_digest(symbol):
    """sha256 of the symbol's canonical JSON: the graph half of every key
    (equal to the JAX package's for the same graph, whose JSON is
    byte-equal)."""
    return hashlib.sha256(symbol.tojson().encode("utf-8")).hexdigest()


def _dtype_name(dtype):
    """'float32' for torch.float32 or numpy's float32 (the JAX package's
    spelling)."""
    return str(dtype).replace("torch.", "")


def arg_signature(args):
    """Structural signature of a sequence of tensors or arrays (nested
    lists, tuples and dict values are walked): a tuple of (shape, dtype
    name) per leaf with a shape. The retrace guard stores this per entry
    point and reports it when a program is acquired anew."""
    sig = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif getattr(x, "shape", None) is not None:
            sig.append((tuple(int(d) for d in x.shape),
                        _dtype_name(getattr(x, "dtype", "?"))))

    walk(args)
    return tuple(sig)


def optimizer_fingerprint(optimizer):
    """Key material for an optimizer: type name plus every scalar
    hyperparameter and the per-name multiplier dicts (constants of the
    captured step); the step counters and lr are excluded."""
    if optimizer is None:
        return None
    out = {"type": type(optimizer).__name__.lower()}
    for k, v in sorted(vars(optimizer).items()):
        if k in _OPT_MUTABLE:
            continue
        if isinstance(v, (int, float, bool, str)):
            out[k] = v
        elif isinstance(v, dict) and k in ("lr_mult", "wd_mult",
                                           "idx2name"):
            out[k] = sorted((str(a), b) for a, b in v.items()
                            if isinstance(b, (int, float, bool, str)))
    return out


class ProgramKey:
    """One canonical program identity: ``digest`` (sha256 hex over the
    key materials), ``name`` (label for reports), ``kind`` (entry point
    family) and the ``materials`` dict (for the retrace guard's diffs)."""

    __slots__ = ("kind", "name", "digest", "materials")

    def __init__(self, kind, name, digest, materials):
        self.kind = kind
        self.name = name
        self.digest = digest
        self.materials = materials

    def diff(self, other):
        """Names of the top-level key materials that differ from
        ``other`` (the retrace guard's 'why was this captured again')."""
        if other is None:
            return []
        a, b = self.materials, other.materials
        return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))

    def diff_detail(self, other):
        """``diff`` one level down: a differing dict material names its
        differing keys (``extra.metrics``, ``extra.guard``)."""
        if other is None:
            return []
        out = []
        for k in self.diff(other):
            a, b = self.materials.get(k), other.materials.get(k)
            if isinstance(a, dict) and isinstance(b, dict):
                out += [f"{k}.{s}" for s in sorted(set(a) | set(b))
                        if a.get(s) != b.get(s)]
            else:
                out.append(k)
        return out

    def __repr__(self):
        return f"ProgramKey({self.kind}:{self.name}@{self.digest[:10]})"


def _canon(obj):
    """Canonical key material for json hashing (tuples -> lists, dtypes
    and other objects -> str)."""
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, (int, float, bool, str)) or obj is None:
        return obj
    if isinstance(obj, torch.dtype):
        return _dtype_name(obj)
    return str(obj)


def program_key(kind, name, *, symbol=None, symbol_sha=None,
                input_sigs=(), optimizer=None, fusion=None,
                passes=None, extra=None, device=None):
    """The canonical :class:`ProgramKey` of one entry point's program.

    ``input_sigs``: a structural signature of the run-time inputs;
    ``fusion``: the resolved fusion-flag material; ``passes``: the
    rewrite pipeline's key material (``pipeline_key_material``);
    ``extra``: entry-point-specific inputs (compute dtype, trainable
    set...); ``device``: the device the program runs on (its backend
    identity is hashed). Either ``symbol`` or ``symbol_sha`` names the
    graph."""
    if symbol_sha is None and symbol is not None:
        symbol_sha = symbol_digest(symbol)
    materials = {
        "kind": kind,
        "symbol": symbol_sha,
        "inputs": _canon(input_sigs),
        "optimizer": _canon(optimizer_fingerprint(optimizer)
                            if optimizer is not None and
                            not isinstance(optimizer, dict) else optimizer),
        "fusion": _canon(fusion),
        "passes": _canon(passes),
        "backend": _backend_identity(device),
        "extra": _canon(extra or {}),
    }
    blob = json.dumps(materials, sort_keys=True).encode("utf-8")
    return ProgramKey(kind, name, hashlib.sha256(blob).hexdigest(),
                      materials)
