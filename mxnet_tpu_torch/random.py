"""Global random state (counterpart of ``mxnet_tpu/random.py``).

``seed(n)`` seeds one explicit ``torch.Generator`` per device;
``generator(device)`` hands out that device's generator (made from the
last seed, 0 before any, on first use), or, inside ``use_generator(g)``
on this thread, ``g`` for ``g``'s device (a captured training step
registers its own generator with the graph and hands it to the ops it
runs, such as Dropout). Initializers and
``nd.random`` draw from it, so a seed reproduces a run on the same
device. Draws differ from the JAX package's: tests feed both packages
numpy inputs instead.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "generator", "use_generator", "get_state", "set_state"]

_lock = threading.Lock()
_seed = [0]
_gens = {}
_local = threading.local()


def _key(device):
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def seed(seed_state, ctx="all"):
    """Seed the generator of every device (``ctx`` is accepted for the
    reference's signature; every device is seeded, as in the JAX
    package)."""
    with _lock:
        _seed[0] = int(seed_state)
        for g in _gens.values():
            g.manual_seed(int(seed_state))


def generator(device):
    """The explicit generator of ``device`` (``use_generator``'s, inside
    it, for that generator's device)."""
    d = _key(device)
    g = getattr(_local, "override", None)
    if g is not None and _key(g.device) == d:
        return g
    with _lock:
        g = _gens.get(d)
        if g is None:
            g = _gens[d] = torch.Generator(device=d)
            g.manual_seed(_seed[0])
        return g


@contextlib.contextmanager
def use_generator(gen):
    """Within this block, on this thread, ``generator(gen.device)``
    returns ``gen`` (None: no override)."""
    prev = getattr(_local, "override", None)
    _local.override = gen
    try:
        yield gen
    finally:
        _local.override = prev


def get_state():
    """The seed and every generator's state, for a checkpoint. The states
    are numpy ``uint8`` arrays, so the snapshot unpickles without torch
    (the JAX package reads the port's checkpoints)."""
    with _lock:
        return {"seed": _seed[0],
                "generators": {str(d): g.get_state().numpy().copy()
                               for d, g in _gens.items()}}


def set_state(state):
    """Restore a ``get_state`` snapshot."""
    with _lock:
        _seed[0] = int(state["seed"])
        for name, st in state["generators"].items():
            d = torch.device(name)
            g = _gens.get(d)
            if g is None:
                g = _gens[d] = torch.Generator(device=d)
            g.set_state(torch.as_tensor(st, dtype=torch.uint8))
