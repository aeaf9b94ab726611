"""Imperative autograd on ``torch.autograd`` (counterpart of
``mxnet_tpu/autograd.py``; reference: python/mxnet/autograd.py).

``record()`` turns recording on: NDArray ops then run with torch's grad
mode enabled, so torch's own graph is the tape; outside it they run
under ``torch.no_grad()``. Leaves are NDArrays with ``attach_grad()`` /
``mark_variables``; ``backward`` computes their gradients with
``torch.autograd.grad`` and writes each into its ``.grad`` buffer by
its ``grad_req``: "write" replaces the buffer's value (torch alone would
accumulate across backwards), "add" accumulates, "null" is skipped.
Within one backward, gradients along several paths or from several
heads are summed, as in the reference. Every written leaf is stamped
with the backward's sequence number (``_grad_written_seq``), which the
Trainer's stale-gradient check reads.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "Function"]

_state = threading.local()
# live leaves by id: every NDArray with a gradient buffer
_LEAVES = weakref.WeakValueDictionary()
_backward_seq = [0]


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    """Whether autograd recording is on (reference: autograd.py:86)."""
    return _st().recording


def is_training():
    """Whether train mode is on (reference: autograd.py:93)."""
    return _st().training


def set_recording(is_rec):
    st = _st()
    prev, st.recording = st.recording, bool(is_rec)
    return prev


def set_training(train):
    st = _st()
    prev, st.training = st.training, bool(train)
    return prev


@contextlib.contextmanager
def _scope(recording, training):
    prev_r = set_recording(recording) if recording is not None else None
    prev_t = set_training(training) if training is not None else None
    try:
        yield
    finally:
        if recording is not None:
            set_recording(prev_r)
        if training is not None:
            set_training(prev_t)


def record(train_mode=True):
    """Record ops for autograd (reference: autograd.py:122)."""
    return _scope(True, train_mode)


def pause(train_mode=False):
    """Stop recording inside a ``record()`` scope (reference:
    autograd.py:146)."""
    return _scope(False, train_mode)


def train_mode():
    return _scope(None, True)


def predict_mode():
    return _scope(None, False)


def _register_leaf(arr):
    _LEAVES[id(arr)] = arr


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark NDArrays as leaves with the given gradient buffers
    (reference: autograd.py:197)."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._data = v._data.detach().requires_grad_(req != "null")
        v._grad = g
        v._grad_req = req
        if req != "null":
            _register_leaf(v)


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and \
                not isinstance(head_grads, (list, tuple)):
            head_grads = [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    outs, cts = [], []
    for h, hg in zip(heads, head_grads):
        outs.append(h._data)
        if hg is None:
            cts.append(torch.ones_like(h._data))
        else:
            cts.append(hg._data if isinstance(hg, NDArray)
                       else torch.as_tensor(hg, dtype=h._data.dtype,
                                            device=h._data.device))
    return outs, cts


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into every live leaf's ``.grad`` by its
    ``grad_req`` (reference: Imperative::Backward,
    src/imperative/imperative.cc:358). The default head gradient is
    ones."""
    outs, cts = _heads(heads, head_grads)
    keep = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
    if not keep:
        raise RuntimeError(
            "cannot differentiate: no head was computed under "
            "autograd.record() from a leaf with attach_grad()")
    leaves = [a for a in list(_LEAVES.values())
              if a._grad_req != "null" and a._grad is not None
              and a._data.requires_grad]
    grads = torch.autograd.grad([o for o, _ in keep], [a._data for a in leaves],
                                [c for _, c in keep],
                                retain_graph=retain_graph, allow_unused=True)
    _backward_seq[0] += 1
    seq = _backward_seq[0]
    with torch.no_grad():
        for leaf, g in zip(leaves, grads):
            if g is None:
                continue
            buf = leaf._grad
            g = g.to(buf._data.dtype)
            if leaf._grad_req == "add":
                buf._data = buf._data + g
            else:
                buf._data = g
            leaf._grad_written_seq = seq


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    new NDArrays; ``.grad`` buffers are not touched (reference:
    autograd.py:270). With ``create_graph`` the returned gradients are
    themselves differentiable."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    outs, cts = _heads(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    with torch.enable_grad() if create_graph else contextlib.nullcontext():
        gs = torch.autograd.grad(outs, [v._data for v in variables], cts,
                                 retain_graph=retain_graph,
                                 create_graph=create_graph,
                                 allow_unused=True)
    res = [NDArray(g if g is not None else torch.zeros_like(v._data))
           for g, v in zip(gs, variables)]
    return res[0] if single else res


def get_symbol(x):
    """Reference API (autograd.py:304): the recorded graph is torch's,
    not a serializable symbol."""
    raise NotImplementedError(
        "get_symbol: the recorded graph is torch's autograd graph; use "
        "a Symbol for a serializable graph")


class _FunctionBridge(torch.autograd.Function):
    """Runs an ``autograd.Function``'s forward and backward on NDArrays
    inside torch's graph."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray
        with pause():
            outs = func.forward(*[NDArray(t) for t in tensors])
        ctx.func = func
        ctx.single = not isinstance(outs, (list, tuple))
        outs = [outs] if ctx.single else list(outs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray
        with pause():
            gs = ctx.func.backward(*[NDArray(c) for c in cts])
        if not isinstance(gs, (list, tuple)):
            gs = [gs]
        return (None,) + tuple(g._data if isinstance(g, NDArray) else g
                               for g in gs)


class Function:
    """Customized differentiable function (reference: autograd.py:364):
    subclass with ``forward`` and ``backward`` over NDArrays."""

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return getattr(self, "_saved", ())

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, *[x._data for x in inputs])
        res = [NDArray(o) for o in outs]
        return res[0] if len(res) == 1 else res
