"""The captured forward and backward of a hybridized ``HybridBlock`` (the
counterpart of the JAX package's ``HybridBlock._call_cached``,
``mxnet_tpu/gluon/block.py:453-550``; reference: CachedOp,
src/imperative/cached_op.cc).

The JAX package stages a hybridized block's forward into one
``jax.jit`` computation and, under ``autograd.record()``, differentiates
it as one tape node through ``jax.vjp``. Here the staged forward
(``HybridBlock._staged_call``: the block's forward as a function of
parameter and input tensors, its BatchNorm writes returned rather than
applied) runs as CUDA graphs through ``compile.CapturedProgram``:

- outside ``record()`` (or when nothing needs a gradient) one forward
  program per key;
- under ``record()`` a forward program and a backward program (the
  gradients of the forward's outputs with respect to the parameters and
  inputs that need one), captured on one stream into one memory pool.
  One ``torch.autograd.Function`` a call replays the forward and, when
  autograd reaches it, the backward; the port's ``autograd.backward``
  writes the gradients into the parameters' buffers by their
  ``grad_req``.

A key (``ck`` in ``CachedOp.__call__``) holds the training flag, recording, the
structure, shape, dtype and device of every input, which inputs need a
gradient, and the parameters' dtypes and ``grad_req``s. Each new key
captures anew: the registry counts the programs under kind ``gluon``
and the retrace guard notes the block's entry point. The programs read
the parameters' storage in place; a parameter whose storage moved
(``initialize(force_reinit=True)``, ``reset_ctx``, ``cast``) retires
the programs captured over it.

A forward program's saved activations live in its pool until its
backward runs, so a second call under the same tape must not replay
it: each key holds program *slots*, and a call takes the first slot
whose last forward has been differentiated or whose outputs are gone
(``_Slot.free``), capturing a new slot when none is. A backward through
a slot that a later call has replayed since raises. Outputs and
gradients are copied out of the pool, so a caller may keep them across
calls. Dropout draws from the block's own CUDA generator, registered
with every forward graph: each replay draws anew, and the backward
reads the mask its own forward drew. The BatchNorm writes are outputs
of the forward program, copied into their parameters after the replay.

Each new program first runs the staged call once eagerly on a side
stream (with its backward under ``record()``), which warms cuDNN,
cuBLAS and Triton, and discards what it computed. A capture that fails
raises ``MXNetError``; there is no eager fallback. On the CPU the same
path runs the staged call eagerly and still keys and notes its
programs.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import autograd
from .. import compile as compile_mod
from .. import random as _random
from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["CachedOp"]


# ---------------------------------------------------------------------------
# argument and output structure
# ---------------------------------------------------------------------------
def flatten(obj, leaves):
    """The structure of ``obj`` (NDArrays in tuples and lists, ``None``,
    constants) as a hashable spec; its NDArrays are appended to
    ``leaves``."""
    if isinstance(obj, NDArray):
        leaves.append(obj)
        return "*"
    if isinstance(obj, (tuple, list)):
        kind = "t" if isinstance(obj, tuple) else "l"
        return (kind,) + tuple(flatten(o, leaves) for o in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return ("c", obj)
    raise MXNetError(f"a hybridized block takes NDArrays, lists and tuples "
                     f"of them and scalars; got {type(obj).__name__}")


def unflatten(spec, leaves):
    """Rebuild what ``flatten`` took apart from an iterator of leaves."""
    if spec == "*":
        return next(leaves)
    if spec[0] == "c":
        return spec[1]
    items = [unflatten(s, leaves) for s in spec[1:]]
    return tuple(items) if spec[0] == "t" else items


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------
class _Lease:
    """One forward replay of a slot: the slot is busy until this lease's
    backward has run or the lease (held by the autograd node) is gone."""

    __slots__ = ("generation", "done", "__weakref__")

    def __init__(self, generation):
        self.generation = generation
        self.done = False


class _Slot:
    """One forward program (and, with ``grad``, its backward program) of
    a key, with its static buffers."""

    def __init__(self, entry, index):
        # weak back-references: a dropped CachedOp frees its graphs when
        # its last reference goes, never in a garbage collection that
        # could run inside another program's capture
        self.entry = weakref.proxy(entry)
        self.index = index
        self.generation = 0
        self.lease = None        # weakref to the last forward's _Lease
        self.fwd = self.bwd = None
        self.static_in = ()
        self.outs = ()
        self.writes = ()
        self.diff_out = ()       # positions of the outputs with gradients
        self.grad_out = ()       # static buffers of those gradients
        self.grad_flat = ()      # static gradients, one flat buffer a dtype
        self.grad_split = ()     # (dtype index, offset, shape) per target

    def free(self):
        lease = self.lease() if self.lease is not None else None
        return lease is None or lease.done

    # -- capture -----------------------------------------------------------
    def _forward_body(self, params):
        e = self.entry
        leaves = [t.detach().requires_grad_(g)
                  for t, g in zip(params, e.param_grad)]
        ins = [t.detach().requires_grad_(g)
               for t, g in zip(self.static_in, e.in_grad)]
        with torch.enable_grad() if e.grad else torch.no_grad():
            outs, writes = e.run(leaves, ins, e.op.generator(e.device))
        self._targets = [t for t, g in zip(leaves, e.param_grad) if g] + \
            [t for t, g in zip(ins, e.in_grad) if g]
        return outs, writes

    def _backward_body(self):
        outs = [self.outs[i] for i in self.diff_out]
        gs = torch.autograd.grad(outs, self._targets, self.grad_out,
                                 allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g
              for g, t in zip(gs, self._targets)]
        dtypes = []
        for g in gs:
            if g.dtype not in dtypes:
                dtypes.append(g.dtype)
        flats = [torch.cat([g.reshape(-1) for g in gs if g.dtype == dt])
                 for dt in dtypes]
        split, offsets = [], [0] * len(dtypes)
        for g in gs:
            k = dtypes.index(g.dtype)
            split.append((k, offsets[k], tuple(g.shape)))
            offsets[k] += g.numel()
        self.grad_split = split
        return flats

    def capture(self, params, inputs):
        """Warm up, then capture the forward (and backward) programs."""
        e = self.entry
        dev = e.device
        self.static_in = [torch.empty_like(t) for t in inputs]
        for s, t in zip(self.static_in, inputs):
            s.copy_(t)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            outs, _ = self._forward_body(params)
            if e.grad:
                diff = [o for o in outs if o.requires_grad]
                if diff:
                    torch.autograd.grad(diff, self._targets,
                                        [torch.ones_like(o) for o in diff],
                                        allow_unused=True)
        main.wait_stream(side)
        del outs
        stream = torch.cuda.Stream(dev)
        gens = (e.op.generator(e.device),)
        self.fwd = compile_mod.CapturedProgram(e.key("forward", self.index))
        try:
            self.outs, self.writes = self.fwd.capture(
                lambda: self._forward_body(params),
                capture_error_mode="thread_local", generators=gens,
                arguments=params, stream=stream)
            self.fwd.static = tuple(self.static_in)
            self.diff_out = [i for i, o in enumerate(self.outs)
                             if o.requires_grad]
            if e.grad and self.diff_out:
                self.grad_out = [torch.zeros_like(self.outs[i])
                                 for i in self.diff_out]
                self.bwd = compile_mod.CapturedProgram(
                    e.key("backward", self.index), pool=self.fwd.graph.pool())
                self.grad_flat = self.bwd.capture(
                    self._backward_body, capture_error_mode="thread_local",
                    arguments=params, stream=stream)
        except Exception as err:
            raise MXNetError(
                f"capturing {e.name} as a CUDA graph failed (no eager "
                f"fallback; a host sync such as asnumpy() or a "
                f"data-dependent shape inside a hybridized forward cannot "
                f"be captured): {err}") from err
        self._targets = None

    # -- replay ------------------------------------------------------------
    def forward(self, inputs):
        """Replay the forward on ``inputs``: fresh copies of the outputs,
        the BatchNorm writes applied, and the lease of this replay."""
        for s, t in zip(self.static_in, inputs):
            if s.data_ptr() != t.data_ptr():
                s.copy_(t, non_blocking=True)
        self.fwd.replay()
        outs = [o.clone() for o in self.outs]
        if self.writes:
            with torch.no_grad():
                torch._foreach_copy_(
                    [p._check_and_get()._data for p, _ in self.writes],
                    [w for _, w in self.writes])
        self.generation += 1
        lease = _Lease(self.generation)
        self.lease = weakref.ref(lease)
        return outs, lease

    def backward(self, lease, grads):
        """Replay the backward for the forward of ``lease`` with the
        outputs' gradients ``grads``; fresh gradient tensors, one per
        target (parameters, then inputs, that need one)."""
        if lease.generation != self.generation:
            raise MXNetError(
                f"{self.entry.name}: a backward through a captured forward "
                "whose program a later call has replayed since (a second "
                "backward with retain_graph after the block ran again)")
        for buf, i in zip(self.grad_out, self.diff_out):
            g = grads[i]
            if g is None:
                buf.zero_()
            else:
                buf.copy_(g, non_blocking=True)
        self.bwd.replay()
        lease.done = True
        flats = [f.clone() for f in self.grad_flat]
        return [flats[k].narrow(0, off, int(np.prod(shape, dtype=np.int64)))
                .view(shape) for k, off, shape in self.grad_split]


class _Replay(torch.autograd.Function):
    """One call of a captured block inside torch's graph: the forward
    replays the slot's forward program, the backward its backward
    program. Inputs: the parameter tensors and the input tensors that
    need a gradient (``targets``), then every input."""

    @staticmethod
    def forward(ctx, slot, n_targets, *tensors):
        outs, lease = slot.forward(tensors[n_targets:])
        ctx.slot, ctx.lease, ctx.n_targets = slot, lease, n_targets
        ctx.n_inputs = len(tensors) - n_targets
        ctx.mark_non_differentiable(*[o for i, o in enumerate(outs)
                                      if i not in slot.diff_out])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        gs = ctx.slot.backward(ctx.lease, grads)
        return (None, None) + tuple(gs) + (None,) * ctx.n_inputs


class _Entry:
    """The programs of one key."""

    def __init__(self, op, ck, training, recording, spec, inputs, in_grad,
                 params, param_grad):
        self.op = weakref.proxy(op)
        self.ck = ck
        self.name = f"gluon:{op.block.name}"
        self.training = training
        self.recording = recording
        self.spec = spec
        self.in_grad = in_grad
        self.param_grad = param_grad
        self.grad = any(in_grad) or any(param_grad)
        self.ptrs = [t.data_ptr() for t in params]
        self.dtypes = tuple(t.dtype for t in params)
        self.device = (params[0] if params else inputs[0]).device
        self.sig = compile_mod.arg_signature(inputs)
        self.out_spec = None
        self.slots = []
        self._keys = {}

    def key(self, part="forward", slot=0):
        """The registry key of this entry's ``part`` program in
        ``slot``."""
        k = self._keys.get((part, slot))
        if k is None:
            plist = self.op.param_list
            k = self._keys[(part, slot)] = compile_mod.program_key(
                "gluon", self.name, input_sigs=self.sig, device=self.device,
                extra={"program": part, "slot": slot,
                       "training": self.training,
                       "recording": self.recording,
                       "structure": repr(self.spec),
                       "inputs_need_grad": list(self.in_grad),
                       "params": [(p.name, str(t), p.grad_req)
                                  for p, t in zip(plist, self.dtypes)]})
        return k

    def run(self, params, inputs, generator):
        """The staged call on tensors: ``(flat outputs, [(Parameter,
        write)])``."""
        args = unflatten(self.spec, iter([NDArray(t) for t in inputs]))
        out, writes = self.op.block._staged_call(
            self.op.param_list, params, args, self.training, generator)
        leaves = []
        out_spec = flatten(out, leaves)
        if self.out_spec is None:
            self.out_spec = out_spec
        return tuple(o._data for o in leaves), tuple(writes)

    def call_eager(self, params, inputs):
        with torch.enable_grad() if self.grad else torch.no_grad():
            outs, writes = self.run(params, inputs, None)
        with torch.no_grad():
            for p, w in writes:
                p._check_and_get()._data.copy_(w.detach())
        return outs

    def call_captured(self, params, inputs):
        if not self.grad:
            slot = self.slots[0] if self.slots else self._new_slot(params,
                                                                   inputs)
            return slot.forward(inputs)[0]
        slot = self.op._free_slot(self) or self._new_slot(params, inputs)
        targets = [t for t, g in zip(params, self.param_grad) if g] + \
            [t for t, g in zip(inputs, self.in_grad) if g]
        with torch.enable_grad():
            return _Replay.apply(slot, len(targets), *targets, *inputs)

    def _new_slot(self, params, inputs):
        slot = _Slot(self, len(self.slots))
        with torch.cuda.device(self.device):
            slot.capture(params, inputs)
        self.slots.append(slot)
        return slot


class CachedOp:
    """The captured programs of one hybridized block (see the module
    docstring); ``HybridBlock._clear_cached_op`` drops it."""

    def __init__(self, block):
        self.block = block
        self.param_list = block._get_param_list()
        self.entries = {}
        self._gen = None

    def generator(self, device):
        """The block's CUDA generator (seeded from the port's CPU
        generator at first use), which every forward graph registers."""
        if self._gen is None:
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=_random.generator("cpu")))
            self._gen = torch.Generator(device=device)
            self._gen.manual_seed(seed)
        return self._gen

    @staticmethod
    def _free_slot(entry):
        """The first slot of ``entry`` free for a new forward, or None."""
        return next((s for s in entry.slots if s.free()), None)

    def __call__(self, *args):
        leaves = []
        spec = flatten(args, leaves)
        inputs = [a._data for a in leaves]
        params = [p._check_and_get()._data for p in self.param_list]
        training = autograd.is_training()
        recording = autograd.is_recording()
        param_grad = [recording and p.grad_req != "null" and t.requires_grad
                      for p, t in zip(self.param_list, params)]
        in_grad = [recording and t.requires_grad for t in inputs]
        ck = (training, recording, spec,
              tuple((tuple(t.shape), t.dtype, t.device, g)
                    for t, g in zip(inputs, in_grad)),
              tuple((t.dtype, p.grad_req)
                    for p, t in zip(self.param_list, params)))
        entry = self.entries.get(ck)
        if entry is not None and entry.ptrs != [t.data_ptr()
                                                for t in params]:
            # a parameter's storage moved: its programs read the old one
            entry = None
        if entry is None:
            entry = self.entries[ck] = _Entry(
                self, ck, training, recording, spec, inputs, in_grad,
                params, param_grad)
            key = entry.key()
            compile_mod.note_entry_point(entry.name, key, entry.sig)
        if entry.device.type == "cuda":
            outs = entry.call_captured(params, inputs)
        else:
            outs = entry.call_eager(params, inputs)
        res = unflatten(entry.out_spec, iter([NDArray(o) for o in outs]))
        return res
