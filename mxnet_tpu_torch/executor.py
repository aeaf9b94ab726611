"""Executor: a bound symbolic computation (counterpart of
``mxnet_tpu/executor.py``; reference: python/mxnet/executor.py —
forward :113, backward :154, reshape :371).

``build_graph_fns(sym)`` gives the forward and the forward-plus-loss
functions that the bound ``Executor`` and the fused training step
differentiate. The loss is each implicit-loss head's loss over the
head's input (SoftmaxOutput: cross-entropy whose gradient is p - y; the
regression heads; SVMOutput's hinge), plus ``sum(out * head_grad)`` for
every other output given an explicit head gradient
(``backward(out_grads)``), so its gradient wrt the arguments is the
reference backward. The head inputs are taken from the same walk as the
outputs, never recomputed.

``Executor`` (``Symbol.simple_bind`` / ``bind``) holds NDArrays for the
arguments, their gradients and the aux states. At bind the rewrite
pipeline runs on the bound shapes: ``train`` mode under the tag
``executor``, or ``infer`` under ``executor_infer`` when every
grad_req is ``'null'``; a pass that fails for a CUDA bind raises.
``forward(is_train)`` runs the forward program and folds the BatchNorm
running statistics into the aux arrays when training; ``backward``
runs the grad program, which walks its own training forward (so the
statistics are folded again, as the reference does), and writes or
adds each gradient by its grad_req.

On a CUDA device each program is a captured CUDA graph (the forward per
``is_train`` flag, the grad program with and without head gradients):
the first run at a program eager on a side stream, the second captures,
later ones replay. The programs come from ``compile.shared_programs``
under the bind's program key, so executors with equal keys share them;
a program owns its static inputs, and the executor copies its arrays
in before a replay and the results out after it, into the same storage
(``arg_dict[n][:] = x``, ``copy_params_from`` and the Updater's writes
never rebind an array). The one rebinding: an input that ``forward``
gets in another floating dtype than its array's (a bf16 batch into a
float32 bind; float64 excepted, which JAX makes float32) replaces the
array by a copy in that dtype, as the JAX package's executor computes in
the dtype it is fed; the program's signature changes with it, so the
program is captured anew. A capture that fails raises. Each capture
registers the device's explicit generator (``random.generator(device)``:
``use_generator``'s, inside it), which the graph's samplers and Dropout
draw from, so each replay draws anew, ``random.seed`` reproduces a run,
and the eager and captured runs of one seeded program draw the same
numbers. Captures run in ``capture_error_mode="thread_local"``, so that
a ``DataPipeline``'s stager thread may pin and copy the next batch
meanwhile (the global mode would let its calls invalidate the capture).
``captured = False`` runs the same programs eagerly (an A/B on one
tree); the CPU always does.

A Monitor (``set_monitor_callback``) sees the outputs, or with
``monitor_all`` every op output from an interpreted walk of the original
graph, on the batches it is active for.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import random as _random
from .base import MXNetError
from .ops import nn as _nn
from .ops.registry import parse_attr

__all__ = ["Executor", "build_graph_fns", "collect_loss_specs",
           "total_implicit_loss"]


def _linreg_loss(data, label, grad_scale=1.0, **kw):
    return grad_scale * 0.5 * torch.sum(
        torch.square(data - label.reshape(data.shape)))


def _maereg_loss(data, label, grad_scale=1.0, **kw):
    return grad_scale * torch.sum(torch.abs(data - label.reshape(data.shape)))


def _logreg_loss(data, label, grad_scale=1.0, **kw):
    # its gradient is sigmoid(x) - y
    x, y = data, label.reshape(data.shape)
    return grad_scale * torch.sum(
        torch.relu(x) - x * y + torch.log1p(torch.exp(-torch.abs(x))))


def _svm_loss(data, label, margin=1.0, regularization_coefficient=1.0,
              use_linear=False, **kw):
    """One-vs-rest hinge: the true class's score pushed above +margin,
    every other below -margin (reference: src/operator/svm_output.cc)."""
    onehot = F.one_hot(label.to(torch.int64), data.shape[-1]).to(data.dtype)
    viol = torch.clamp_min(margin - data, 0.0) * onehot + \
        torch.clamp_min(margin + data, 0.0) * (1.0 - onehot)
    per = torch.sum(viol) if use_linear else torch.sum(torch.square(viol))
    return regularization_coefficient * per


# output-layer ops whose backward is the gradient of an implicit loss
_IMPLICIT_LOSS = {
    "SoftmaxOutput": _nn.softmax_output_loss,
    "Softmax": _nn.softmax_output_loss,
    "LinearRegressionOutput": _linreg_loss,
    "MAERegressionOutput": _maereg_loss,
    "LogisticRegressionOutput": _logreg_loss,
    "SVMOutput": _svm_loss,
}


def collect_loss_specs(sym):
    """(output_index, head node, parsed attrs) for every implicit-loss
    head."""
    specs = []
    for i, h in enumerate(sym._output_symbols()):
        node = h._node
        if node.op in _IMPLICIT_LOSS:
            attrs = {k: parse_attr(v) for k, v in node.attrs.items()
                     if not k.startswith("__")}
            specs.append((i, node, attrs))
    return specs


def total_implicit_loss(loss_specs, head_inputs, device, outs=(),
                        head_grads=None):
    """Scalar fp32 training loss: each implicit head's loss over its
    input values, plus ``sum(out * head_grad)`` for every other output
    given a head gradient."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for (_, node, attrs), ins in zip(loss_specs, head_inputs):
        total = total + _IMPLICIT_LOSS[node.op](*ins, **attrs).float()
    if head_grads is not None:
        implicit = {i for i, _, _ in loss_specs}
        for i, o in enumerate(outs):
            if i not in implicit and i < len(head_grads) and \
                    head_grads[i] is not None:
                total = total + torch.sum(o * head_grads[i]).float()
    return total


def build_graph_fns(sym):
    """Pure forward / forward-with-loss functions of ``sym``:
    ``(fwd, fwd_loss, loss_specs)``.

        fwd(arg_vals, aux_vals, training) -> (outs, aux_updates)
        fwd_loss(arg_vals, aux_vals, head_grads=None, preset=None)
            -> (scalar, (outs, aux_updates))

    ``arg_vals``/``aux_vals`` follow ``sym.list_arguments()`` /
    ``list_auxiliary_states()``; ``fwd_loss`` walks in training mode;
    ``preset`` seeds node outputs (``Symbol.eval_arrays_ex``: the fused
    step's row-sparse sites)."""
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    loss_specs = collect_loss_specs(sym)
    heads = [[(p, oi) for p, oi in node.inputs]
             for _, node, _ in loss_specs]
    flat_heads = [h for hs in heads for h in hs]

    def _amap(arg_vals, aux_vals):
        amap = dict(zip(arg_names, arg_vals))
        amap.update(zip(aux_names, aux_vals))
        return amap

    def fwd(arg_vals, aux_vals, training):
        outs, aux_updates, _ = sym.eval_arrays_ex(
            _amap(arg_vals, aux_vals), training=training)
        return tuple(outs), aux_updates

    def fwd_loss(arg_vals, aux_vals, head_grads=None, preset=None):
        outs, aux_updates, captured = sym.eval_arrays_ex(
            _amap(arg_vals, aux_vals), training=True, preset=preset,
            capture=flat_heads)
        head_inputs, k = [], 0
        for hs in heads:
            head_inputs.append(captured[k:k + len(hs)])
            k += len(hs)
        total = total_implicit_loss(loss_specs, head_inputs,
                                    outs[0].device if outs else None,
                                    outs, head_grads)
        return total, (tuple(outs), aux_updates)

    return fwd, fwd_loss, loss_specs


def _as_tensor(value, like):
    """``value`` (NDArray, tensor, numpy or number) as a tensor on
    ``like``'s device and dtype."""
    if hasattr(value, "_data"):
        value = value._data
    if not isinstance(value, torch.Tensor):
        import numpy as np
        value = torch.as_tensor(np.asarray(value))
    return value.detach().to(device=like.device, dtype=like.dtype)


class _Programs:
    """An executor key's programs: the graph functions of the rewritten
    symbol and, on the card, one CapturedProgram per program kind."""

    def __init__(self, run_sym, key_of):
        self.fwd, self.fwd_loss, self.loss_specs = build_graph_fns(run_sym)
        self.key_of = key_of      # kind -> ProgramKey
        self.captured = {}        # kind -> CapturedProgram
        self.warm = set()         # kinds that ran their warm step


class Executor:
    """A bound computation graph (reference: executor.py:30)."""

    def __init__(self, symbol, ctx, arg_dict, args_grad, grad_req,
                 aux_dict):
        from .context import as_device
        self._symbol = symbol
        self._device = as_device(ctx)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = {n: self._nd(v) for n, v in dict(arg_dict).items()}
        self.aux_dict = {n: self._nd(v) for n, v in
                         dict(aux_dict or {}).items()}
        self.grad_dict = {n: self._nd(v) for n, v in
                          dict(args_grad or {}).items()}
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self.arg_names}
        else:
            self.grad_req = {n: grad_req.get(n, "null")
                             for n in self.arg_names}
        for n, r in self.grad_req.items():
            if r not in ("write", "add", "null"):
                raise MXNetError(f"grad_req {r!r} for '{n}': expected "
                                 "'write', 'add' or 'null'")
        self.outputs = []
        self._monitor_callback = None
        self._monitor_all = False
        self.captured = self._device.type == "cuda"
        self._build()

    def _nd(self, v):
        from .ndarray import NDArray
        if isinstance(v, NDArray):
            return v
        if isinstance(v, torch.Tensor):
            return NDArray(v.detach())
        import numpy as np
        return NDArray(torch.as_tensor(np.asarray(v), device=self._device))

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    @property
    def output_dict(self):
        return dict(zip(self.output_names, self.outputs))

    @property
    def pass_report(self):
        """The rewrite pipeline's report of this bind."""
        return self._pass_report

    # -- build ----------------------------------------------------------------
    def _grad_names(self):
        return [n for n in self._run_arg_names
                if self.grad_req.get(n, "null") != "null"
                and n in self.grad_dict]

    def _build(self):
        """Run the rewrite pipeline on the bound shapes and acquire the
        programs of this bind's key (shared with equal binds)."""
        from . import compile as compile_mod
        from . import config
        from .symbol import passes as _passes
        infer_only = all(r == "null" for r in self.grad_req.values())
        kind = "executor_infer" if infer_only else "executor"
        arrays = list(self.arg_dict.items()) + list(self.aux_dict.items())
        shapes = {n: tuple(a.shape) for n, a in arrays}
        fused_sym, self._pass_report = _passes.apply_pipeline(
            self._symbol, shapes, tag=kind,
            mode="infer" if infer_only else "train", device=self._device)
        run_sym = fused_sym if fused_sym is not None else self._symbol
        self._run_arg_names = run_sym.list_arguments()
        self._run_aux_names = run_sym.list_auxiliary_states()
        sigs = sorted((n, tuple(a.shape), str(a._data.dtype))
                      for n, a in arrays)
        fusion_report = _passes.legacy_fusion_entry(self._pass_report)
        fusion = {"flag": str(config.get("MXTPU_PALLAS_FUSION")),
                  "sites": len(fusion_report["sites"])
                  if fusion_report else 0}
        symbol_sha = compile_mod.symbol_digest(self._symbol)
        materials = dict(symbol_sha=symbol_sha, input_sigs=sigs,
                         fusion=fusion,
                         passes=_passes.pipeline_key_material(
                             self._pass_report), device=self._device)
        grad_req = sorted(self.grad_req.items())
        # the grad program returns one gradient per name here, in this
        # order: binds whose gradient arrays differ need their own
        grads = sorted((n, str(self.grad_dict[n]._data.dtype))
                       for n in self._grad_names())
        base = f"executor:{self._symbol.name}"

        def key_of(prog):
            return compile_mod.program_key(
                kind, f"{base}:{prog}", **materials,
                extra={"prog": prog, "grad_req": grad_req, "grads": grads})

        self._key = key_of("bind")
        self._progs, self.shared = compile_mod.shared_programs(
            self._key, lambda: _Programs(run_sym, key_of))

    # -- running a program ----------------------------------------------------
    def _inputs(self, head_grads=None):
        """{name: tensor} the programs read: arguments and aux in the
        rewritten graph's order, then the head gradients."""
        vals = {}
        for n in self._run_arg_names:
            if n not in self.arg_dict:
                raise MXNetError(f"missing argument '{n}' for the bound "
                                 "graph")
            vals[n] = self.arg_dict[n]._data
        for n in self._run_aux_names:
            vals[n] = self.aux_dict[n]._data
        for i, g in enumerate(head_grads or ()):
            if g is not None:
                vals[f"__head_grad{i}"] = g
        return vals

    def _body(self, kind, vals):
        """One program on input tensors ``vals``: a dict of outputs."""
        p = self._progs
        args = [vals[n] for n in self._run_arg_names]
        aux = [vals[n] for n in self._run_aux_names]
        if kind.startswith("fwd"):
            with torch.no_grad():
                outs, aux_up = p.fwd(args, aux, kind == "fwd_train")
            return {"outs": list(outs), "aux": dict(aux_up)}
        names = self._grad_names()
        heads = None
        if kind == "grad_head":
            heads = [vals.get(f"__head_grad{i}")
                     for i in range(len(self.output_names))]
        leaves = [a.detach().requires_grad_(n in names)
                  for n, a in zip(self._run_arg_names, args)]
        with torch.enable_grad():
            total, (outs, aux_up) = p.fwd_loss(leaves, aux, heads)
            want = [leaves[self._run_arg_names.index(n)] for n in names]
            grads = torch.autograd.grad(total, want, allow_unused=True,
                                        materialize_grads=True) \
                if want else ()
        return {"outs": [o.detach() for o in outs], "grads": list(grads),
                "aux": {k: v.detach() for k, v in aux_up.items()}}

    def _run(self, kind, head_grads=None):
        """Run program ``kind`` (``fwd_eval``, ``fwd_train``, ``grad``,
        ``grad_head``): eagerly, or on the card as its captured graph
        (see the module docstring). The result's tensors are the
        program's: read them before the next run."""
        from . import compile as compile_mod
        vals = self._inputs(head_grads)
        if not self.captured:
            return self._body(kind, vals)
        progs = self._progs
        sig = compile_mod.arg_signature(list(vals.values()))
        key = progs.key_of(kind)
        prog = progs.captured.get(kind)
        if prog is None or prog.static_sig != sig:
            compile_mod.note_entry_point(key.name, key, sig)
            prog = progs.captured[kind] = compile_mod.CapturedProgram(key)
            prog.static_sig = sig
        if kind not in progs.warm:
            progs.warm.add(kind)
            return self._warm(kind, vals)
        if not prog.captured:
            prog.static = {n: torch.empty_like(v) for n, v in vals.items()}
            for n, v in vals.items():
                prog.static[n].copy_(v)
            try:
                prog.capture(lambda: self._body(kind, prog.static),
                             capture_error_mode="thread_local",
                             generators=(_random.generator(self._device),))
            except Exception as e:
                raise MXNetError(f"capturing the executor program "
                                 f"{key.name} as a CUDA graph failed: "
                                 f"{e}") from e
        else:
            for n, v in vals.items():
                prog.static[n].copy_(v)
        prog.replay()
        return prog.outputs

    def _warm(self, kind, vals):
        """The first run of a program: eager, on a side stream (it warms
        the kernels' builds, Triton's JIT and cuDNN's choices)."""
        main = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            res = self._body(kind, vals)
        main.wait_stream(side)
        for v in res.values():
            for t in (v.values() if isinstance(v, dict) else v):
                t.record_stream(main)
        return res

    def _apply_aux_updates(self, aux_up):
        """Fold the BatchNorm running statistics into the aux arrays, in
        place."""
        with torch.no_grad():
            for name, val in aux_up.items():
                if name in self.aux_dict:
                    self.aux_dict[name]._data.copy_(val)

    # -- execution ------------------------------------------------------------
    def _monitor_now(self):
        cb = self._monitor_callback
        if cb is None:
            return False
        active = getattr(cb, "active", None)
        return active is None or active()

    def forward(self, is_train=False, **kwargs):
        """Run the forward (reference: executor.py:113); ``kwargs``
        arrays are copied into the bound arguments first."""
        from .ndarray import NDArray
        for name, arr in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError(f"Unknown argument {name}")
            self._feed(self.arg_dict[name], arr)
        self._is_train = is_train
        monitor_now = self._monitor_now()
        if monitor_now and self._monitor_all:
            internals = {}
            amap = {n: a._data for n, a in self.arg_dict.items()}
            amap.update({n: a._data for n, a in self.aux_dict.items()})
            with torch.no_grad():
                outs, aux_up, _ = self._symbol.eval_arrays_ex(
                    amap, training=bool(is_train), internals=internals)
            for name, o in internals.items():
                self._monitor_callback(name, NDArray(o))
        else:
            res = self._run("fwd_train" if is_train else "fwd_eval")
            outs, aux_up = res["outs"], res["aux"]
        self.outputs = [NDArray(o.clone()) for o in outs]
        self._apply_aux_updates(aux_up)
        if monitor_now and not self._monitor_all:
            for name, o in zip(self.output_names, self.outputs):
                self._monitor_callback(name, o)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """The gradients of the implicit losses (and of
        ``sum(out * out_grad)`` for the other outputs), written or added
        into ``grad_dict`` by grad_req (reference: executor.py:154)."""
        from .ndarray import NDArray
        heads = None
        if out_grads is not None:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            heads = [None if g is None else
                     _as_tensor(g, torch.empty(0, device=self._device))
                     .float() for g in out_grads]
        res = self._run("grad" if heads is None else "grad_head", heads)
        self.outputs = [NDArray(o.clone()) for o in res["outs"]]
        self._apply_aux_updates(res["aux"])
        with torch.no_grad():
            for name, g in zip(self._grad_names(), res["grads"]):
                tgt = self.grad_dict[name]._data
                if self.grad_req[name] == "add":
                    tgt.add_(g.to(tgt.dtype))
                else:
                    tgt.copy_(g)

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` on the outputs, or with
        ``monitor_all`` on every op output, of each forward the callback
        is active for (its ``active()``, when it has one)."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    def _feed(self, tgt, value):
        """An input for ``forward``: copied into ``tgt``, or, in another
        floating dtype than float64 and ``tgt``'s, ``tgt`` rebound to a
        copy in that dtype (see the module docstring)."""
        src = getattr(value, "_data", value)
        if isinstance(src, torch.Tensor) and src.is_floating_point() \
                and tgt._data.is_floating_point() \
                and src.dtype not in (tgt._data.dtype, torch.float64) \
                and tuple(src.shape) == tuple(tgt.shape):
            tgt._data = src.detach().to(tgt._data.device, copy=True)
            return
        self.assign_array(tgt, value)

    def assign_array(self, tgt, value):
        """Copy ``value`` into the bound array ``tgt``'s storage."""
        src = _as_tensor(value, tgt._data)
        if tuple(src.shape) != tuple(tgt._data.shape):
            raise MXNetError(f"cannot assign shape {tuple(src.shape)} to a "
                             f"bound array of shape {tuple(tgt.shape)}")
        with torch.no_grad():
            tgt._data.copy_(src)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameters into the bound arrays (reference:
        executor.py:326)."""
        for name, array in arg_params.items():
            if name in self.arg_dict:
                self.assign_array(self.arg_dict[name], array)
            elif not allow_extra_params:
                raise ValueError(f"Found name \"{name}\" that is not in the "
                                 "arguments")
        for name, array in (aux_params or {}).items():
            if name in self.aux_dict:
                self.assign_array(self.aux_dict[name], array)
            elif not allow_extra_params:
                raise ValueError(f"Found name \"{name}\" that is not in "
                                 "the auxiliary states")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new input shapes (reference:
        executor.py:371): arrays whose shape is unchanged are shared,
        the others and every gradient are fresh; the Monitor carries
        over."""
        from .ndarray import NDArray
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def fresh(s):
            return NDArray(torch.zeros(s, dtype=torch.float32,
                                       device=self._device))

        new_args = {n: self.arg_dict[n] if tuple(self.arg_dict[n].shape)
                    == tuple(s) else fresh(s)
                    for n, s in zip(self.arg_names, arg_shapes)}
        new_grads = {n: fresh(s) for n, s in zip(self.arg_names, arg_shapes)
                     if n in self.grad_dict}
        new_aux = {n: self.aux_dict[n] if tuple(self.aux_dict[n].shape)
                   == tuple(s) else fresh(s)
                   for n, s in zip(self.aux_names, aux_shapes)}
        new_exec = Executor(self._symbol, self._device, new_args, new_grads,
                            self.grad_req, new_aux)
        new_exec._monitor_callback = self._monitor_callback
        new_exec._monitor_all = self._monitor_all
        new_exec.captured = self.captured
        return new_exec
