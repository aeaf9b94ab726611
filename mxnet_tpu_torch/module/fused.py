"""The fused training step of the symbolic Module (counterpart of
``mxnet_tpu/module/fused.py``), on one device.

``FusedSymbolStep.step`` runs a whole batch: the forward of the
rewritten graph in the compute dtype, the implicit-loss backward
(autograd), the optimizer update of the fp32 master weights and the
BatchNorm running-statistics fold. The rewrite passes run once, in
``train`` mode, at ``start``; on a CUDA device a pass that fails raises
(pass manager), so the step never trains on library ops in place of the
kernels.

On a CUDA device the step is a captured program, as the JAX package's is
one compiled XLA program: one CUDA graph per feed signature, keyed by
``compile.program_key("fused_step", ...)`` and noted by the retrace
guard. The first step at a signature runs eagerly on a side stream (it
warms Triton's JIT, the kernels' builds and attributes, cuDNN's
algorithm choice and the autograd engine's device thread); the next one
copies the feed into static input buffers, captures the step and
replays it; every later one is the copy, then ``replay()``. The base
learning rate is a 0-dim fp32 device scalar (``set_lr``, written before
each step) that the graph reads, so a schedule never needs a new capture.
A replay's outputs live in the graph's memory and the next replay
overwrites them: ``step`` returns copies, and ``last_loss`` is one. A
capture that fails raises; there is no fallback to the eager step. The
CPU runs ``step_eager``, the same arithmetic without a graph.

Dtype flow (the JAX package's): fp32 master params, optimizer state
and aux; with a ``compute_dtype`` every fp32 param, aux and input is
cast to it for the step, the gradients come back in fp32 (through the
cast), and the fold ``m*old + (1-m)*batch_stat`` is taken in the
compute dtype and stored in fp32.

Not ported (ROADMAP queue A): the device mesh and data-parallel batch
sharding, the ZeRO-1 sharded update, partition rules, row-sparse
embedding routing, in-step metric counters, the persistent program cache
(a CUDA graph cannot be serialized), the non-finite step guard
(``MXTPU_FT_GUARD``) and small-parameter packing.
"""
from __future__ import annotations

import torch

from .. import compile as compile_mod
from .. import config
from ..base import MXNetError, torch_dtype
from ..context import as_device
from ..executor import build_graph_fns
from ..parallel import functional_opt

__all__ = ["FusedSymbolStep"]


class FusedSymbolStep:
    """Forward + backward + update + aux fold of a bound Symbol.

    Owns the fp32 master parameters, the optimizer state, the aux states
    and the learning-rate scalar on ``device`` (by default the current
    context's, ``cuda:0``, which raises without a card) between steps;
    ``params()`` hands them out. They keep their storage for the step's
    life (a captured graph holds their addresses): ``load_params`` copies
    into them. The masters take no gradient themselves; each training forward
    differentiates leaves that alias them."""

    def __init__(self, symbol, data_names, label_names, param_names,
                 aux_names, trainable, optimizer, compute_dtype=None,
                 device=None):
        self.symbol = symbol
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.param_names = list(param_names)
        self.aux_names = list(aux_names)
        self.input_names = [n for n in symbol.list_arguments()
                            if n not in set(param_names)]
        self.trainable = dict(trainable)
        self.optimizer = optimizer
        self.compute_dtype = torch_dtype(compute_dtype)
        self.device = as_device(device)
        self._fopt = functional_opt.from_optimizer(optimizer)
        self._lr_mults = {n: optimizer.lr_mult.get(n, 1.0)
                          for n in self.param_names}
        self._wd_eff = {n: optimizer.wd * optimizer.wd_mult.get(n, 1.0)
                        for n in self.param_names}
        self.pass_report = None
        self._fwd = self._fwd_loss = None
        self._run_arg_names = symbol.list_arguments()
        self._run_aux_names = list(aux_names)
        self._p = self._state = self._aux = None
        self._leaves = None      # the last training forward's param leaves
        self._lr = None
        self._groups = None
        self._programs = {}      # feed signature -> CapturedProgram
        self._symbol_sha = None
        self.last_loss = None
        self.num_update = 0

    @property
    def started(self):
        return self._p is not None

    @property
    def captured(self):
        """True when the step runs as a captured CUDA graph."""
        return self.device.type == "cuda"

    def start(self, arg_dict, aux_dict, input_shapes):
        """Run the ``train``-mode rewrite pipeline on the bound shapes
        (``input_shapes``: {input name: shape}) and take fp32 copies of
        the initial params and aux on the device."""
        from ..symbol import passes as _passes
        shapes = {n: tuple(d[n].shape)
                  for d in (arg_dict, aux_dict) for n in d}
        shapes.update({n: tuple(s) for n, s in input_shapes.items()})
        fused_sym, self.pass_report = _passes.apply_pipeline(
            self.symbol, shapes, tag="fused_step", mode="train",
            device=self.device, compute_dtype=self.compute_dtype,
            data_names=set(self.data_names) | set(self.label_names))
        run_sym = fused_sym if fused_sym is not None else self.symbol
        self._fwd, self._fwd_loss, _ = build_graph_fns(run_sym)
        self._run_arg_names = run_sym.list_arguments()
        self._run_aux_names = run_sym.list_auxiliary_states()
        self.load_params(arg_dict, aux_dict)
        self._state = {n: self._fopt.init(self._p[n])
                       for n in self.param_names if self.trainable[n]}
        self._lr = torch.full((), float(self.optimizer.lr),
                              dtype=torch.float32, device=self.device)
        # params sharing (lr_mult, wd) update together: one foreach
        # launch per operation per group
        groups = {}
        for n in self.param_names:
            if self.trainable[n]:
                groups.setdefault((self._lr_mults[n], self._wd_eff[n]),
                                  []).append(n)
        self._groups = sorted(groups.items())

    def load_params(self, arg_dict, aux_dict):
        """Set the master params and aux (optimizer state is kept): the
        first call allocates them, later ones copy into them in place."""
        if self._p is None:
            self._p = {n: arg_dict[n].detach().to(
                self.device, torch.float32, copy=True)
                for n in self.param_names}
            self._aux = {n: aux_dict[n].detach().to(
                self.device, torch.float32, copy=True)
                for n in self.aux_names}
            return
        with torch.no_grad():
            for n in self.param_names:
                self._p[n].copy_(arg_dict[n].detach())
            for n in self.aux_names:
                self._aux[n].copy_(aux_dict[n].detach())

    def params(self):
        """(arg_params, aux_params): the fp32 masters and aux."""
        return dict(self._p), dict(self._aux)

    def set_lr(self, lr):
        """Write the base learning rate (the schedule's value) into the
        step's device scalar, in stream order before the next step."""
        self._lr.fill_(float(lr))

    def _cast(self, v):
        cdt = self.compute_dtype
        return v.to(cdt) if cdt is not None and v.dtype == torch.float32 \
            else v

    def _inputs(self, feed):
        """{input name: tensor} of ``feed``, where it lies."""
        vals = {}
        for n in self.input_names:
            if n not in feed:
                raise MXNetError(f"fused step missing input '{n}'")
            v = feed[n]
            vals[n] = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(v)
        return vals

    def _on_device(self, vals):
        return {n: v.to(self.device, non_blocking=True)
                for n, v in vals.items()}

    def _values(self, vals, params=None):
        """Graph argument and aux values from device inputs ``vals`` and
        ``params`` (default: the masters)."""
        params = self._p if params is None else params
        arg_vals = [self._cast(params[n]) if n in params
                    else self._cast(vals[n]) for n in self._run_arg_names]
        aux_vals = [self._cast(self._aux[n]) for n in self._run_aux_names]
        return arg_vals, aux_vals

    def forward(self, feed, training=False):
        """The graph's outputs on the current params, without a gradient
        or an update (training: batch statistics, no aux fold)."""
        with torch.no_grad():
            arg_vals, aux_vals = self._values(
                self._on_device(self._inputs(feed)))
            outs, _ = self._fwd(arg_vals, aux_vals, training)
        return list(outs)

    def _forward_loss(self, vals):
        """The recorded forward. It differentiates fresh leaves that alias
        the masters (``detach``: no copy), made anew each step: autograd
        ties a leaf's gradient accumulator to the stream it was made on,
        and a capture must not reach back to one made by an earlier
        step on another stream."""
        self._leaves = {n: p.detach().requires_grad_(self.trainable[n])
                        for n, p in self._p.items()}
        with torch.enable_grad():
            arg_vals, aux_vals = self._values(vals, self._leaves)
            loss, (outs, aux_up) = self._fwd_loss(arg_vals, aux_vals)
        return loss, outs, aux_up

    def forward_loss(self, feed):
        """The training forward on ``feed``, recorded for the backward:
        ``(loss, outputs, aux_updates)``."""
        if not self.started:
            raise MXNetError("FusedSymbolStep used before start()")
        return self._forward_loss(self._on_device(self._inputs(feed)))

    def backward(self, loss):
        """{param: fp32 gradient} of ``loss`` (params the graph does not
        read, such as fix_gamma's gamma, get zeros, as ``jax.grad``
        gives)."""
        names = [n for _, ns in self._groups for n in ns]
        grads = torch.autograd.grad(loss, [self._leaves[n] for n in names],
                                    allow_unused=True,
                                    materialize_grads=True)
        return dict(zip(names, grads))

    def _update(self, grad, aux_up):
        """The SGD update of the fp32 masters at the device lr scalar
        times each group's lr_mult, and the aux fold, in place."""
        with torch.no_grad():
            for (lr_mult, wd), ns in self._groups:
                lr = self._lr if lr_mult == 1.0 else self._lr * lr_mult
                self._fopt.update_([self._p[n] for n in ns],
                                   [grad[n].float() for n in ns],
                                   [self._state[n] for n in ns], lr, wd)
            for n, v in aux_up.items():
                self._aux[n].copy_(v)

    def apply(self, grad, aux_up, lr=None):
        """The optimizer update of the fp32 masters and the aux fold
        (``lr``, when given, is written into the lr scalar first)."""
        if lr is not None:
            self.set_lr(lr)
        self._update(grad, aux_up)
        self.num_update += 1

    def gradients(self, feed):
        """One step's forward and backward without the update: ``(loss,
        {param: fp32 gradient}, aux_updates, outputs)``."""
        loss, outs, aux_up = self.forward_loss(feed)
        return (loss.detach(), self.backward(loss), aux_up,
                [o.detach() for o in outs])

    def _body(self, vals):
        """Forward, backward, update and aux fold on device inputs
        ``vals``: the program a capture records. ``(loss, outputs)``."""
        loss, outs, aux_up = self._forward_loss(vals)
        grads = self.backward(loss)
        self._update(grads, aux_up)
        return loss.detach(), [o.detach() for o in outs]

    def step_eager(self, feed, lr=None):
        """One step without a graph: every kernel launched from Python.
        Returns the graph's outputs; the loss stays on the device in
        ``last_loss``."""
        if not self.started:
            raise MXNetError("FusedSymbolStep used before start()")
        if lr is not None:
            self.set_lr(lr)
        loss, outs = self._body(self._on_device(self._inputs(feed)))
        self.num_update += 1
        self.last_loss = loss
        return outs

    def step(self, feed, lr=None):
        """One training step on ``feed`` ({input name: tensor or array});
        ``lr``, when given, is written into the lr scalar first (the
        caller applies the schedule). On a CUDA device the captured
        program of the feed's signature (see the module docstring); on
        the CPU ``step_eager``. Returns the graph's outputs (copies); the
        loss stays on the device in ``last_loss``."""
        if not self.started:
            raise MXNetError("FusedSymbolStep used before start()")
        vals = self._inputs(feed)
        sig = compile_mod.arg_signature(list(vals.values()))
        prog = self._programs.get(sig)
        if prog is None:
            key = self._program_key(sig)
            compile_mod.note_entry_point(key.name, key, sig)
            prog = self._programs[sig] = compile_mod.CapturedProgram(key)
            if self.captured:
                return self._warm_step(vals, lr)
        if not self.captured:
            return self.step_eager(vals, lr)
        if lr is not None:
            self.set_lr(lr)
        if not prog.captured:
            self._capture(prog, vals)
        self._load_inputs(prog, vals)
        prog.replay()
        self.num_update += 1
        loss, outs = prog.outputs
        self.last_loss = loss.clone()
        return [o.clone() for o in outs]

    def _warm_step(self, vals, lr):
        """The first step at a signature: eager, on a side stream."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            outs = self.step_eager(vals, lr)
        main.wait_stream(side)
        for t in [self.last_loss] + outs:
            t.record_stream(main)
        return outs

    def _capture(self, prog, vals):
        """Static input buffers for ``vals``'s signature, then the step
        captured over them (nothing runs; the replay computes it)."""
        prog.static = {n: torch.empty(v.shape, dtype=v.dtype,
                                      device=self.device)
                       for n, v in vals.items()}
        try:
            prog.capture(lambda: self._body(prog.static))
        except Exception as e:
            raise MXNetError(f"capturing the fused step "
                             f"{prog.key.name} as a CUDA graph failed: "
                             f"{e}") from e

    def _load_inputs(self, prog, vals):
        """Copy the feed into the program's static inputs (stream order:
        before the replay)."""
        for n, v in vals.items():
            prog.static[n].copy_(v, non_blocking=True)

    def _program_key(self, sig):
        """The step program's key at one feed signature (the JAX
        package's materials, ``mxnet_tpu/module/fused.py``
        ``_program_key``, less the mesh, guard, metric and sparse ones
        this port lacks)."""
        from ..symbol import passes as _passes
        if self._symbol_sha is None:
            self._symbol_sha = compile_mod.symbol_digest(self.symbol)
        fusion_report = _passes.legacy_fusion_entry(self.pass_report)
        fusion = {"flag": str(config.get("MXTPU_PALLAS_FUSION")),
                  "sites": len(fusion_report["sites"])
                  if fusion_report else 0}
        extra = {"compute_dtype": str(self.compute_dtype).replace(
                     "torch.", ""),
                 "trainable": sorted((n, bool(v))
                                     for n, v in self.trainable.items())}
        return compile_mod.program_key(
            "fused_step", f"fused_step:{self.symbol.name}",
            symbol_sha=self._symbol_sha, input_sigs=sig,
            optimizer=self.optimizer, fusion=fusion,
            passes=_passes.pipeline_key_material(self.pass_report),
            extra=extra, device=self.device)
