"""The fused training step of the symbolic Module (counterpart of
``mxnet_tpu/module/fused.py``), on one device.

``FusedSymbolStep.step`` runs a whole batch: the forward of the
rewritten graph in the compute dtype, the implicit-loss backward
(autograd), the optimizer update of the fp32 master weights and the
BatchNorm running-statistics fold. The rewrite passes run once, in
``train`` mode, at ``start``; on a CUDA device a pass that fails raises
(pass manager), so the step never trains on library ops in place of the
kernels.

Dtype flow (the JAX package's): fp32 master params, optimizer state
and aux; with a ``compute_dtype`` every fp32 param, aux and input is
cast to it for the step, the gradients come back in fp32 (through the
cast), and the fold ``m*old + (1-m)*batch_stat`` is taken in the
compute dtype and stored in fp32.

Not ported (ROADMAP queue A): the device mesh and data-parallel batch
sharding, the ZeRO-1 sharded update, partition rules, row-sparse
embedding routing, in-step metric counters, the compiled-program cache,
the non-finite step guard (``MXTPU_FT_GUARD``) and small-parameter
packing; each step is one eager autograd pass over the graph.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, torch_dtype
from ..executor import build_graph_fns
from ..parallel import functional_opt

__all__ = ["FusedSymbolStep"]


class FusedSymbolStep:
    """Forward + backward + update + aux fold of a bound Symbol.

    Owns the fp32 master parameters, the optimizer state and the aux
    states on ``device`` between steps; ``params()`` hands them out."""

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
        self.device = torch.device(device) if device is not None else None
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
        self._groups = None
        self.last_loss = None
        self.num_update = 0

    @property
    def started(self):
        return self._p is not None

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
        # params sharing (lr_mult, wd) update together: one foreach
        # launch per operation per group
        groups = {}
        for n in self.param_names:
            if self.trainable[n]:
                groups.setdefault((self._lr_mults[n], self._wd_eff[n]),
                                  []).append(n)
        self._groups = sorted(groups.items())

    def load_params(self, arg_dict, aux_dict):
        """Replace the master params and aux (optimizer state is kept)."""
        self._p = {}
        for n in self.param_names:
            p = arg_dict[n].detach().to(self.device, torch.float32,
                                        copy=True)
            self._p[n] = p.requires_grad_(self.trainable[n])
        self._aux = {n: aux_dict[n].detach().to(self.device, torch.float32,
                                                copy=True)
                     for n in self.aux_names}

    def params(self):
        """(arg_params, aux_params): the fp32 masters and aux, detached."""
        return ({n: p.detach() for n, p in self._p.items()},
                dict(self._aux))

    def _cast(self, v):
        cdt = self.compute_dtype
        return v.to(cdt) if cdt is not None and v.dtype == torch.float32 \
            else v

    def _feed(self, feed):
        vals = {}
        for n in self.input_names:
            if n not in feed:
                raise MXNetError(f"fused step missing input '{n}'")
            v = feed[n]
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(v)
            vals[n] = self._cast(v.to(self.device, non_blocking=True))
        return vals

    def _values(self, feed):
        feed_vals = self._feed(feed)
        arg_vals = [self._cast(self._p[n]) if n in self._p
                    else feed_vals[n] for n in self._run_arg_names]
        aux_vals = [self._cast(self._aux[n]) for n in self._run_aux_names]
        return arg_vals, aux_vals

    def forward(self, feed, training=False):
        """The graph's outputs on the current params, without a gradient
        or an update (training: batch statistics, no aux fold)."""
        with torch.no_grad():
            arg_vals, aux_vals = self._values(feed)
            outs, _ = self._fwd(arg_vals, aux_vals, training)
        return list(outs)

    def forward_loss(self, feed):
        """The training forward on ``feed``, recorded for the backward:
        ``(loss, outputs, aux_updates)``."""
        if not self.started:
            raise MXNetError("FusedSymbolStep used before start()")
        with torch.enable_grad():
            arg_vals, aux_vals = self._values(feed)
            loss, (outs, aux_up) = self._fwd_loss(arg_vals, aux_vals)
        return loss, outs, aux_up

    def backward(self, loss):
        """{param: fp32 gradient} of ``loss`` (params the graph does not
        read, such as fix_gamma's gamma, get zeros, as ``jax.grad``
        gives)."""
        names = [n for _, ns in self._groups for n in ns]
        grads = torch.autograd.grad(loss, [self._p[n] for n in names],
                                    allow_unused=True,
                                    materialize_grads=True)
        return dict(zip(names, grads))

    def apply(self, grad, aux_up, lr):
        """The optimizer update of the fp32 masters and the aux fold."""
        with torch.no_grad():
            for (lr_mult, wd), ns in self._groups:
                self._fopt.update_([self._p[n] for n in ns],
                                   [grad[n].float() for n in ns],
                                   [self._state[n] for n in ns],
                                   lr * lr_mult, wd)
            for n, v in aux_up.items():
                self._aux[n].copy_(v)
        self.num_update += 1

    def gradients(self, feed):
        """One step's forward and backward without the update: ``(loss,
        {param: fp32 gradient}, aux_updates, outputs)``."""
        loss, outs, aux_up = self.forward_loss(feed)
        return (loss.detach(), self.backward(loss), aux_up,
                [o.detach() for o in outs])

    def step(self, feed, lr):
        """One training step on ``feed`` ({input name: tensor or array})
        at base learning rate ``lr`` (schedule applied by the caller).
        Returns the graph's outputs; the loss stays on the device in
        ``last_loss``."""
        loss, grad, aux_up, outs = self.gradients(feed)
        self.apply(grad, aux_up, lr)
        self.last_loss = loss
        return outs
