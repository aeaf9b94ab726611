"""The training step of a Gluon ``HybridBlock`` on one device
(counterpart of ``mxnet_tpu/parallel/step.py``).

``TrainStep(net, loss, optimizer, ...)(x, y)`` runs a whole step: the
block's staged forward (``HybridBlock.staged_forward``) in training
mode, the loss, the backward, the update of every trainable parameter
by a rule of ``functional_opt`` at ``lr * lr_mult`` and ``wd *
wd_mult``, and the fold of the BatchNorm running-statistics writes into
their parameters. The master weights and optimizer state are fp32
tensors of the step's own (``sync_params`` copies them back into the
net); with ``compute_dtype`` every float32 parameter and input is cast
to it for the forward, and the gradients come back in fp32 through the
cast. The update count ``t`` is a 0-dim int32 device tensor that the
step reads as ``t + 1`` and advances; the lr is a 0-dim fp32 device
scalar written only when ``lr`` or ``lr_schedule(num_update)`` changes
it, so a schedule never needs a new capture. The first call
materialises deferred parameters with one eager forward on ``x[:1]``
(the JAX package's :271-290). ``preprocess`` runs on the input inside
the step; ``remat`` (default ``MXNET_BACKWARD_DO_MIRROR``) recomputes
the forward in the backward through ``torch.utils.checkpoint``.

On a CUDA device the step is a captured program, as the JAX package's
is one jitted XLA computation: one CUDA graph per input signature, keyed
by ``compile.program_key("train_step", ...)`` and noted by the retrace
guard. The first step at a signature runs eagerly on a side stream (it
warms Triton and cuBLAS), the second copies the inputs into static
buffers, captures the step and replays it, later ones copy and replay.
The step's random ops (Dropout) draw from the step's own CUDA generator,
registered with each graph (each replay draws anew). A capture that
fails raises; there is no fallback. ``step_eager`` runs the same body
without a graph; the CPU always does.

Not ported: ``mesh``, ``param_spec_fn`` and ``partition_rules`` (data
and tensor parallelism, ROADMAP.md A10) raise; ``remat`` with a net
that draws random numbers raises (a recomputed forward would draw new
masks).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import compile as compile_mod
from .. import config
from .. import random as _random
from ..base import MXNetError, torch_dtype
from ..ndarray.ndarray import NDArray
from . import functional_opt

__all__ = ["TrainStep", "softmax_ce_loss", "l2_loss"]


def softmax_ce_loss(logits, labels):
    """Mean softmax cross entropy with integer labels, in fp32 (the JAX
    package's ``softmax_ce_loss``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, labels.to(torch.int64).reshape(-1, 1))
    return -picked.mean()


def l2_loss(pred, target):
    return 0.5 * torch.mean(torch.square(pred - target.reshape(pred.shape)))


_LOSSES = {"softmax_ce": softmax_ce_loss, "l2": l2_loss}


def _tensor(v):
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))


class TrainStep:
    """One training step of a HybridBlock (see the module docstring).

    Usage::

        step = TrainStep(net, loss="softmax_ce", optimizer="sgd",
                         optimizer_params={"momentum": 0.9}, lr=0.1,
                         compute_dtype="bfloat16")
        loss = step(x, y)          # NDArray in, a 0-dim NDArray out
    """

    # a DataPipeline's stager thread may pin and copy while a step is
    # captured (module/fused.py)
    capture_error_mode = "thread_local"

    def __init__(self, net, loss="softmax_ce", optimizer="sgd",
                 optimizer_params=None, mesh=None, data_axis="data",
                 compute_dtype=None, lr=0.01,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 param_spec_fn=None, partition_rules=None, preprocess=None,
                 remat=None):
        if mesh is not None or param_spec_fn is not None \
                or partition_rules is not None:
            raise NotImplementedError(
                "TrainStep: mesh, param_spec_fn and partition_rules (data "
                "and tensor parallelism) are not ported (ROADMAP.md A10)")
        self.net = net
        self.preprocess = preprocess
        self.loss_fn = _LOSSES[loss] if isinstance(loss, str) else loss
        params = dict(optimizer_params or {})
        self.lr = params.pop("learning_rate", lr)
        self.lr_schedule = lr_schedule
        self.wd = params.pop("wd", 0.0)
        self.optimizer = optimizer
        self._opt_params = params
        self._fopt = functional_opt.create(optimizer, **params)
        self.compute_dtype = torch_dtype(compute_dtype)
        if remat is None:
            remat = config.get("MXNET_BACKWARD_DO_MIRROR")
        self.remat = bool(remat)
        self._num_update = 0
        self.param_list = None
        self._p = None
        self._programs = {}      # input signature -> CapturedProgram
        self._warm = set()       # signatures that ran their warm step
        self.last_loss = None

    # -- state ----------------------------------------------------------------
    def _materialize(self, x):
        """One eager training forward on ``x[:1]`` when a parameter's
        init is deferred."""
        params = self.net._get_param_list()
        if all(p._data is not None for p in params):
            return
        from .. import autograd
        dev = next((p._data._data.device for p in params
                    if p._data is not None), None)
        if dev is None:
            dev = next(p._deferred_init[1][0].device for p in params
                       if p._deferred_init)
        x1 = x[:1].to(dev)
        if self.preprocess is not None:
            x1 = self.preprocess(x1)
        with autograd.train_mode():
            self.net.forward(NDArray(x1))

    def _init_state(self):
        self.param_list = self.net._get_param_list()
        self._staged = self.net.staged_forward(training=True)
        self._trainable = [p.grad_req != "null" for p in self.param_list]
        self._p = [p.data()._data.detach().clone() for p in self.param_list]
        self.device = self._p[0].device
        self._index = {id(p): i for i, p in enumerate(self.param_list)}
        self._s = [self._fopt.init(v) if tr else ()
                   for v, tr in zip(self._p, self._trainable)]
        groups = {}
        for i, p in enumerate(self.param_list):
            if self._trainable[i]:
                key = (float(getattr(p, "lr_mult", 1.0)),
                       float(self.wd) * float(getattr(p, "wd_mult", 1.0)))
                groups.setdefault(key, []).append(i)
        self._groups = sorted(groups.items())
        self._t = torch.zeros((), dtype=torch.int32, device=self.device)
        self._lr_host = None
        self._lr_t = torch.zeros((), dtype=torch.float32, device=self.device)
        self.captured = self.device.type == "cuda"
        self._gen = None
        if self.device.type == "cuda":
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=_random.generator("cpu")))
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(seed)

    def set_lr(self, lr):
        """Write ``lr`` into the device scalar the step reads (a launch,
        no sync) when it changed."""
        if lr != self._lr_host:
            self._lr_t.fill_(float(lr))
            self._lr_host = lr

    def snapshot(self):
        """Copies of the masters, the optimizer state and ``t``."""
        return ([p.clone() for p in self._p],
                [tuple(x.clone() for x in s) for s in self._s],
                self._t.clone(), self._num_update)

    def restore(self, snap):
        """Copy a ``snapshot`` back in place (a captured graph holds the
        storage of the masters, state and ``t``)."""
        ps, ss, t, n = snap
        with torch.no_grad():
            for dst, src in zip(self._p, ps):
                dst.copy_(src)
            for dst, src in zip(self._s, ss):
                for a, b in zip(dst, src):
                    a.copy_(b)
            self._t.copy_(t)
        self._num_update = n

    # -- the step -------------------------------------------------------------
    def _cast(self, v):
        cdt = self.compute_dtype
        return v.to(cdt) if cdt is not None and v.dtype == torch.float32 \
            else v

    def _forward(self, pv, x):
        """The staged forward: ``(outputs, [(Parameter, write)])``, under
        ``torch.utils.checkpoint`` with remat."""
        if not self.remat:
            return self._staged(pv, (x,), self._gen)
        meta = {}

        def run(*flat):
            outs, writes = self._staged(list(flat[:-1]), (flat[-1],),
                                        self._gen)
            meta["n"], meta["params"] = len(outs), [p for p, _ in writes]
            return tuple(outs) + tuple(w for _, w in writes)

        from torch.utils.checkpoint import checkpoint
        res = checkpoint(run, *pv, x, use_reentrant=False,
                         preserve_rng_state=False)
        n = meta["n"]
        return res[:n], list(zip(meta["params"], res[n:]))

    def _body(self, x, y):
        """Forward, loss, backward, update and BatchNorm fold on device
        inputs: the program a capture records. Returns the loss."""
        if self.preprocess is not None:
            x = self.preprocess(x)
        # fresh leaves aliasing the masters each step: autograd ties a
        # leaf's gradient accumulator to the stream it was made on
        leaves = [p.detach().requires_grad_(tr)
                  for p, tr in zip(self._p, self._trainable)]
        with torch.enable_grad():
            outs, writes = self._forward([self._cast(v) for v in leaves],
                                         self._cast(x))
            loss = self.loss_fn(outs[0], y)
        idx = [i for _, ns in self._groups for i in ns]
        grads = dict(zip(idx, torch.autograd.grad(
            loss, [leaves[i] for i in idx], allow_unused=True,
            materialize_grads=True)))
        with torch.no_grad():
            t1 = self._t + 1
            for (lr_mult, wd), ns in self._groups:
                lr = self._lr_t if lr_mult == 1.0 else self._lr_t * lr_mult
                self._fopt.update_([self._p[i] for i in ns],
                                   [grads[i] for i in ns],
                                   [self._s[i] for i in ns], lr, wd, t=t1,
                                   key=self._gen, donate_grads=True)
            for p, v in writes:
                i = self._index.get(id(p))
                if i is not None:
                    self._p[i].copy_(v.detach())
            self._t.copy_(t1)
        return loss.detach()

    def _inputs(self, x, y):
        xa, ya = _tensor(x), _tensor(y)
        if self._p is None:
            self._materialize(xa)
            self._init_state()
        lr = self.lr if self.lr_schedule is None \
            else self.lr_schedule(self._num_update)
        self.set_lr(lr)
        return (xa.to(self.device, non_blocking=True),
                ya.to(self.device, non_blocking=True))

    def step_eager(self, x, y):
        """One step without a graph (every kernel launched from Python);
        the same arithmetic as a replay."""
        xa, ya = self._inputs(x, y)
        self._check_remat_draws(self._body, xa, ya)
        return self._finish(self.last_loss)

    def _check_remat_draws(self, fn, xa, ya):
        gen = self._gen or _random.generator(self.device)
        before = gen.get_state() if self.remat else None
        self.last_loss = fn(xa, ya)
        if before is not None and not torch.equal(before, gen.get_state()):
            raise MXNetError("TrainStep: remat with a net that draws random "
                             "numbers (Dropout) is not ported: the "
                             "recomputed forward would draw new masks")

    def _finish(self, loss):
        self._num_update += 1
        return NDArray(loss)

    def __call__(self, x, y):
        """One training step; returns the loss (a 0-dim NDArray on the
        device)."""
        xa, ya = self._inputs(x, y)
        if not self.captured:
            self._check_remat_draws(self._body, xa, ya)
            return self._finish(self.last_loss)
        sig = compile_mod.arg_signature([xa, ya])
        prog = self._programs.get(sig)
        if prog is None:
            key = self._program_key(sig)
            compile_mod.note_entry_point(key.name, key, sig)
            prog = self._programs[sig] = compile_mod.CapturedProgram(key)
        if sig not in self._warm:
            self._warm.add(sig)
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._check_remat_draws(self._body, xa, ya)
            main.wait_stream(side)
            self.last_loss.record_stream(main)
            return self._finish(self.last_loss)
        if not prog.captured:
            prog.static = (torch.empty_like(xa), torch.empty_like(ya))
            try:
                prog.capture(lambda: self._body(*prog.static),
                             capture_error_mode=self.capture_error_mode,
                             generators=(self._gen,))
            except Exception as e:
                raise MXNetError(f"capturing the train step {prog.key.name} "
                                 f"as a CUDA graph failed: {e}") from e
        prog.static[0].copy_(xa, non_blocking=True)
        prog.static[1].copy_(ya, non_blocking=True)
        prog.replay()
        self.last_loss = prog.outputs.clone()
        return self._finish(self.last_loss)

    def _program_key(self, sig):
        extra = {"compute_dtype": str(self.compute_dtype),
                 "remat": self.remat,
                 "trainable": [(p.name, bool(t)) for p, t in
                               zip(self.param_list, self._trainable)],
                 "groups": [k for k, _ in self._groups],
                 "preprocess": getattr(self.preprocess, "__name__",
                                       repr(self.preprocess)),
                 "loss": getattr(self.loss_fn, "__name__",
                                 repr(self.loss_fn))}
        return compile_mod.program_key(
            "train_step", f"train_step:{self.net.name}",
            symbol_sha=None, input_sigs=sig,
            optimizer=dict(self._opt_params, type=self.optimizer),
            extra=extra, device=self.device)

    def sync_params(self):
        """Copy the step's masters into the net's Parameters."""
        if self._p is None:
            return
        with torch.no_grad():
            for p, v in zip(self.param_list, self._p):
                p._check_and_get()._data.copy_(v)

    @property
    def num_update(self):
        return self._num_update
