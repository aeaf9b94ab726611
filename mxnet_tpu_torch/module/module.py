"""Module: symbolic training on one device (counterpart of
``mxnet_tpu/module/module.py``; reference: python/mxnet/module/module.py
— bind :363, init_optimizer :472, forward/backward/update :570-651).

In the steady state (``init_optimizer`` with a local or no kvstore and
``grad_req='write'``) forward, backward and update collapse into one
``FusedSymbolStep`` per batch (module/fused.py): a training ``forward``
stashes the batch, ``backward`` does nothing, and ``update`` runs the
forward, the implicit-loss backward, the optimizer update and the
BatchNorm aux fold. That is the only training path of the port:
``fused=False`` (the eager per-parameter Updater loop), multiple
contexts (the device mesh), distributed kvstores, ``group2ctxs`` and
explicit ``out_grads`` are not ported and raise.

Device: ``context`` is a ``torch.device``, a device string or a list of
one. Without one the Module runs on ``cuda:0`` and raises when CUDA is
absent — unlike MXNet, whose default context is the CPU; pass
``context=mxnet_tpu_torch.cpu()`` to train on the CPU.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import optimizer as opt
from ..base import MXNetError
from ..context import as_device
from ..io import DataDesc
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


def _norm_shapes(shapes):
    """[(name, shape)] / [DataDesc] -> [(name, tuple)]."""
    out = []
    for s in shapes or []:
        if isinstance(s, DataDesc):
            out.append((s.name, tuple(s.shape)))
        else:
            out.append((s[0], tuple(s[1])))
    return out


def _as_tensor(name, v):
    if isinstance(v, torch.Tensor):
        return v.detach()
    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    a = np.asarray(v)
    if a.dtype.kind not in "fiu":
        raise MXNetError(f"parameter '{name}' is not numeric ({a.dtype})")
    return torch.tensor(a)


class Module(BaseModule):
    """A bound symbol trained with a fused step.

    Parameters
    ----------
    symbol : Symbol
    data_names, label_names : sequences of input names
    context : torch.device, str or a list of one; default ``cuda:0``
    fixed_param_names : params that are not updated
    fused : None or True (the fused step); False raises
    compute_dtype : e.g. "bfloat16": fp32 master weights, the step in bf16
    """

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, fused=None,
                 compute_dtype=None):
        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise NotImplementedError(
                    f"Module got {len(context)} contexts; the device mesh "
                    "(data parallelism over several cards) is not ported")
            context = context[0]
        self._device = as_device(context)
        if fused is False:
            raise NotImplementedError(
                "Module(fused=False): the eager per-parameter update path "
                "is not ported; the fused step is the training path")
        if group2ctxs or state_names or \
                (work_load_list is not None and len(set(work_load_list)) > 1):
            raise NotImplementedError(
                "group2ctxs, state_names and uneven work_load_list are not "
                "ported")
        self._compute_dtype = compute_dtype
        self._symbol = symbol
        self._data_names = list(data_names) if data_names is not None \
            else []
        self._label_names = list(label_names) if label_names is not None \
            else []
        self._fixed_param_names = list(fixed_param_names or [])
        _check_input_names(symbol, self._data_names, "data", True)
        _check_input_names(symbol, self._label_names, "label", False)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)
        input_names = self._data_names + self._label_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._optimizer = None
        self._fused = None
        self._feed = None
        self._outputs = []
        self._shapes = None
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = None

    # -- properties -----------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        shapes = dict(self._data_shapes + (self._label_shapes or []))
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, map(tuple, out_shapes)))

    @property
    def pass_report(self):
        """The train-mode rewrite pipeline's report (after
        ``init_optimizer``)."""
        return self._fused.pass_report if self._fused is not None else None

    # -- bind -----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Fix the input shapes and infer every param and aux shape."""
        if force_rebind:
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad or shared_module is not None:
            raise NotImplementedError(
                "inputs_need_grad and shared_module are not ported")
        self.for_training = for_training
        self._data_shapes = _norm_shapes(data_shapes)
        self._label_shapes = _norm_shapes(label_shapes)
        self._grad_req = grad_req if for_training else "null"
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(
            **dict(self._data_shapes + self._label_shapes))
        self._shapes = dict(zip(self._symbol.list_arguments(),
                                map(tuple, arg_shapes)))
        self._shapes.update(zip(self._aux_names, map(tuple, aux_shapes)))
        self.binded = True

    # -- params ---------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False,
                    generator=None):
        """Fill every param and aux: from ``arg_params``/``aux_params``
        where given, else from ``initializer`` (random draws from
        ``generator``, a ``torch.Generator``; the global one when None).
        Params live in fp32 on the Module's device."""
        from .. import initializer as init_mod
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None and (arg_params is None or not force_init):
            initializer = init_mod.Uniform(0.01)
        if self._arg_params is None:
            self._arg_params = {
                n: torch.zeros(self._shapes[n], device=self._device)
                for n in self._param_names}
            self._aux_params = {
                n: torch.zeros(self._shapes[n], device=self._device)
                for n in self._aux_names}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                v = _as_tensor(name, cache[name])
                if tuple(v.shape) != tuple(arr.shape):
                    raise RuntimeError(
                        f"Fail to load parameter {name} because of shape "
                        f"mismatch: {tuple(v.shape)} vs {tuple(arr.shape)}")
                arr.copy_(v)
            elif not allow_missing or initializer is not None:
                if initializer is not None:
                    desc = init_mod.InitDesc(name, attrs.get(name, None))
                    initializer(desc, arr, generator)
            if cache is not None and name not in cache and not allow_missing:
                raise RuntimeError(f"{name} is not presented")

        with torch.no_grad():
            for name, arr in sorted(self._arg_params.items()):
                _impl(name, arr, arg_params)
            for name, arr in sorted(self._aux_params.items()):
                _impl(name, arr, aux_params)
        self.params_initialized = True
        if self._fused is not None and self._fused.started:
            self._fused.load_params(self._arg_params, self._aux_params)

    def get_params(self):
        """(arg_params, aux_params): {name: fp32 tensor on the device}."""
        assert self.binded and self.params_initialized
        if self._fused is not None and self._fused.started:
            args, aux = self._fused.params()
            with torch.no_grad():
                for n, v in args.items():
                    self._arg_params[n].copy_(v)
                for n, v in aux.items():
                    self._aux_params[n].copy_(v)
        return self._arg_params, self._aux_params

    # -- optimizer ------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer (``rescale_grad`` = 1/batch unless given)
        and start the fused step: the train-mode rewrite passes run on
        the bound shapes here."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if kvstore not in (None, "local", "device"):
            raise NotImplementedError(
                f"kvstore={kvstore!r} is not ported (one device: None, "
                "'local' or 'device')")
        batch_size = self._data_shapes[0][1][0] if self._data_shapes else 1
        rescale_grad = 1.0 / max(batch_size, 1)
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, param_idx2name=idx2name,
                                   **optimizer_params)
        elif optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but "
                "rescale_grad is not normalized to 1.0/batch_size "
                "(%s vs. %s). Is this intended?", optimizer.rescale_grad,
                rescale_grad)
        self._optimizer = optimizer
        self._maybe_init_fused()
        self.optimizer_initialized = True

    def _maybe_init_fused(self):
        """Start the fused step (module/fused.py); the configurations it
        cannot run raise, as ``Module(fused=True)`` does in the JAX
        package."""
        if self._grad_req != "write":
            raise NotImplementedError(
                f"grad_req={self._grad_req!r}: the fused step writes "
                "gradients ('write') only")
        from .fused import FusedSymbolStep
        trainable = {n: n not in self._fixed_param_names
                     for n in self._param_names}
        self._fused = FusedSymbolStep(
            self._symbol, self._data_names, self._label_names,
            self._param_names, self._aux_names, trainable, self._optimizer,
            compute_dtype=self._compute_dtype, device=self._device)
        self._fused.start(self._arg_params, self._aux_params,
                          dict(self._data_shapes + self._label_shapes))

    # -- compute --------------------------------------------------------------
    def _batch_feed(self, data_batch):
        feed = {}
        for (name, _), arr in zip(self._data_shapes, data_batch.data):
            feed[name] = arr
        if self._label_shapes and data_batch.label:
            for (name, _), arr in zip(self._label_shapes, data_batch.label):
                feed[name] = arr
        for name, v in feed.items():
            if tuple(v.shape) != self._shapes[name]:
                raise MXNetError(
                    f"input '{name}' has shape {tuple(v.shape)}, bound "
                    f"{self._shapes[name]} (reshape is not ported)")
        return feed

    def forward(self, data_batch, is_train=None):
        """A training forward stashes the batch for ``update``; an eval
        forward runs the rewritten graph with the moving statistics.
        Both need the fused step, so come after ``init_optimizer``."""
        assert self.binded and self.params_initialized
        if self._fused is None:
            raise MXNetError("forward before init_optimizer: the port runs "
                             "the graph through the fused step, which "
                             "init_optimizer starts")
        if is_train is None:
            is_train = self.for_training
        feed = self._batch_feed(data_batch)
        self._outputs = []
        if is_train:
            self._feed = feed
            return
        self._feed = None
        for n in self._label_names:
            feed.setdefault(n, torch.zeros(self._shapes[n]))
        self._outputs = self._fused.forward(feed, training=False)

    def backward(self, out_grads=None):
        """The implicit-loss backward runs inside ``update``'s fused
        step; explicit ``out_grads`` are not ported."""
        assert self.binded and self.params_initialized
        if out_grads is not None:
            raise NotImplementedError(
                "backward(out_grads=...) is not ported; the fused step "
                "differentiates the graph's implicit losses")

    def update(self):
        """Run the fused step on the stashed training batch."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        if self._feed is None:
            raise MXNetError(
                "update() without a pending training forward; call "
                "forward(batch, is_train=True) first")
        o = self._optimizer
        nu = self._fused.num_update + 1
        lr = o.lr_scheduler(nu) if o.lr_scheduler is not None else o.lr
        self._outputs = self._fused.step(self._feed, lr)
        self._feed = None
        o.num_update = self._fused.num_update

    def get_outputs(self, merge_multi_context=True):
        """The last step's (or eval forward's) outputs; between a
        training forward and ``update``, a forward with batch statistics
        on the current params."""
        assert self.binded and self.params_initialized
        if not self._outputs and self._feed is not None:
            self._outputs = self._fused.forward(self._feed, training=True)
        return self._outputs

    def update_metric(self, eval_metric, labels):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels or [])),
            dict(zip(self._output_names, self.get_outputs())))
