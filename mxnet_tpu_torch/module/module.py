"""Module: symbolic training on one device (counterpart of
``mxnet_tpu/module/module.py``; reference: python/mxnet/module/module.py
— bind :363, init_optimizer :472, forward/backward/update :570-651).

``bind`` binds an ``executor.Executor`` (``Symbol.simple_bind``): the
params, their gradients and the aux states are its arrays, and
``get_params`` hands out their tensors. Two training regimes, as in the
JAX package:

- the fused step (``fused=None`` or ``True`` with grad_req ``'write'``
  and no ``inputs_need_grad``): forward, backward and update collapse
  into one ``FusedSymbolStep`` per batch (module/fused.py). A training
  ``forward`` stashes the batch, ``backward`` does nothing, and
  ``update`` runs the forward, the implicit-loss backward, the
  optimizer update (any rule of ``parallel/functional_opt.py``) and the
  BatchNorm aux fold, on the card as a captured CUDA graph. The step
  owns fp32 masters; the executor's arrays are synced from them when
  they are read (``get_params``, an eval forward). ``backward(out_grads=
  ...)`` leaves the fused regime before the first update (a warning)
  and raises after it. ``update_metric`` after a fused step counts the
  supported metrics inside the step (``metric_device.py``);
- the eager loop (``fused=False``, grad_req ``'add'`` / ``'null'``,
  ``inputs_need_grad``): ``forward`` / ``backward`` run the executor's
  programs (captured CUDA graphs on the card), and ``update`` calls the
  ``optimizer.Updater`` on each parameter, which writes the new weight
  into the executor's array in place.

An eval ``forward`` runs the executor's captured eval program in both
regimes. A batch of another shape reshapes the executor. ``Monitor``
(``install_monitor``) taps the executor; in the fused regime a monitored
batch also runs the executor's forward and backward at the pre-update
params, and the params are synced after the step. ``save_checkpoint`` /
``Module.load`` and ``save_optimizer_states`` / ``load_optimizer_states``
write and read the JAX package's files (the fused step's pickle, or the
Updater's). ``init_optimizer`` takes a kvstore name or a ``KVStore``
(``kvstore.py``): each parameter is ``init``-ed into the store, and on
one device the optimizer runs in the module (``update_on_kvstore`` is
the store's ``is_distributed``, always False here), so the fused step
stays engaged. Multiple contexts (the device mesh), the ``dist*``
kvstores, ``group2ctxs`` and ``state_names`` are not ported and raise.

The batches' arrays, ``get_outputs`` and ``get_input_grads`` are
NDArrays, as in the reference: each wraps the tensor without a copy,
and the internal paths (the fused step's feed, the metrics) read the
tensors.

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
from ..base import MXNetError, atomic_write
from ..context import as_device
from ..io import DataDesc
from ..model import load_checkpoint
from ..ndarray.ndarray import NDArray
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


def _tensor_of(v):
    """A batch array's tensor (an NDArray is unwrapped, never copied)."""
    return v._data if isinstance(v, NDArray) else v


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
    """A symbol bound to an Executor, trained by the fused step or the
    eager Updater loop.

    Parameters
    ----------
    symbol : Symbol
    data_names, label_names : sequences of input names
    context : torch.device, str or a list of one; default ``cuda:0``
    fixed_param_names : params that are not updated
    fused : None (the fused step when the configuration allows it), True
        (the fused step, or raise) or False (the eager Updater loop)
    compute_dtype : e.g. "bfloat16": the fused step's compute dtype (fp32
        master weights)
    """

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None,
                 fused=None, compute_dtype=None):
        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise NotImplementedError(
                    f"Module got {len(context)} contexts; the device mesh "
                    "(data parallelism over several cards) is not ported")
            context = context[0]
        self._device = as_device(context)
        if group2ctxs or state_names or \
                (work_load_list is not None and len(set(work_load_list)) > 1):
            raise NotImplementedError(
                "group2ctxs, state_names and uneven work_load_list are not "
                "ported")
        self._fused_requested = fused
        self._compute_dtype = compute_dtype
        self._compression_params = compression_params
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
        self._exec = None
        self._arg_params = None
        self._aux_params = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._fused = None
        self._feed = None
        self._host_feed = None
        self._outputs = []
        self._outputs_from_step = False
        self._params_dirty = False
        self._monitor = None
        self._loaded_params = None
        self._preload_opt_states = None
        self._shapes = None
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of ``prefix-symbol.json`` with the params of
        ``prefix-%04d.params`` (either package's files); they go onto the
        Module's device at ``bind``, and with
        ``load_optimizer_states`` ``prefix-%04d.states`` is loaded at
        ``init_optimizer``."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._loaded_params = (args, auxs)
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write ``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``."""
        self._symbol.save(f"{prefix}-symbol.json")
        param_name = f"{prefix}-{epoch:04d}.params"
        self.save_params(param_name)
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    def save_optimizer_states(self, fname):
        """The fused step's optimizer state (``get_states``' bytes), the
        store's when the optimizer runs in it, or the Updater's, through
        ``base.atomic_write``."""
        assert self.optimizer_initialized
        if self._fused is None and self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with atomic_write(fname) as fout:
            fout.write(self._fused.get_states() if self._fused is not None
                       else self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Load a ``save_optimizer_states`` file (either package's)."""
        assert self.optimizer_initialized
        if self._fused is None and self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._set_opt_states(f.read())

    def _opt_states_snapshot(self):
        """The optimizer state on the host, unpickled (a checkpoint
        pickles it with its other files)."""
        if self._fused is not None:
            return self._fused.states_snapshot()
        return opt.loads_states(self._updater.get_states())

    def _set_opt_states(self, states):
        """Load optimizer state (bytes or the unpickled object)."""
        if self._fused is not None:
            self._fused.set_states(states)
            self._optimizer.num_update = self._fused.num_update
        else:
            self._updater.set_states(states, device=self._device)

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
        """The train-mode rewrite pipeline's report: the fused step's
        (after ``init_optimizer``), else the executor's."""
        if self._fused is not None:
            return self._fused.pass_report
        return self._exec.pass_report if self._exec is not None else None

    # -- bind -----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind an Executor for the input shapes: every param, gradient
        and aux array allocated on the device (``shared_module``: its
        parameter arrays of equal shapes are shared)."""
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = _norm_shapes(data_shapes)
        self._label_shapes = _norm_shapes(label_shapes)
        self._grad_req = grad_req if for_training else "null"
        # only the parameters are shared: simple_bind adds the arrays it
        # allocates to the buffer, so the shared module's own arg_dict
        # must not be it (a bucket of other input shapes would replace
        # the shared module's data and label arrays)
        shared_buffer = {n: a for n, a in shared_module._exec.arg_dict.items()
                         if n in shared_module._param_names} \
            if shared_module is not None else None
        self._exec = self._symbol.simple_bind(
            ctx=self._device, grad_req=self._grad_req,
            shared_buffer=shared_buffer,
            **dict(self._data_shapes + self._label_shapes))
        self._bind_arrays()
        self.binded = True
        if self._loaded_params is not None:
            args, auxs = self._loaded_params
            self._loaded_params = None
            self.params_initialized = False
            self.init_params(initializer=None, arg_params=args,
                             aux_params=auxs)
        if shared_module is not None and shared_module.params_initialized:
            _, aux = shared_module.get_params()
            with torch.no_grad():
                for n, v in aux.items():
                    self._aux_params[n].copy_(v)
            self.params_initialized = True

    def _bind_arrays(self):
        """The params and aux are the executor's arrays' tensors."""
        ex = self._exec
        self._shapes = {n: tuple(a.shape) for n, a in
                        list(ex.arg_dict.items()) + list(ex.aux_dict.items())}
        self._arg_params = {n: ex.arg_dict[n]._data
                            for n in self._param_names}
        self._aux_params = {n: ex.aux_dict[n]._data for n in self._aux_names}

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind the executor to new input shapes, sharing the params
        (reference: module.py:448)."""
        assert self.binded
        self._data_shapes = _norm_shapes(data_shapes)
        self._label_shapes = _norm_shapes(label_shapes)
        self._exec = self._exec.reshape(
            **dict(self._data_shapes + self._label_shapes))
        self._bind_arrays()

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
        self._params_dirty = False
        if self._fused is not None and self._fused.started:
            self._fused.load_params(self._arg_params, self._aux_params)

    def _sync_params(self):
        """After fused steps: the masters and aux into the executor's
        arrays."""
        if self._params_dirty and self._fused is not None and \
                self._fused.started:
            args, aux = self._fused.params()
            with torch.no_grad():
                for n, v in args.items():
                    self._arg_params[n].copy_(v)
                for n, v in aux.items():
                    self._aux_params[n].copy_(v)
        self._params_dirty = False

    def get_params(self):
        """(arg_params, aux_params): {name: fp32 tensor on the device},
        the executor's arrays."""
        assert self.binded and self.params_initialized
        self._sync_params()
        return self._arg_params, self._aux_params

    # -- optimizer ------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer (``rescale_grad`` = 1/batch unless given)
        and its Updater, ``init`` every parameter into the kvstore (a
        name for ``kvstore.create`` or a ``KVStore``), and start the
        fused step when the configuration allows it: the train-mode
        rewrite passes run on the bound shapes there."""
        from .. import kvstore as kvs
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        batch_size = self._data_shapes[0][1][0] if self._data_shapes else 1
        kv = None
        if kvstore:
            kv = kvs.create(kvstore) if isinstance(kvstore, str) \
                else kvstore
            if "dist" in kv.type and "_sync" in kv.type:
                batch_size *= kv.num_workers
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
        self._updater = opt.get_updater(optimizer)
        self._kvstore = kv
        self._update_on_kvstore = kv is not None and kv.is_distributed
        if kv is not None:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
            for i, name in enumerate(self._param_names):
                kv.init(i, self._arg_params[name])
        self._maybe_init_fused()
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _grad_req_of(self, name):
        return self._exec.grad_req.get(name, "null")

    def _maybe_init_fused(self):
        """Start the fused step (module/fused.py) unless ``fused=False``
        or the configuration needs the eager loop; with ``fused=True``
        such a configuration raises, as in the JAX package."""
        if self._fused_requested is False:
            return
        blockers = []
        if self._grad_req != "write":
            blockers.append(f"grad_req={self._grad_req!r}")
        if self.inputs_need_grad:
            blockers.append("inputs_need_grad")
        if blockers:
            if self._fused_requested:
                raise MXNetError(
                    f"Module(fused=True) impossible with: {blockers}")
            return
        from .fused import FusedSymbolStep
        trainable = {n: self._grad_req_of(n) != "null"
                     and n not in self._fixed_param_names
                     for n in self._param_names}
        try:
            self._fused = FusedSymbolStep(
                self._symbol, self._data_names, self._label_names,
                self._param_names, self._aux_names, trainable,
                self._optimizer, compute_dtype=self._compute_dtype,
                device=self._device)
        except ValueError as e:
            # an optimizer class without a functional rule
            if self._fused_requested:
                raise
            self._fused = None
            self.logger.warning(
                "fused Module step unavailable (%s); training with the "
                "eager per-parameter update loop", e)
            return
        self._fused.start(self._arg_params, self._aux_params,
                          dict(self._data_shapes + self._label_shapes))

    def _degrade_fused(self, what):
        """Leave the fused regime for a call it cannot run: a warning
        before the first update, an error after it (the optimizer state
        cannot be handed to the Updater mid-run)."""
        if self._fused is None:
            return
        if self._fused.num_update > 0:
            raise MXNetError(
                f"{what} is incompatible with the fused update path once "
                "training has begun; construct Module(..., fused=False)")
        self.logger.warning(
            "%s disables the fused update path; using the eager loop", what)
        self._fused = None

    # -- compute --------------------------------------------------------------
    def _batch_feed(self, data_batch):
        """{input name: tensor} of a batch (NDArrays unwrapped)."""
        feed = {}
        for (name, _), arr in zip(self._data_shapes, data_batch.data):
            feed[name] = _tensor_of(arr)
        if self._label_shapes and data_batch.label:
            for (name, _), arr in zip(self._label_shapes, data_batch.label):
                feed[name] = _tensor_of(arr)
        return feed

    def _reshape_for(self, feed):
        """Reshape the executor when the batch's shapes differ from the
        bound ones."""
        if all(tuple(v.shape) == self._shapes[n] for n, v in feed.items()):
            return
        new = {n: tuple(v.shape) for n, v in feed.items()}
        self.reshape([(n, new.get(n, s)) for n, s in self._data_shapes],
                     [(n, new.get(n, s)) for n, s in self._label_shapes])

    def forward(self, data_batch, is_train=None):
        """A training forward in the fused regime stashes the batch for
        ``update``; otherwise the executor runs its forward (captured
        on the card), an eval forward with the moving statistics."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feed = self._batch_feed(data_batch)
        self._reshape_for(feed)
        self._outputs = []
        self._outputs_from_step = False
        self._feed = None
        if is_train and self._fused is not None:
            self._feed = feed
            # the host batch a DataPipeline staged from, for the sparse
            # id statistics (read no device tensor)
            host = getattr(data_batch, "host", None)
            self._host_feed = self._batch_feed(host) \
                if host is not None else None
            mon = self._monitor
            if mon is not None and mon.activated:
                # a monitored batch: the tapped forward and backward at
                # the pre-update params (observation only)
                self._sync_params()
                self._exec.forward(is_train=True, **feed)
                self._exec.backward()
            return
        self._sync_params()
        self._exec.forward(is_train=is_train, **feed)
        self._outputs = [o._data for o in self._exec.outputs]

    def backward(self, out_grads=None):
        """The executor's backward; in the fused regime the implicit-loss
        backward runs inside ``update``'s step, and ``out_grads`` leave
        the regime (``_degrade_fused``)."""
        assert self.binded and self.params_initialized
        if self._fused is not None and out_grads is not None:
            self._degrade_fused("backward(out_grads=...)")
        if self._fused is not None and self._feed is not None:
            return
        if self._fused is None and self._feed is not None:
            # just left the fused regime with a batch pending
            self._exec.forward(is_train=True, **self._feed)
            self._feed = None
        self._exec.backward(out_grads=out_grads)
        self._outputs = [o._data for o in self._exec.outputs]

    def update(self):
        """The fused step on the stashed training batch (the schedule's
        learning rate goes into the step's device scalar, then the step
        runs: a CUDA graph replay on the card); in the eager regime the
        Updater on every trainable parameter."""
        self._update()

    def _update(self, eager=False):
        """``update``; with ``eager`` around ``FusedSymbolStep.step_eager``
        in place of the graph (an A/B of the two on one tree)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        if self._fused is None:
            for i, name in enumerate(self._param_names):
                if self._grad_req_of(name) == "null" or \
                        name in self._fixed_param_names:
                    continue
                self._updater(i, self._exec.grad_dict[name],
                              self._exec.arg_dict[name])
            return
        if self._feed is None:
            raise MXNetError(
                "update() without a pending training forward; call "
                "forward(batch, is_train=True) first")
        o = self._optimizer
        nu = self._fused.num_update + 1
        self._fused.set_lr(o.lr_scheduler(nu) if o.lr_scheduler is not None
                           else o.lr)
        step = self._fused.step_eager if eager else self._fused.step
        self._outputs = step(self._feed, host=self._host_feed)
        self._outputs_from_step = True
        self._feed = None
        self._params_dirty = True
        o.num_update = self._fused.num_update
        if self._monitor is not None and self._monitor.activated:
            # Monitor.toc reads the executor's arrays: the post-step
            # params
            self._sync_params()

    def _output_tensors(self):
        """The last step's (or forward's) outputs; between a fused
        training forward and ``update``, a training forward of the
        executor on the current params."""
        assert self.binded and self.params_initialized
        if not self._outputs and self._feed is not None:
            self._sync_params()
            self._exec.forward(is_train=True, **self._feed)
            self._outputs = [o._data for o in self._exec.outputs]
        return self._outputs

    def get_outputs(self, merge_multi_context=True):
        """The outputs as NDArrays around the step's (or forward's)
        tensors (``_output_tensors``), with no copy."""
        return [NDArray(t) for t in self._output_tensors()]

    def get_input_grads(self, merge_multi_context=True):
        """The gradients of the data inputs (``bind(inputs_need_grad=
        True)``): the executor's gradient arrays."""
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        """Update ``eval_metric`` with ``labels`` and the outputs. After a
        fused training step the supported metrics are counted inside the
        step (``metric_device.inline_update``): nothing is read from the
        card until the metric is. Eval forwards, outputs asked for
        before ``update`` and the other metrics take the host path."""
        label_dict = dict(zip(self._label_names, labels or []))
        if self._outputs_from_step:
            from .. import metric_device
            if metric_device.inline_update(
                    self._fused, eval_metric, label_dict,
                    dict(zip(self._output_names, self._outputs))):
                return
        eval_metric.update_dict(
            label_dict, dict(zip(self._output_names,
                                 self._output_tensors())))

    def as_predictor(self, buckets=None, compute_dtype=None, **kwargs):
        """A ``serving.Predictor`` of this module's symbol and a copy of
        its current params, on the module's device unless ``device=``
        says otherwise (the module keeps training)."""
        from ..serving import Predictor
        return Predictor.from_module(self, buckets=buckets,
                                     compute_dtype=compute_dtype, **kwargs)

    def install_monitor(self, mon):
        """Attach a Monitor to the executor. In the fused regime the
        batches inside its interval also run the executor's tapped
        forward and backward; the others stay on the captured step."""
        assert self.binded
        self._monitor = mon
        mon.install(self._exec)
