"""BucketingModule: variable-length training with one bound Module per
bucket (counterpart of ``mxnet_tpu/module/bucketing_module.py``;
reference: python/mxnet/module/bucketing_module.py:36).

Each bucket is a ``Module(fused=False)``: its own symbol from
``sym_gen(bucket_key)``, bound with ``shared_module`` to the default
bucket, so every bucket's parameter arrays are the default bucket's
(``simple_bind``'s shared buffer), and every bucket steps the one
optimizer and ``Updater`` the default bucket (or whichever module
``init_optimizer`` ran on) created, so momentum never forks between
buckets. A per-bucket fused step would keep its optimizer state inside
its own program, hence the eager loop. Each bucket's executor takes its
programs from ``compile.shared_programs`` under its program key: equal
buckets (the same symbol and shapes) share them, and on the card every
program is captured once and replayed after that (``compile_report()``).
"""
from __future__ import annotations

import logging
import warnings

from ..context import as_device
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """(reference: bucketing_module.py:36)"""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._compression_params = compression_params
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._group2ctxs = group2ctxs
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None
        self._grad_req = None
        # where fit's data pipeline stages the batches
        self._device = as_device(context[0] if isinstance(
            context, (list, tuple)) else context)

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    def _call_sym_gen(self, bucket_key):
        return self._sym_gen(bucket_key)

    def get_params(self):
        """(reference: bucketing_module.py:133)"""
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. set_params call ignored.",
                          stacklevel=2)
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default-bucket executor (reference:
        bucketing_module.py:246)."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._grad_req = grad_req

        symbol, data_names, label_names = \
            self._call_sym_gen(self._default_bucket_key)
        # fused=False: every bucket must flow through the ONE shared
        # eager updater and the aliased arg arrays; a fused per-bucket
        # step would keep optimizer state inside its private program
        # and fork momentum between buckets
        module = Module(symbol, data_names, label_names, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names,
                        group2ctxs=self._group2ctxs,
                        compression_params=self._compression_params,
                        fused=False)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=self._grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def _borrow_optimizer(self, module, source=None):
        """Point ``module`` at ``source``'s optimizer/updater (default:
        the default bucket) so every bucket steps ONE shared optimizer
        (reference: module.borrow_optimizer in bucketing_module.py:306).
        init_optimizer passes the module it actually initialized —
        _curr_module may not be the default bucket at that point."""
        if source is None:
            source = self._buckets[self._default_bucket_key]
        module._optimizer = source._optimizer
        module._updater = source._updater
        module.optimizer_initialized = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """(reference: bucketing_module.py:306)"""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._call_sym_gen(bucket_key)
            module = Module(symbol, data_names, label_names,
                            logger=self.logger, context=self._context,
                            work_load_list=self._work_load_list,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names,
                            group2ctxs=self._group2ctxs,
                            compression_params=self._compression_params,
                            fused=False)
            module.bind(data_shapes, label_shapes, self._curr_module.
                        for_training, self._curr_module.inputs_need_grad,
                        force_rebind=False, shared_module=self._buckets[
                            self._default_bucket_key],
                        grad_req=self._grad_req)
            if self.optimizer_initialized:
                # a bucket created after init_optimizer borrows the ONE
                # shared optimizer/updater — per-bucket optimizer copies
                # would fork momentum state (reference:
                # bucketing_module.py switch_bucket borrow_optimizer)
                self._borrow_optimizer(module)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                self._borrow_optimizer(mod, source=self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch):
        """Switch to the batch's bucket (reference:
        bucketing_module.py:373)."""
        assert self.binded and self.params_initialized
        bucket_key = data_batch.bucket_key
        original_bucket_key = self._curr_bucket_key
        data_shapes = data_batch.provide_data
        label_shapes = data_batch.provide_label
        self.switch_bucket(bucket_key, data_shapes, label_shapes)
        self.switch_bucket(original_bucket_key, None, None)

    def forward(self, data_batch, is_train=None):
        """(reference: bucketing_module.py:394)"""
        assert self.binded and self.params_initialized
        if data_batch.bucket_key is not None:
            # sync params from previous bucket before switching
            if self._curr_bucket_key != data_batch.bucket_key and \
                    self.params_initialized:
                arg, aux = self._curr_module.get_params()
                self.switch_bucket(data_batch.bucket_key,
                                   data_batch.provide_data,
                                   data_batch.provide_label)
                self._curr_module.set_params(arg, aux)
            else:
                self.switch_bucket(data_batch.bucket_key,
                                   data_batch.provide_data,
                                   data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def install_monitor(self, mon):
        assert self.binded
        for mod in self._buckets.values():
            mod.install_monitor(mon)
