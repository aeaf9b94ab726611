"""BaseModule: the high-level training interface (counterpart of
``mxnet_tpu/module/base_module.py``; reference:
python/mxnet/module/base_module.py — forward_backward :189, score :194,
fit :376).

``fit`` is the reference loop: bind, init_params, init_optimizer, then
per batch forward_backward + update + update_metric, an epoch log, the
epoch-end callbacks and an optional evaluation. The JAX package's data
pipeline wrapper, step timeline, checkpoint manager and auto-resume are
not ported.
"""
from __future__ import annotations

import logging
import time
import warnings
from collections import namedtuple

from .. import metric as metric_mod

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


def _check_input_names(symbol, names, typename, throw):
    """Every name must be an argument of ``symbol``."""
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [a for a in args if not a.endswith(
            ("_weight", "_bias", "_gamma", "_beta"))]
        msg = (f"You created Module with Module(..., {typename}_names="
               f"{names}) but input with name '{name}' is not found in "
               f"symbol.list_arguments(). Did you mean one of:\n\t"
               f"{candidates}")
        if throw:
            raise ValueError(msg)
        warnings.warn(msg)


class BaseModule:
    """The training interface shared by the modules."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- abstract API ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, *args, **kwargs):
        raise NotImplementedError

    def init_params(self, *args, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def prepare(self, data_batch):
        """Hook run on the next batch while the current one trains."""

    # -- derived convenience ---------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        """A training forward, then the backward."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate ``eval_metric`` over ``eval_data`` (eval-mode
        forwards); returns its (name, value) pairs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None):
        """Train over ``train_data`` for epochs ``begin_epoch`` to
        ``num_epoch`` - 1."""
        from .. import initializer as init_mod
        assert num_epoch is not None, "please specify number of epochs"
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                self.forward_backward(data_batch)
                self.update()
                try:
                    next_data_batch = next(data_iter)
                    self.prepare(next_data_batch)
                except StopIteration:
                    end_of_batch = True
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_params_, aux_params_ = self.get_params()
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
