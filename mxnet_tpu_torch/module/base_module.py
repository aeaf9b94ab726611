"""BaseModule: the high-level training interface (counterpart of
``mxnet_tpu/module/base_module.py``; reference:
python/mxnet/module/base_module.py — forward_backward :189, score :194,
predict :238, fit :376).

``iter_predict`` and ``predict`` run eval forwards (the executor's
captured eval program on the card) and trim each batch's padding rows;
``predict`` concatenates the batches' outputs (``merge_batches``).

``fit`` is the reference loop: bind, init_params, init_optimizer, then
per batch forward_backward + update + update_metric, an epoch log, the
epoch-end callbacks, the checkpoint manager's epoch-end save and an
optional evaluation. Its train iterator goes through the asynchronous
data pipeline (``data.maybe_wrap_for_fit``, ``MXTPU_DATA_PIPELINE``:
read-ahead and staging into the step's device, the stream unchanged),
which ``fit`` closes when it ends, also on an error. With a ``monitor``
it ticks and prints it around every batch. With
``auto_resume`` it first restores the newest valid checkpoint (params,
optimizer state, RNG stream and the data cursor) and skips the epochs
it completed; a cursor saved under the other ``MXTPU_DATA_PIPELINE``
setting is refused with a warning, and the data restart at a fresh
epoch. A step timeline (``telemetry.StepTimeline``) spans the loop:
each step's host wall time splits into ``data_wait`` (the next batch),
``device_step`` (forward_backward + update; the fused step books its
``h2d_stage`` / ``compile`` / replay inside it) and ``metric_ft_sync``
(the metric update); the rest, the batch-end callbacks among it, is the
step's ``unattributed`` time;
with ``MXTPU_TELEMETRY_DIR`` set, step milestones, epoch ends and
snapshots land in the event log, and with ``MXTPU_TRACE_DIR`` the run's
trace (``fit:<symbol>`` -> ``step`` -> phases, and the data pipeline's
stage spans) exports as Chrome trace JSON when the timeline closes,
also on an error.
"""
from __future__ import annotations

import logging
import os
import time
import warnings

import numpy as np

from .. import metric as metric_mod
from ..model import BatchEndParam

__all__ = ["BaseModule", "BatchEndParam"]



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

    def save_params(self, fname):
        """Write the params as ``arg:`` / ``aux:`` entries (a ``.params``
        name gives the JAX package's format)."""
        from .. import ndarray as nd
        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        """Load a ``save_params`` file (either package's) into the
        params, in place."""
        from .. import ndarray as nd
        arg_params, aux_params = {}, {}
        for k, value in nd.load(fname).items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError(f"Invalid param file {fname}")
        self.set_params(arg_params, aux_params)

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

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` for each batch: the eval
        forward's outputs (NDArrays) without the batch's padding rows."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """The eval outputs over ``eval_data`` (an iterator, or an array
        wrapped in an ``NDArrayIter``), padding trimmed: with
        ``merge_batches`` one NDArray per output (just the NDArray for a
        single output unless ``always_output_list``), else a list per
        batch."""
        from .. import io as io_mod
        from .. import ndarray as nd
        assert self.binded and self.params_initialized
        if isinstance(eval_data, np.ndarray) or hasattr(eval_data, "_data"):
            eval_data = io_mod.NDArrayIter(eval_data)
        output_list = [outputs for outputs, _, _ in self.iter_predict(
            eval_data, num_batch=num_batch, reset=reset)]
        if not output_list or not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        for out in output_list:
            assert len(out) == num_outputs, \
                "Cannot merge batches, as num of outputs is not the " \
                "same in mini-batches. Maybe bucketing is used?"
        merged = [nd.concat(*[out[i] for out in output_list], dim=0)
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None,
            checkpoint_manager=None, auto_resume=False):
        """Train over ``train_data`` for epochs ``begin_epoch`` to
        ``num_epoch`` - 1.

        ``checkpoint_manager`` (a ``checkpoint.CheckpointManager`` or a
        directory) saves the full training state at every epoch end:
        params, optimizer state, the epoch cursor, the RNG stream, the
        metric and the train iterator's cursor. ``auto_resume=True``
        restores the newest valid checkpoint first (a torn or corrupt
        newest one falls back to the one before) and continues at the
        epoch after it. ``monitor`` is installed and ticked around every
        batch; ``sparse_row_id_fn`` (row-sparse pulls) is not ported."""
        from .. import initializer as init_mod
        assert num_epoch is not None, "please specify number of epochs"
        if sparse_row_id_fn is not None:
            raise NotImplementedError(
                "sparse_row_id_fn needs row-sparse storage, which is not "
                "ported (ROADMAP.md A6)")
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        if checkpoint_manager is None and auto_resume:
            raise ValueError(
                "fit(auto_resume=True) needs checkpoint_manager= (a "
                "CheckpointManager or a checkpoint directory path)")
        if isinstance(checkpoint_manager, (str, bytes, os.PathLike)):
            from ..checkpoint import CheckpointManager
            checkpoint_manager = CheckpointManager(checkpoint_manager)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        from ..data import maybe_wrap_for_fit
        train_data, owned_pipe = maybe_wrap_for_fit(train_data, self)
        try:
            if checkpoint_manager is not None and auto_resume:
                begin_epoch = self._resume(checkpoint_manager, train_data,
                                           begin_epoch)
            if validation_metric is None:
                validation_metric = eval_metric
            if not isinstance(eval_metric, metric_mod.EvalMetric):
                eval_metric = metric_mod.create(eval_metric)
            self._fit_loop(train_data, eval_data, eval_metric,
                           validation_metric, epoch_end_callback,
                           batch_end_callback, eval_end_callback,
                           eval_batch_end_callback, begin_epoch, num_epoch,
                           checkpoint_manager, monitor)
        finally:
            if owned_pipe is not None:
                # fit made the pipeline: join its threads even when
                # training dies mid-epoch
                owned_pipe.close()
        if checkpoint_manager is not None:
            # an async save still writing is joined (and its failure
            # raised) before fit returns
            checkpoint_manager.wait()

    def _fit_loop(self, train_data, eval_data, eval_metric,
                  validation_metric, epoch_end_callback, batch_end_callback,
                  eval_end_callback, eval_batch_end_callback, begin_epoch,
                  num_epoch, checkpoint_manager, monitor=None):
        """The epochs of :meth:`fit` under one
        :class:`~mxnet_tpu_torch.telemetry.StepTimeline` (closed also when
        training raises)."""
        from ..telemetry import StepTimeline
        sym_name = getattr(self._symbol, "name", None) or "module"
        tl = StepTimeline(name=f"fit:{sym_name}").activate()
        if tl.trace_id is not None:
            # the data pipeline's source / decode / stage spans (recorded
            # on its threads) join this run's trace tree
            setter = getattr(train_data, "set_trace", None)
            if callable(setter):
                setter(tl.trace_id, tl.root_span_id)
        try:
            self._fit_epochs(train_data, eval_data, eval_metric,
                             validation_metric, epoch_end_callback,
                             batch_end_callback, eval_end_callback,
                             eval_batch_end_callback, begin_epoch,
                             num_epoch, checkpoint_manager, tl, monitor)
        finally:
            tl.close()

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, epoch_end_callback,
                    batch_end_callback, eval_end_callback,
                    eval_batch_end_callback, begin_epoch, num_epoch,
                    checkpoint_manager, tl, monitor=None):
        from ..telemetry import export as _texp
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            # the epoch's first step opens before the epoch-start fetch,
            # so that data wait is attributed to it (the loop's
            # step_start is a no-op while a step is open)
            tl.step_start()
            with tl.phase("data_wait"):
                next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                tl.step_start()
                if monitor is not None:
                    monitor.tic()
                with tl.phase("device_step"):
                    self.forward_backward(data_batch)
                    self.update()
                try:
                    with tl.phase("data_wait"):
                        next_data_batch = next(data_iter)
                    self.prepare(next_data_batch)
                except StopIteration:
                    end_of_batch = True
                with tl.phase("metric_ft_sync"):
                    self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
                tl.step_end(epoch=epoch)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            toc = time.time()
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, toc - tic)
            if _texp.enabled():
                _texp.emit_event(
                    "epoch", name=tl.name, epoch=epoch, nbatch=nbatch,
                    time_s=round(toc - tic, 4),
                    metrics={n: float(v) for n, v
                             in eval_metric.get_name_value()})
            if epoch_end_callback is not None:
                arg_params_, aux_params_ = self.get_params()
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if checkpoint_manager is not None:
                # tag epoch + 1, the next epoch to run, which auto_resume
                # takes as begin_epoch; the iterator's cursor rides along
                data_state = None
                if callable(getattr(train_data, "get_state", None)):
                    try:
                        data_state = train_data.get_state()
                    except NotImplementedError:
                        # an iterator that cannot place itself (a
                        # ResizeIter over one without a cursor): the
                        # checkpoint carries no data cursor
                        data_state = None
                checkpoint_manager.save_module(self, epoch + 1,
                                               nbatch=nbatch,
                                               eval_metric=eval_metric,
                                               data_state=data_state)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def _resume(self, checkpoint_manager, train_data, begin_epoch):
        """Restore the newest valid checkpoint into this module and the
        data cursor into ``train_data``; the epoch to continue at."""
        resumed = checkpoint_manager.restore(self)
        if resumed is None:
            return begin_epoch
        begin_epoch = max(begin_epoch, resumed.epoch)
        self.logger.info("Auto-resume from checkpoint '%s': continuing at "
                         "epoch %d", resumed.path, begin_epoch)
        ds = resumed.data_state
        if ds is not None and callable(getattr(train_data, "set_state",
                                               None)):
            # the saved cursor is the end-of-epoch state from before the
            # stop: replay the epoch-end reset() that run never reached
            try:
                train_data.set_state(ds)
                train_data.reset()
            except (ValueError, NotImplementedError) as e:
                # a cursor of another iterator regime (the data pipeline
                # toggled between save and resume): the params resume,
                # the data restart at a fresh epoch
                self.logger.warning(
                    "Auto-resume could not restore the data cursor (%s); "
                    "the input stream restarts from a fresh epoch", e)
        return begin_epoch
