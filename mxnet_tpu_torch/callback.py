"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``;
reference: python/mxnet/callback.py — do_checkpoint :55, Speedometer
:120, ProgressBar :176).

``Speedometer`` reads the metric every ``frequent`` batches; on the
fused path that read is where the in-step counters are synced
(``metric_device.py``), so between two reads the training loop does not
wait for the card."""
from __future__ import annotations

import logging
import math
import sys
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback that calls ``mod.save_checkpoint`` every
    ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback that writes ``model.save_checkpoint`` files
    every ``period`` epochs."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback that logs the training metric every
    ``period`` batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Log samples/s (and the metric) every ``frequent`` batches."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(msg, param.epoch, count, speed,
                                 *sum(name_value, ()))
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    """A text progress bar over ``total`` batches."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write(f"[{prog_bar}] {percents}%\r")


class LogValidationMetricsCallback:
    """Log the validation metric at the end of an evaluation."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
