"""Monitor: tap intermediate op outputs during training for debugging
(counterpart of ``mxnet_tpu/monitor.py``; reference:
python/mxnet/monitor.py:33).

The reference registers a callback the engine calls for every op output;
here an installed executor runs an interpreted walk of the graph on the
batches the monitor is active for (``monitor_all``) and hands each
node's output to the same ``(name, value)`` callback; other batches stay
on the executor's captured programs. ``toc`` adds the arguments and
their gradients.
"""
from __future__ import annotations

import logging
import re

__all__ = ["Monitor"]


class Monitor:
    """Inspect outputs, weights and gradients of a bound executor every
    ``interval`` batches: ``stat_func`` maps an NDArray to a statistic
    (default: the mean absolute value), ``pattern`` filters the names,
    ``sort`` orders the results by name."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                return x.abs().mean()
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))

        # executors probe this to skip the interpreted walk on batches
        # outside the interval
        stat_helper.active = lambda: self.activated
        self.stat_helper = stat_helper

    def install(self, exe, monitor_all=True):
        """Attach to an executor: ``monitor_all`` taps every op output
        (the interpreted walk), otherwise the graph's outputs only."""
        exe.set_monitor_callback(self.stat_helper, monitor_all=monitor_all)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch if the interval elapsed."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting: ``[(step, name, stat string)]``, the
        arguments and their gradients added."""
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
        for exe in self.exes:
            for name, array in zip(exe._symbol.list_arguments(),
                                   exe.arg_arrays):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
            for name, array in zip(exe._symbol.list_arguments(),
                                   exe.grad_arrays):
                if array is not None and self.re_prog.match(name + "_grad"):
                    self.queue.append((self.step, name + "_grad",
                                       self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if not isinstance(v_list, list):
                v_list = [v_list]
            s = ""
            for v in v_list:
                if v.shape in ((1,), ()):
                    s += str(v.asnumpy().reshape(-1)[0]) + "\t"
                else:
                    s += str(v.asnumpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """``toc``, each statistic logged."""
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
