"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``;
reference: python/mxnet/gluon/trainer.py).

One device: the Trainer applies the optimizer's rule
(``parallel/functional_opt.py``) in place, one list update for each
group of parameters that share lr and wd, as the fused step does; the
states live in an ``optimizer.Updater``. kvstore ``None``, ``"device"`` and
``"local"`` need no reduction on one device; any other kvstore raises
(several devices are not ported yet). ``step(batch_size)`` sets
``rescale_grad = 1/batch_size``.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from ..base import MXNetError
from ..parallel import functional_opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


class Trainer:
    """Applies an Optimizer to a set of Parameters (reference:
    trainer.py:30)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(param)}.")
        if kvstore not in _LOCAL_KVSTORES or update_on_kvstore:
            raise MXNetError(
                f"kvstore {kvstore!r} (update_on_kvstore="
                f"{update_on_kvstore}): the port trains on one device, "
                "where only None, 'device' and 'local' apply")
        self._params = list(params)
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            assert not optimizer_params, \
                "optimizer_params must be None if optimizer is an " \
                "Optimizer instance"
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]
        self._last_grad_seq = {}

    @property
    def learning_rate(self):
        o = self._optimizer
        return o.lr if o.lr_scheduler is None else o.lr_scheduler(
            o.num_update)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update with gradients scaled by 1/batch_size (reference:
        trainer.py:156)."""
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Nothing to reduce on one device."""

    def update(self, batch_size, ignore_stale_grad=False):
        o = self._optimizer
        o.rescale_grad = self._scale / batch_size
        states = self._updaters[0].states
        groups = {}
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not ignore_stale_grad and param.grad_req == "write":
                # backward stamps every leaf it writes; the same stamp as
                # at the last step means backward never reached this one
                # (reference: trainer.py:176)
                seq = param._check_and_get()._grad_written_seq
                if seq is None or seq == self._last_grad_seq.get(i):
                    raise UserWarning(
                        f"Gradient of Parameter `{param.name}` has not been "
                        "updated by backward since last `step`. This could "
                        "mean a bug in your model that made it only use a "
                        "subset of the Parameters for the last forward "
                        "pass. Call step with ignore_stale_grad=True to "
                        "suppress this warning and skip updating of "
                        "Parameters with stale gradient")
                self._last_grad_seq[i] = seq
            weight = param.data()
            if i not in states:
                states[i] = o.create_state(i, weight)
            o._update_count(i)
            ws, gs, ss = groups.setdefault((o._get_lr(i), o._get_wd(i)),
                                           ([], [], []))
            ws.append(weight._data)
            gs.append(param.grad()._data)
            ss.append(() if states[i] is None else (states[i]._data,))
        rule = functional_opt.from_optimizer(o)
        with torch.no_grad():
            for (lr, wd), (ws, gs, ss) in groups.items():
                # update_ overwrites the gradients it is given; the
                # Parameters' gradients stay as backward wrote them
                rule.update_(ws, torch._foreach_mul(gs, 1.0), ss, lr, wd)
