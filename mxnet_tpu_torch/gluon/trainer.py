"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``;
reference: python/mxnet/gluon/trainer.py).

One device: the Trainer applies the optimizer's rule, any of
``parallel/functional_opt.py``'s, in place, one list update for each
group of parameters that share lr, wd and update count, as the fused
step does; each parameter's state is a tuple of the rule's leaves
(``rule.init``; one leaf is kept as an NDArray, as the eager classes
keep SGD's momentum). kvstore ``None``, ``"device"`` and ``"local"``
need no reduction on one device; any other kvstore raises (several
devices are not ported yet). ``step(batch_size)`` sets ``rescale_grad =
1/batch_size``. ``save_states`` / ``load_states`` pickle the states
(numpy leaves) with the optimizer object, so a file crosses no package.
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
        rule = functional_opt.from_optimizer(o)
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
                states[i] = _as_state(rule.init(weight._data))
            o._update_count(i)
            ws, gs, ss = groups.setdefault(
                (o._get_lr(i), o._get_wd(i), o._index_update_count[i]),
                ([], [], []))
            ws.append(weight._data)
            gs.append(param.grad()._data)
            ss.append(_leaves(states[i]))
        with torch.no_grad():
            for (lr, wd, t), (ws, gs, ss) in groups.items():
                rule.update_(ws, gs, ss, lr, wd, t=t)

    def save_states(self, fname):
        """Write the Updater's states with the optimizer object (the
        reference's pickle: ``Updater.get_states(dump_optimizer=True)``)."""
        from ..base import atomic_write
        with atomic_write(fname) as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load a ``save_states`` file onto the parameters' device."""
        with open(fname, "rb") as f:
            data = f.read()
        updater = self._updaters[0]
        updater.set_states(data, device=self._params[0].data()._data.device
                           if self._params else None)
        self._optimizer = updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))


def _as_state(leaves):
    """A rule's leaves as the Updater keeps a state: None, one NDArray or
    a tuple of them (SGD's momentum is one NDArray, as in the eager
    classes)."""
    from ..ndarray import NDArray
    if not leaves:
        return None
    if len(leaves) == 1:
        return NDArray(leaves[0])
    return tuple(NDArray(x) for x in leaves)


def _leaves(state):
    if state is None:
        return ()
    if isinstance(state, (tuple, list)):
        return tuple(x._data for x in state)
    return (state._data,)
