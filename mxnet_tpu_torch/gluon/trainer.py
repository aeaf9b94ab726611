"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``;
reference: python/mxnet/gluon/trainer.py).

One device: the Trainer applies the optimizer's rule, any of
``parallel/functional_opt.py``'s, in place, one list update for each
group of parameters that share lr, wd and update count, as the fused
step does; each parameter's state is a tuple of the rule's leaves
(``rule.init``; one leaf is kept as an NDArray, as the eager classes
keep SGD's momentum). ``kvstore`` is a name for ``kvstore.create`` or a
``KVStore``; one device needs no reduction, so the store is used only
with ``update_on_kvstore=True``: the optimizer then runs in the store
(``set_optimizer``), each step pushes the gradients (compressed when
``compression_params`` are given) and pulls the updated weights back
into the parameters in place, as the reference's trainer.py:111-124 do.
The ``dist*`` stores raise (ROADMAP.md A11). ``step(batch_size)`` sets
``rescale_grad = 1/batch_size``. ``save_states`` / ``load_states``
pickle the states (numpy leaves) with the optimizer object, so a file
crosses no package.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from ..base import MXNetError
from ..parallel import functional_opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


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
        if "dist" in str(getattr(kvstore, "type", kvstore)):
            raise MXNetError(
                f"kvstore {kvstore!r}: the port trains on one device; the "
                "distributed stores are ROADMAP.md A11")
        self._params = list(params)
        self._compression_params = compression_params
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
        self._kvstore_type = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = False

    def _init_kvstore(self):
        """Create the store at the first step (reference: trainer.py:94):
        kept only for a distributed type or ``update_on_kvstore=True``."""
        from .. import kvstore as kvs
        kv = self._kvstore_type
        if isinstance(kv, str):
            kv = kvs.create(kv)
        if kv is not None and (kv.is_distributed
                               or self._update_on_kvstore is True):
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            kv.set_optimizer(self._optimizer)
            self._update_on_kvstore = True
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    kv.init(i, param.list_data())
            self._kvstore = kv
        else:
            self._kvstore = None
            self._update_on_kvstore = False
        self._kv_initialized = True

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
        """Nothing to reduce on one device; with the optimizer in the
        store, the push and pull of ``update``."""
        if not self._kv_initialized:
            self._init_kvstore()

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        o = self._optimizer
        o.rescale_grad = self._scale / batch_size
        self._check_stale(ignore_stale_grad)
        if self._update_on_kvstore:
            # the store runs the optimizer on the pushed gradient; the
            # updated weights come back into the parameters in place
            for i, param in enumerate(self._params):
                if param.grad_req == "null":
                    continue
                self._kvstore.push(i, param.list_grad(), priority=-i)
                self._kvstore.pull(i, param.list_data(), priority=-i)
            return
        states = self._updaters[0].states
        rule = functional_opt.from_optimizer(o)
        groups = {}
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
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

    def _check_stale(self, ignore_stale_grad):
        """Backward stamps every leaf it writes; the same stamp as at the
        last step means backward never reached it (reference:
        trainer.py:176)."""
        if ignore_stale_grad:
            return
        for i, param in enumerate(self._params):
            if param.grad_req != "write":
                continue
            seq = param._check_and_get()._grad_written_seq
            if seq is None or seq == self._last_grad_seq.get(i):
                raise UserWarning(
                    f"Gradient of Parameter `{param.name}` has not been "
                    "updated by backward since last `step`. This could "
                    "mean a bug in your model that made it only use a "
                    "subset of the Parameters for the last forward pass. "
                    "Call step with ignore_stale_grad=True to suppress "
                    "this warning and skip updating of Parameters with "
                    "stale gradient")
            self._last_grad_seq[i] = seq

    def save_states(self, fname):
        """Write the Updater's (or the store's) states with the optimizer
        object (the reference's pickle:
        ``Updater.get_states(dump_optimizer=True)``)."""
        from ..base import atomic_write
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with atomic_write(fname) as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load a ``save_states`` file onto the parameters' device."""
        with open(fname, "rb") as f:
            data = f.read()
        if not self._kv_initialized:
            self._init_kvstore()
        updater = self._kvstore._updater if self._update_on_kvstore \
            else self._updaters[0]
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
