"""Optimizers (counterpart of ``mxnet_tpu/optimizer.py``; reference:
python/mxnet/optimizer.py:34-530): the ``Optimizer`` base with its
per-parameter ``lr_mult`` / ``wd_mult`` and the SGD rule.

The fused training step (``module/fused.py``) reads the optimizer's
hyperparameters and multipliers and applies the rule of
``parallel/functional_opt.py``; the per-index ``update`` of the eager
Updater loop is not ported.
"""
from __future__ import annotations

import warnings

__all__ = ["Optimizer", "SGD", "create", "register"]


class Optimizer:
    """Base optimizer: learning rate (or schedule), weight decay,
    gradient rescale and clip, and the per-parameter multipliers."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        """Register an optimizer under its lowercase class name."""
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            warnings.warn(f"WARNING: New optimizer {klass.__name__} is "
                          f"overriding existing optimizer "
                          f"{Optimizer.opt_registry[name].__name__}")
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name}")

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict), \
            "param_idx2name should be a dict of param indexes to names."
        self.idx2name = param_idx2name.copy()
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.set_lr_mult({})
        self.set_wd_mult({})

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined. Note that set_learning_rate can mutate "
                              "the value of the learning rate of the optimizer "
                              "only when the LRScheduler of the optimizer is "
                              "undefined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        """Per-name learning-rate multipliers: the symbol's
        ``__lr_mult__`` attributes, then ``args_lr_mult``."""
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Per-name weight-decay multipliers. Every parameter whose name
        ends neither in ``_weight`` nor in ``_gamma`` (biases, betas)
        gets 0, by name alone; then the symbol's ``__wd_mult__``
        attributes and ``args_wd_mult``."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum: ``g = rescale*grad`` (clipped) ``+ wd*w``,
    ``mom = momentum*mom - lr*g``, ``w += mom`` (``w -= lr*g`` without
    momentum), state in fp32 — applied by the fused step through
    ``parallel/functional_opt.py``."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update
