"""Learning-rate schedulers (counterpart of ``mxnet_tpu/lr_scheduler.py``;
reference: python/mxnet/lr_scheduler.py:53-140): the step schedules,
the polynomial decay, and the JAX package's cosine decay and linear
warmup."""
from __future__ import annotations

import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "WarmupScheduler"]


class LRScheduler:
    """Base scheduler: maps num_update to a learning rate."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates, not below ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info(
                    "Update[%d]: now learning rate arrived at %0.5e, will not "
                    "change in the future", num_update, self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each step listed in ``step`` (increasing)."""

    def __init__(self, step, factor=1):
        super().__init__()
        assert isinstance(step, list) and len(step) >= 1
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing integer "
                                 "list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or equal "
                                 "than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero at ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        assert isinstance(max_update, int)
        if max_update < 1:
            raise ValueError("maximum number of updates must be strictly "
                             "positive")
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.power = pwr
        self.base_lr = self.base_lr_orig

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * \
                pow(1.0 - float(num_update) / float(self.max_update),
                    self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay from ``base_lr`` to ``final_lr`` at ``max_update``,
    after an optional linear warmup."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0,
                 warmup_steps=0, warmup_begin_lr=0.0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.max_lr = base_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.warmup_begin_lr + \
                (self.max_lr - self.warmup_begin_lr) * \
                num_update / max(1, self.warmup_steps)
        progress = min(1.0, (num_update - self.warmup_steps) /
                       max(1, self.max_update - self.warmup_steps))
        return self.final_lr + (self.max_lr - self.final_lr) * \
            0.5 * (1 + math.cos(math.pi * progress))


class WarmupScheduler(LRScheduler):
    """Linear warmup in front of another scheduler."""

    def __init__(self, scheduler, warmup_steps, warmup_begin_lr=0.0):
        super().__init__(scheduler.base_lr)
        self.scheduler = scheduler
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.warmup_begin_lr + \
                (self.base_lr - self.warmup_begin_lr) * \
                num_update / max(1, self.warmup_steps)
        return self.scheduler(num_update)
