"""Learning-rate schedules as plain functions of the global step (parity:
the JAX package's ops/lr_schedule.py, itself the reference
utils/lr_scheduler.py:14-72: poly p=0.9 / cos / step 0.2^(epoch//lr_step),
with linear warmup).

``schedule(step, total_iters=None, iters_per_epoch=None)``: the AL loop
retrains from scratch every round on a growing labeled set, so the round's
geometry may be passed per call; omitted, the geometry the schedule was
made with is used. The "groups 1+ get 10x" rule is the optimizer groups'
``lr_mult`` (``models/factory.param_groups``, ``parallel/optim.set_lr``).
"""

from __future__ import annotations

import math


def make_schedule(mode: str, base_lr: float, num_epochs: int,
                  iters_per_epoch: int, lr_step: int = 0,
                  warmup_epochs: int = 0):
    """Return ``lr(step, total_iters=None, iters_per_epoch=None)`` for mode
    in {'poly', 'cos', 'step'}."""
    if mode not in ("poly", "cos", "step"):
        raise NotImplementedError(mode)
    if lr_step == 0:
        lr_step = 100
    default_total = max(num_epochs * iters_per_epoch, 1)
    default_ipe = iters_per_epoch

    def schedule(step, total_iters=None, iters_per_epoch=None):
        total = default_total if total_iters is None else max(total_iters, 1)
        ipe = default_ipe if iters_per_epoch is None else max(iters_per_epoch, 1)
        t = step / total
        if mode == "cos":
            lr = 0.5 * base_lr * (1.0 + math.cos(t * math.pi))
        elif mode == "poly":
            lr = base_lr * max(1.0 - t, 0.0) ** 0.9
        else:
            lr = base_lr * 0.2 ** math.floor(math.floor(step / ipe) / lr_step)
        warmup_iters = warmup_epochs * ipe
        if warmup_epochs > 0 and step < warmup_iters:
            lr = lr * step / warmup_iters
        return lr

    return schedule


def constant_schedule(base_lr: float):
    def schedule(step, total_iters=None, iters_per_epoch=None):
        return base_lr
    return schedule
