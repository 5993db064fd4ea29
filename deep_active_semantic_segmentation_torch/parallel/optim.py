"""Optimizers over learning-rate groups (parity: the JAX package's
parallel/optim.py, whose pure updates reproduce torch's).

* SGD: momentum 0.9, weight decay 5e-4 folded into the gradient, the
  nesterov flag, dampening 0 (``optim.py:67``);
* Adam: betas 0.9/0.999, eps 1e-8, weight decay folded into the gradient
  (``optim.py:82``);
* RMSprop: alpha 0.99, eps 1e-8, no weight decay (``optim.py:55``; the
  JAX trainer builds it with its defaults).

Each group carries ``lr_mult`` (``models/factory.param_groups``);
``set_lr`` writes ``lr * lr_mult`` into every group before a step.
"""

from __future__ import annotations

import torch

_SGD_DEFAULTS = {"momentum": 0.9, "weight_decay": 5e-4, "nesterov": False}


def build_optimizer(name: str, groups, cfg=None) -> torch.optim.Optimizer:
    """``cfg``: anything with ``momentum``, ``weight_decay`` and
    ``nesterov`` (an ``ExperimentConfig``); omitted, the JAX package's
    defaults. The learning rate starts at 0: ``set_lr`` sets it."""
    hp = {k: getattr(cfg, k, v) for k, v in _SGD_DEFAULTS.items()}
    if name == "SGD":
        return torch.optim.SGD(groups, lr=0.0, momentum=hp["momentum"],
                               weight_decay=hp["weight_decay"],
                               nesterov=hp["nesterov"], dampening=0.0)
    if name == "Adam":
        return torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=hp["weight_decay"])
    if name == "RMSprop":
        return torch.optim.RMSprop(groups, lr=0.0, alpha=0.99, eps=1e-8,
                                   weight_decay=0.0)
    raise NotImplementedError(name)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_mult", 1.0)
