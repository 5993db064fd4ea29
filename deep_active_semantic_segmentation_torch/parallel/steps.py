"""Train and eval steps (parity: the JAX package's parallel/steps.py,
``make_train_step:83`` and ``make_eval_step:344``).

Batches arrive on the device as the uint8 wire: NHWC uint8 images, which
``ingest`` normalizes with the host Normalize's f32 math
(``selection/kernels.normalize_on_device``), and uint8 labels, cast to
long. Per-step results stay on the device; the trainer fetches them once
per epoch.

The steps leave the module's mode to the caller: ``Trainer.training``
puts the model in train mode once per epoch (batch statistics, dropout
from the trainer's generator), and the eval step puts it in eval mode. A
caller may thus hold batch norm at its running statistics while it trains
(``model.train()`` then ``.eval()`` on the BN modules), as the parity
tests do.

There is no counterpart of the JAX package's ``scan_steps`` (k steps fused
into one program to save dispatches) or of its device mesh: the trainer
runs one step per batch, which is numerically what a k-step scan computes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deep_active_semantic_segmentation_torch.ops.metrics import confusion_matrix
from deep_active_semantic_segmentation_torch.parallel.optim import set_lr
from deep_active_semantic_segmentation_torch.selection.kernels import (
    normalize_on_device)


def ingest(batch):
    """Device half of the uint8 train/eval wire: (NCHW f32 image, long
    labels)."""
    return normalize_on_device(batch["image"]), batch["label"].long()


def make_train_step(model, optimizer, loss_fn: Callable, schedule: Callable,
                    compute_dtype: str = "float32",
                    generator: Optional[torch.Generator] = None,
                    remat: bool = False) -> Callable:
    """``step(batch, step_index, total_iters=None, iters_per_epoch=None)
    -> {'loss': 0-d device tensor, 'lr': float}``: one forward and
    backward, then the optimizer step at ``schedule(step_index, ...)``.

    ``generator``: the dropout masks' source (a generator on the model's
    device); None turns dropout off. ``compute_dtype='bfloat16'`` runs the
    forward and backward under ``torch.autocast`` with f32 master weights,
    f32 BN statistics and the loss in f32 (the JAX package's bf16 step).
    ``remat`` is refused: ``torch.utils.checkpoint`` restores the default
    generators' state for its recompute, not an explicit dropout
    generator's, so the recomputed forward would draw other masks and the
    gradients would be wrong."""
    if remat:
        raise NotImplementedError(
            "--remat is not ported: activation checkpointing would redraw "
            "the dropout masks from the explicit generator (ROADMAP A4)")
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype '{compute_dtype}'")
    bf16 = compute_dtype == "bfloat16"

    def step(batch, step_index: int, total_iters: Optional[int] = None,
             iters_per_epoch: Optional[int] = None):
        image, label = ingest(batch)
        with torch.autocast(image.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            out = model(image, use_dropout=generator is not None,
                        generator=generator)
        loss = loss_fn(out.float(), label)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = schedule(step_index, total_iters, iters_per_epoch)
        set_lr(optimizer, lr)
        optimizer.step()
        return {"loss": loss.detach(), "lr": lr}

    return step


def make_eval_step(model, num_classes: int, loss_fn: Callable) -> Callable:
    """``step(batch, nvalid) -> {'loss', 'confusion', 'pred'}`` in eval mode
    without gradients. ``loss_fn`` is built with ``batch_average=False``;
    the loss divides by the true ``nvalid`` instead (the reference's
    partial-batch average), so padded 255-labelled duplicates change
    nothing."""

    @torch.no_grad()
    def step(batch, nvalid: int):
        model.eval()
        image, label = ingest(batch)
        out = model(image)
        pred = out.argmax(dim=1)
        return {"loss": loss_fn(out, label) / nvalid,
                "confusion": confusion_matrix(label, pred, num_classes),
                "pred": pred}

    return step
