"""Train and eval steps (parity: the JAX package's parallel/steps.py,
``make_train_step:83``, ``make_eval_step:344`` and the two-headed
``make_dual_train_step:228`` / ``make_dual_eval_step:306``).

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
into one program to save dispatches): the trainer runs one step per
batch, which is numerically what a k-step scan computes.

``mesh`` (``parallel/mesh.py``) with a process group runs the JAX
package's data-parallel step: each rank holds its rows of the global
batch, the model is wrapped in ``DistributedDataParallel`` (gradients
averaged; ``broadcast_buffers`` off, so every rank's BN buffers come from
its own cross-replica statistics and a divergence would show), its
``layers.batch_norm``s are ``CrossReplicaBatchNorm2d``s (the caller
converts them), the loss is built with the mesh (global normalizers) and
the dropout masks are the global batch's rows (``layers.dropout_rows``).
The eval step all-reduces the confusion matrix and the valid count. The
two-headed steps run on one rank (ROADMAP A15b).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deep_active_semantic_segmentation_torch.models.layers import dropout_rows
from deep_active_semantic_segmentation_torch.ops.metrics import confusion_matrix
from deep_active_semantic_segmentation_torch.parallel.optim import set_lr
from deep_active_semantic_segmentation_torch.selection.kernels import (
    normalize_on_device)


def ingest(batch, norm=None):
    """Device half of the uint8 train/eval wire: (NCHW f32 image, long
    labels). ``norm``: the (mean, std) the image is normalized with, one
    value per channel; None is ImageNet's (SEM passes its own,
    ``data/sem.MEAN`` and ``STD``)."""
    return (normalize_on_device(batch["image"], *(norm or ())),
            batch["label"].long())


def _autocast_bf16(compute_dtype: str, remat: bool) -> bool:
    """Whether a train step runs under bf16 autocast; refuses ``remat``
    (see ``make_train_step``) and unknown dtypes."""
    if remat:
        raise NotImplementedError(
            "--remat is not ported: activation checkpointing would redraw "
            "the dropout masks from the explicit generator (ROADMAP A4)")
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype '{compute_dtype}'")
    return compute_dtype == "bfloat16"


def _distributed(mesh) -> bool:
    return mesh is not None and mesh.distributed


def _data_parallel(model, mesh):
    """``model`` in ``DistributedDataParallel`` over ``mesh``'s group,
    buffers not broadcast. DDP's construction broadcasts rank 0's
    parameters, which leaves weights every rank built alike unchanged."""
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(
        model, device_ids=[mesh.device.index] if mesh.device.type == "cuda" else None,
        process_group=mesh.group, broadcast_buffers=False)


def make_train_step(model, optimizer, loss_fn: Callable, schedule: Callable,
                    compute_dtype: str = "float32",
                    generator: Optional[torch.Generator] = None,
                    remat: bool = False, norm=None, mesh=None) -> Callable:
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
    gradients would be wrong. ``norm``: as in ``ingest``. ``mesh``: see
    the module docstring; ``generator`` is then in the same state on
    every rank."""
    bf16 = _autocast_bf16(compute_dtype, remat)
    net, rows = model, (0, 1)
    if _distributed(mesh):
        net, rows = _data_parallel(model, mesh), (mesh.rank, mesh.world)

    def step(batch, step_index: int, total_iters: Optional[int] = None,
             iters_per_epoch: Optional[int] = None):
        image, label = ingest(batch, norm)
        with torch.autocast(image.device.type, dtype=torch.bfloat16,
                            enabled=bf16), dropout_rows(model, *rows):
            out = net(image, use_dropout=generator is not None,
                      generator=generator)
        loss = loss_fn(out.float(), label)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = schedule(step_index, total_iters, iters_per_epoch)
        set_lr(optimizer, lr)
        optimizer.step()
        return {"loss": loss.detach(), "lr": lr}

    return step


def dual_unet_target(seg_logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The error head's per-pixel target (accuracy_predictor_train.py
    :106-110): 1 where the segmentation head's argmax is the label, 0 where
    it is not, 255 where the label is ignored. Long, (B, H, W)."""
    correct = (seg_logits.detach().argmax(dim=1) == label).long()
    return torch.where(label == 255, 255, correct)


def make_dual_train_step(model, optimizer, seg_loss_fn: Callable,
                         err_loss_fn: Callable, schedule: Callable,
                         compute_dtype: str = "float32",
                         generator: Optional[torch.Generator] = None,
                         remat: bool = False) -> Callable:
    """The two-headed step: ``step(batch, step_index, w_dl, w_un,
    total_iters=None, iters_per_epoch=None) -> {'loss', 'loss_dl',
    'loss_un': 0-d device tensors, 'lr': float}`` with loss = w_dl *
    seg_loss + w_un * err_loss, the error head's target from
    ``dual_unet_target``. ``err_loss_fn`` carries the error classes'
    weights ([w_wrong, 1 - w_wrong]). Dropout, ``compute_dtype`` and
    ``remat`` as in ``make_train_step``.

    Both terms are always in the graph: at w_dl = 0 (the staged schedule's
    last third) the segmentation head gets a zero gradient, not none, so
    SGD still applies its weight decay and momentum there, as the JAX
    optimizer does (torch's SGD skips a parameter whose ``.grad`` is
    None)."""
    bf16 = _autocast_bf16(compute_dtype, remat)

    def step(batch, step_index: int, w_dl: float, w_un: float,
             total_iters: Optional[int] = None,
             iters_per_epoch: Optional[int] = None):
        image, label = ingest(batch)
        with torch.autocast(image.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            seg, err = model(image, use_dropout=generator is not None,
                             generator=generator)
        loss_dl = seg_loss_fn(seg.float(), label)
        loss_un = err_loss_fn(err.float(), dual_unet_target(seg, label))
        loss = w_dl * loss_dl + w_un * loss_un
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = schedule(step_index, total_iters, iters_per_epoch)
        set_lr(optimizer, lr)
        optimizer.step()
        return {"loss": loss.detach(), "loss_dl": loss_dl.detach(),
                "loss_un": loss_un.detach(), "lr": lr}

    return step


def make_dual_eval_step(model, num_classes: int, seg_loss_fn: Callable,
                        err_loss_fn: Callable) -> Callable:
    """``step(batch, nvalid, w_dl, w_un) -> {'loss', 'loss_dl', 'loss_un',
    'confusion', 'unet_confusion', 'pred', 'err_pred', 'unet_target'}`` in
    eval mode without gradients; both losses are built with
    ``batch_average=False`` and divided by ``nvalid``, as in
    ``make_eval_step``. ``unet_confusion`` is the 2-class confusion of the
    error head's argmax against ``dual_unet_target``."""

    @torch.no_grad()
    def step(batch, nvalid: int, w_dl: float, w_un: float):
        model.eval()
        image, label = ingest(batch)
        seg, err = model(image)
        target = dual_unet_target(seg, label)
        loss_dl = seg_loss_fn(seg, label) / nvalid
        loss_un = err_loss_fn(err, target) / nvalid
        pred, err_pred = seg.argmax(dim=1), err.argmax(dim=1)
        return {"loss": w_dl * loss_dl + w_un * loss_un,
                "loss_dl": loss_dl, "loss_un": loss_un,
                "confusion": confusion_matrix(label, pred, num_classes),
                "unet_confusion": confusion_matrix(target, err_pred, 2),
                "pred": pred, "err_pred": err_pred, "unet_target": target}

    return step


def make_eval_step(model, num_classes: int, loss_fn: Callable,
                   norm=None, mesh=None) -> Callable:
    """``step(batch, nvalid) -> {'loss', 'confusion', 'pred'}`` in eval mode
    without gradients. ``loss_fn`` is built with ``batch_average=False``;
    the loss divides by the true ``nvalid`` instead (the reference's
    partial-batch average), so padded 255-labelled duplicates change
    nothing. ``norm``: as in ``ingest``. With ``mesh`` (and ``loss_fn``
    built with it) ``batch`` holds this rank's rows, ``nvalid`` counts its
    valid ones, and the loss and confusion are the global batch's on every
    rank; ``pred`` stays this rank's."""

    @torch.no_grad()
    def step(batch, nvalid: int):
        model.eval()
        image, label = ingest(batch, norm)
        out = model(image)
        pred = out.argmax(dim=1)
        confusion = confusion_matrix(label, pred, num_classes)
        if _distributed(mesh):
            nvalid = mesh.all_reduce(torch.tensor(float(nvalid), device=out.device))
            mesh.all_reduce(confusion)
        return {"loss": loss_fn(out, label) / nvalid, "confusion": confusion,
                "pred": pred}

    return step
