"""Segmentation losses (parity: the JAX package's ops/losses.py, itself the
reference utils/loss.py:5-70).

* ``cross_entropy``: torch ``CrossEntropyLoss(weight, ignore_index=255,
  reduction='mean')`` — a weighted mean over non-ignored pixels — then the
  reference's ``batch_average`` quirk of dividing again by the batch size.
  The denominator is guarded as in the JAX package (at least 1 pixel, at
  least 1e-12 of weight), so a batch whose every pixel is 255 gives 0, not
  torch's NaN.
* ``focal_loss``: computed from the *mean* CE (the reference exponentiates
  the averaged log-probability, not per pixel).
* ``sample_weighted_cross_entropy``: per-sample weights (reference
  loss.py:22-37).

Logits are NCHW (any float dtype; the loss is computed in f32), targets
(B, H, W) integers with 255 as the ignore label.

``mesh``: the ranks of a data-parallel step (``parallel/mesh.py``), each
holding its rows of the global batch. The normalizers are then the
global batch's: CE's weight sum over every rank's valid pixels, the
batch size of ``batch_average`` and the sample-weighted batch mean. The
sums cross the ranks through ``cross_replica_sum``, so every rank
computes the global batch's loss, and with DistributedDataParallel's
mean of the gradients the update is that loss's gradient, also where
the ranks hold different counts of valid pixels (a mean of per-rank
losses would weight them wrongly). Without a process group the
arithmetic is the one-card path's.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
    cross_replica_sum)

IGNORE_INDEX = 255


def _global_batch(logits: torch.Tensor, mesh) -> int:
    return logits.shape[0] * (mesh.world if mesh is not None and mesh.distributed
                              else 1)


def _per_pixel(logits: torch.Tensor, target: torch.Tensor, class_weights):
    """(nll, w): per-pixel negative log-likelihood, 0 at ignored pixels,
    and each pixel's weight (its class weight, or 1; 0 where ignored)."""
    target = target.long()
    valid = target != IGNORE_INDEX
    nll = F.cross_entropy(logits.float(), target, ignore_index=IGNORE_INDEX,
                          reduction="none")
    if class_weights is None:
        return nll, valid.float()
    cw = torch.as_tensor(class_weights, dtype=torch.float32, device=nll.device)
    w = torch.where(valid, cw[torch.where(valid, target, 0)], 0.0)
    return nll, w


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  class_weights: Optional[torch.Tensor] = None,
                  batch_average: bool = True, mesh=None) -> torch.Tensor:
    """Mean CE over non-ignored pixels, optionally class-weighted: the
    normalizer is the sum of the contributing pixels' weights."""
    nll, w = _per_pixel(logits, target, class_weights)
    floor = 1e-12 if class_weights is not None else 1.0
    loss = (cross_replica_sum((nll * w).sum(), mesh)
            / cross_replica_sum(w.sum(), mesh).clamp_min(floor))
    if batch_average:
        loss = loss / _global_batch(logits, mesh)
    return loss


def focal_loss(logits: torch.Tensor, target: torch.Tensor,
               gamma: float = 2.0, alpha: Optional[float] = 0.5,
               class_weights: Optional[torch.Tensor] = None,
               batch_average: bool = True, mesh=None) -> torch.Tensor:
    """Focal loss computed from the averaged CE (reference loss.py:53-70);
    with ``mesh``, the global batch's averaged CE."""
    logpt = -cross_entropy(logits, target, class_weights, batch_average=False,
                           mesh=mesh)
    pt = torch.exp(logpt)
    if alpha is not None:
        logpt = logpt * alpha
    loss = -((1.0 - pt) ** gamma) * logpt
    if batch_average:
        loss = loss / _global_batch(logits, mesh)
    return loss


def sample_weighted_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                                  sample_weights: torch.Tensor,
                                  class_weights: Optional[torch.Tensor] = None,
                                  batch_average: bool = True,
                                  mesh=None) -> torch.Tensor:
    """Per-sample weighted CE (reference loss.py:22-37): per-pixel NLL
    (0 at ignored pixels), spatial mean over H*W (ignored pixels in the
    denominator), then a weighted batch mean. With ``mesh``,
    ``sample_weights`` are this rank's rows' and the mean is the global
    batch's."""
    nll, w = _per_pixel(logits, target, class_weights)
    if class_weights is not None:
        nll = nll * w
    per_sample = nll.mean(dim=(1, 2))
    weighted = per_sample * torch.as_tensor(sample_weights, dtype=torch.float32,
                                            device=nll.device)
    if mesh is not None and mesh.distributed:
        loss = cross_replica_sum(weighted.sum(), mesh) / _global_batch(logits, mesh)
    else:
        loss = weighted.mean()
    if batch_average:
        loss = loss / _global_batch(logits, mesh)
    return loss


def build_loss(mode: str = "ce", class_weights: Optional[torch.Tensor] = None,
               batch_average: bool = True, mesh=None):
    """Factory mirroring SegmentationLosses.build_loss (loss.py:14-20);
    ``mesh`` makes the normalizers the global batch's."""
    if mode == "ce":
        return partial(cross_entropy, class_weights=class_weights,
                       batch_average=batch_average, mesh=mesh)
    if mode == "focal":
        return partial(focal_loss, class_weights=class_weights,
                       batch_average=batch_average, mesh=mesh)
    raise NotImplementedError(mode)
