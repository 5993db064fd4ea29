"""Shared region-map creation pipeline (parity: the JAX package's
selection/region_pipeline.py, itself reference
active_selection/mc_dropout.py:123-171): per-image score map -> suppress
already-labeled boxes -> all-ones box filter -> global min-max normalize
-> greedy square NMS -> {path: [(r, c, size, size)]}.

Everything stays on the device: each batch's box-sum maps are written
into one (N, S, S) pool stack, the normalization is elementwise f32 there
in place, and the greedy NMS runs there, in place too
(ops/region.square_nms_device), so the pipeline holds one copy of the
stack. Only the selected (image, r, c) box list crosses to the host: at
canonical Cityscapes geometry (2975 images, S = 385) the stack is 1.76 GB.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from deep_active_semantic_segmentation_torch.data.loader import to_device
from deep_active_semantic_segmentation_torch.ops import region as region_ops

STOP_THRESHOLD = 0.01


def minmax_normalize(maps: torch.Tensor) -> torch.Tensor:
    """Global min-max normalization (mc_dropout.py:152-155) of the f32
    ``maps``, in place, exact elementwise f32; returns ``maps``. All-equal
    maps (a fully suppressed or uniform pool) would divide by zero: the
    reference then emits NaN maps and its NMS spins to the full request on
    NaN comparisons; the guard ranks such a pool as all-zero, so the 0.01
    stop fires after one box."""
    lo, hi = maps.min(), maps.max()
    scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.zeros_like(hi))
    return maps.sub_(lo).mul_(scale)


def region_score_maps(score_batch_fn: Callable, loader,
                      existing_regions: List, region_size: int) -> torch.Tensor:
    """(N, S, S) normalized box-sum maps of the pool, on the device:
    score_batch_fn(batch) -> (B, H, W) device score maps, one per pool
    image in ``loader``'s order; ``existing_regions[i]`` holds image i's
    labeled boxes."""
    n = len(existing_regions)
    stack = None
    map_ctr = 0
    for batch in loader:
        maps = score_batch_fn(batch)
        nvalid = batch["nvalid"]
        # suppress already-labeled regions (mc_dropout.py:110-121,145);
        # the multiplier is built and uploaded only for a batch that has
        # labeled boxes (the all-ones map is a no-op)
        batch_regions = [
            existing_regions[map_ctr + i] if map_ctr + i < n else []
            for i in range(maps.shape[0])]
        if any(batch_regions):
            mult = np.stack([
                region_ops.suppression_multiplier(tuple(maps.shape[1:3]), regs)
                for regs in batch_regions])
            maps = maps * to_device(mult, maps.device)
        box = region_ops.box_sum_valid(maps, region_size)   # (B, S, S)
        if stack is None:
            stack = box.new_empty((n,) + tuple(box.shape[1:]))
        # pad rows (trailing batch only) are cut
        stack[map_ctr: map_ctr + nvalid] = box[:nvalid]
        map_ctr += nvalid
    return minmax_normalize(stack)


def create_region_maps_from_scorer(score_batch_fn: Callable, loader,
                                   images: Sequence, existing_regions: List,
                                   region_size: int, selection_size: int,
                                   base_size: int) -> Tuple[Dict, int]:
    """score_batch_fn(batch) -> (B, H, W) device score maps. Returns
    ({path: [(r, c, size, size)]}, number of boxes)."""
    requested = int(math.ceil(region_ops.num_requested_regions(
        selection_size, base_size, region_size)))
    norm = region_score_maps(score_batch_fn, loader, existing_regions,
                             region_size)
    boxes, count = region_ops.square_nms_device(
        norm, region_size, requested, stop_threshold=STOP_THRESHOLD)
    del norm
    boxes, count = boxes.cpu(), int(count)
    regions, num_selected = region_ops.device_boxes_to_regions(
        boxes.numpy(), count, len(images), region_size)
    return region_ops.regions_to_dict(list(images), regions), num_selected
