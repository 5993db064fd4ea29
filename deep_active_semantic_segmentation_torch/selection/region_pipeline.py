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

With a mesh (a data-parallel run) each rank holds the box-sum maps of
its own scoring batches only. The min and max are all-reduced, so every
rank normalizes its maps bit for bit as one rank would; each rank runs
the NMS on its maps, and the ranks' picks with their scores are gathered
and merged. A pick's boxes and scores in one image do not depend on the
other images, and the greedy pass takes picks in descending score (the
first image on ties), so the merge by (score, image, pick order), cut as
the greedy pass cuts (the first pick, then those at or above the stop
threshold, at most the requested count), is the one-rank selection.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
        batch_regions = [
            existing_regions[map_ctr + i] if map_ctr + i < n else []
            for i in range(maps.shape[0])]
        box = _suppressed_box_sums(maps, batch_regions, region_size)  # (B, S, S)
        if stack is None:
            stack = box.new_empty((n,) + tuple(box.shape[1:]))
        # pad rows (trailing batch only) are cut
        stack[map_ctr: map_ctr + nvalid] = box[:nvalid]
        map_ctr += nvalid
    return minmax_normalize(stack)


def _suppressed_box_sums(maps: torch.Tensor, regions: List,
                         region_size: int) -> torch.Tensor:
    """(B, S, S) box sums of a batch's score maps with its images' labeled
    ``regions`` zeroed first (mc_dropout.py:110-121,145); the multiplier is
    built and uploaded only for a batch that has labeled boxes."""
    if any(regions):
        mult = np.stack([
            region_ops.suppression_multiplier(tuple(maps.shape[1:3]), regs)
            for regs in regions])
        maps = maps * to_device(mult, maps.device)
    return region_ops.box_sum_valid(maps, region_size)


def _sharded_region_picks(score_batch_fn: Callable, loader,
                          existing_regions: List, region_size: int,
                          requested: int, mesh) -> Tuple[np.ndarray, int]:
    """The one-rank NMS's (image, r, c) picks and their count, from each
    rank's NMS over its own batches' maps (module docstring)."""
    n = len(existing_regions)
    pieces, owners = [], []
    for batch in loader:
        maps = score_batch_fn(batch)
        first = batch["index"] * maps.shape[0]
        regions = [existing_regions[first + i] if first + i < n else []
                   for i in range(maps.shape[0])]
        nvalid = batch["nvalid"]
        pieces.append(_suppressed_box_sums(maps, regions, region_size)[:nvalid])
        owners += range(first, first + nvalid)
    local = torch.cat(pieces) if pieces else None
    bounds = torch.tensor([-float("inf"), -float("inf")], device=mesh.device)
    if local is not None:
        bounds = torch.stack([-local.min(), local.max()])
    mesh.all_reduce(bounds, op=dist.ReduceOp.MAX)
    picks = []
    if local is not None:
        lo, hi = -bounds[0], bounds[1]
        local.sub_(lo).mul_(torch.where(hi > lo, 1.0 / (hi - lo),
                                        torch.zeros_like(hi)))
        values = torch.zeros(requested, dtype=torch.float32, device=local.device)
        boxes, count = region_ops.square_nms_device(
            local, region_size, requested, stop_threshold=STOP_THRESHOLD,
            values=values)
        count = int(count)
        picks = [(v, owners[i], k, r, c) for k, ((i, r, c), v) in enumerate(
            zip(boxes[:count].tolist(), values[:count].tolist()))]
        del local
    merged = sorted((p for rank_picks in mesh.gather_objects(picks)
                     for p in rank_picks), key=lambda p: (-p[0], p[1], p[2]))
    stop = np.float32(STOP_THRESHOLD)
    kept = merged[:1] + [p for p in merged[1:requested] if p[0] >= stop]
    return np.asarray([p[1:2] + p[3:] for p in kept], np.int64).reshape(-1, 3), len(kept)


def create_region_maps_from_scorer(score_batch_fn: Callable, loader,
                                   images: Sequence, existing_regions: List,
                                   region_size: int, selection_size: int,
                                   base_size: int, mesh=None) -> Tuple[Dict, int]:
    """score_batch_fn(batch) -> (B, H, W) device score maps. Returns
    ({path: [(r, c, size, size)]}, number of boxes). ``mesh``: ``loader``
    yields this rank's batches, each with its global ``index``."""
    requested = int(math.ceil(region_ops.num_requested_regions(
        selection_size, base_size, region_size)))
    if mesh is not None:
        boxes, count = _sharded_region_picks(score_batch_fn, loader,
                                             existing_regions, region_size,
                                             requested, mesh)
        regions, num_selected = region_ops.device_boxes_to_regions(
            boxes, count, len(images), region_size)
        return region_ops.regions_to_dict(list(images), regions), num_selected
    norm = region_score_maps(score_batch_fn, loader, existing_regions,
                             region_size)
    boxes, count = region_ops.square_nms_device(
        norm, region_size, requested, stop_threshold=STOP_THRESHOLD)
    del norm
    boxes, count = boxes.cpu(), int(count)
    regions, num_selected = region_ops.device_boxes_to_regions(
        boxes.numpy(), count, len(images), region_size)
    return region_ops.regions_to_dict(list(images), regions), num_selected
