"""Region-level selection geometry: box-filter scoring, square NMS, masks
(own copy of the JAX package's ops/region.py).

Parity targets:
* box-sum score map — reference active_selection/mc_dropout.py:148-149
  (conv2d of the entropy map with an all-ones region_size^2 kernel, VALID);
  here two separable sliding sums in f32, rows then columns. Neither a
  ones-kernel conv (cuDNN may run it in TF32, 10 mantissa bits) nor an
  integral image (f32 prefix sums reach ~1e6 at 513² and lose ~0.06 when
  differenced) keeps the plateaus of a box-sum map, and rounding there
  reorders the NMS argmax.
* greedy square NMS — mc_dropout.py:82-108, with a per-image running max
  and argmax so that each box rescans one (S, S) map.
* labeled-region suppression — mc_dropout.py:110-121: zero already-labeled
  boxes in the entropy map before scoring.

``square_nms`` is the host (numpy) version, the reference the tests and
``chip_smoke.py`` hold ``square_nms_device`` to; the selection path runs
``square_nms_device`` on the card, where only the box list crosses to the
host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Region = Tuple[int, int, int, int]  # (row, col, height, width)


def box_sum_valid(maps: torch.Tensor, kernel: int) -> torch.Tensor:
    """(B, H, W) -> (B, H-k+1, W-k+1) all-ones box filter, VALID padding,
    summed in f32 over rows, then over columns."""
    x = maps.to(torch.float32)
    x = x.unfold(1, kernel, 1).sum(dim=-1)
    return x.unfold(2, kernel, 1).sum(dim=-1)


def region_mask(shape: Tuple[int, int], regions: Sequence[Region]) -> np.ndarray:
    """Boolean mask that is True inside any of the given (r, c, h, w) boxes."""
    mask = np.zeros(shape, dtype=bool)
    for (r, c, h, w) in regions or ():
        mask[r: r + h, c: c + w] = True
    return mask


def suppression_multiplier(shape: Tuple[int, int],
                           regions: Sequence[Region]) -> np.ndarray:
    """1.0 outside labeled boxes, 0.0 inside (ref suppress_labeled_entropy)."""
    return (~region_mask(shape, regions)).astype(np.float32)


def square_nms(score_maps: np.ndarray, region_size: int,
               max_selection_count: float,
               stop_threshold: float = 0.01) -> Tuple[List[List[Region]], int]:
    """Greedy square NMS over a stack of score maps, on the host.

    Matches reference mc_dropout.py:82-108: pick the global argmax, record a
    (r, c, region, region) box for that image, zero a 2*region-size
    neighbourhood in that image only, stop early once the global max drops
    below ``stop_threshold`` (checked AFTER each selection). ``score_maps``
    is modified in place.
    """
    score_maps = np.ascontiguousarray(score_maps, dtype=np.float32)
    n, S1, S2 = score_maps.shape
    selected: List[List[Region]] = [[] for _ in range(n)]
    # per-image running max + flat argmax (first occurrence, as torch's)
    flat = score_maps.reshape(n, -1)
    per_image_arg = flat.argmax(axis=1)
    per_image_max = flat[np.arange(n), per_image_arg]

    selection_count = 0
    for _ in range(math.ceil(max_selection_count)):
        i = int(per_image_max.argmax())  # first occurrence on ties == flat argmax
        a = int(per_image_arg[i])
        r, c = a // S2, a % S2
        selected[i].append((r, c, region_size, region_size))
        selection_count += 1
        r0, c0 = max(0, r - region_size), max(0, c - region_size)
        r1, c1 = min(S1, r + region_size), min(S2, c + region_size)
        score_maps[i, r0:r1, c0:c1] = 0.0
        per_image_arg[i] = int(flat[i].argmax())
        per_image_max[i] = flat[i, per_image_arg[i]]
        if per_image_max.max() < stop_threshold:
            break

    return selected, selection_count


# the device NMS reads its ``done`` flag on the host once per this many
# boxes, to leave the loop once the stop has fired
DONE_CHECK_EVERY = 64


def square_nms_device(score_maps: torch.Tensor, region_size: int, count: int,
                      stop_threshold: float = 0.01):
    """Greedy square NMS on the maps' device, with ``square_nms``'s
    selection semantics: global first-occurrence argmax, zero the rows and
    columns [x - R, x + R) (clipped) in the picked image only, stop once
    the global max drops below ``stop_threshold`` (checked AFTER each
    selection). At most ``count`` boxes.

    A device ``done`` flag gates every update, so the iterations are
    enqueued back to back; the host reads the flag once per
    DONE_CHECK_EVERY boxes and leaves the loop once it is set. The state is
    a per-image running max and argmax, so each iteration rescans one
    (S1, S2) map. ``score_maps`` is modified in place when it is f32 and
    contiguous (as ``square_nms``'s), else a converted copy is: the caller
    holds one copy of the stack.

    Returns (boxes (count, 3) int64 rows of (image, r, c), number of boxes
    as a 0-d int64 tensor); rows at and past that number are zero.
    """
    N, S1, S2 = score_maps.shape
    R = region_size
    device = score_maps.device
    maps = score_maps.to(torch.float32).contiguous()
    flat = maps.view(N, -1)
    # argmax, not max(dim): only argmax promises the first maximum
    parg = flat.argmax(dim=1)
    pmax = flat.gather(1, parg[:, None])[:, 0]
    rows = torch.arange(S1, device=device)
    cols = torch.arange(S2, device=device)
    boxes = torch.zeros((count, 3), dtype=torch.int64, device=device)
    taken = torch.zeros((), dtype=torch.int64, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    for k in range(count):
        if k and k % DONE_CHECK_EVERY == 0 and bool(done):
            break
        active = ~done
        i = pmax.argmax().view(1)                  # first image on ties
        a = parg.index_select(0, i)
        r, c = a // S2, a % S2
        boxes[k] = torch.where(active, torch.cat([i, r, c]), boxes[k])
        window = (((rows >= r - R) & (rows < r + R))[:, None]
                  & ((cols >= c - R) & (cols < c + R))[None, :])
        img = maps.index_select(0, i)[0]
        img = torch.where(window & active, torch.zeros_like(img), img)
        maps.index_copy_(0, i, img[None])
        fi = img.view(-1)
        ai = fi.argmax().view(1)
        pmax.index_copy_(0, i, fi.index_select(0, ai))
        parg.index_copy_(0, i, ai)
        taken += active.to(torch.int64)
        done = done | (pmax.max() < stop_threshold)
    return boxes, taken


def device_boxes_to_regions(boxes, count: int, num_images: int,
                            region_size: int) -> Tuple[List[List[Region]], int]:
    """(count, 3) device NMS output -> square_nms's per-image lists."""
    selected: List[List[Region]] = [[] for _ in range(num_images)]
    for i, r, c in np.asarray(boxes)[:count]:
        selected[int(i)].append((int(r), int(c), region_size, region_size))
    return selected, int(count)


def num_requested_regions(selection_size: int, base_size: int,
                          region_size: int) -> float:
    """Reference mc_dropout.py:157: pixel-budget to box-count conversion."""
    return (selection_size * base_size * base_size) / (region_size * region_size)


def regions_to_dict(images: Sequence, selected: List[List[Region]]) -> Dict:
    """mc_dropout.py:164-167: keep only images that received boxes."""
    return {images[i]: regs for i, regs in enumerate(selected) if regs}
