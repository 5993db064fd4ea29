"""Spatial resampling primitives (NCHW).

``resize_bilinear_align_corners`` is torch's own
``F.interpolate(mode='bilinear', align_corners=True)``, the op the
reference model zoo calls (models/deeplab.py:59, decoder.py:45,
aspp.py:80); the JAX package rebuilt it from interpolation-matrix einsums
because ``jax.image.resize`` has no align_corners mode.

``shard`` (the spatial axis, ``parallel/spatial.py``): ``x`` is this
rank's band of rows of a height-sharded tensor, and the result is its
band of the whole tensor's result.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deep_active_semantic_segmentation_torch.parallel.spatial import (
    resize_rows, spatial_mean)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int, shard=None) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, out_h, out_w), bilinear, align_corners; with
    ``shard``, ``h`` and ``out_h`` are this rank's rows of the global
    heights (``parallel.spatial.resize_rows``)."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    if shard is not None:
        return resize_rows(x, out_h, out_w, shard)
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def global_avg_pool(x: torch.Tensor, shard=None) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, 1, 1) mean (torch AdaptiveAvgPool2d((1,1)));
    with ``shard``, over the global rows (``parallel.spatial.spatial_mean``)."""
    if shard is not None:
        return spatial_mean(x, shard)
    return x.mean(dim=(2, 3), keepdim=True)
