"""Atrous Spatial Pyramid Pooling (parity: reference models/aspp.py:8-101,
JAX package models/aspp.py).

Four atrous branches (dilations 1/6/12/18 at os16, 1/12/24/36 at os8) plus
a global-average-pool branch, concat -> 1x1 conv 1280->256 -> BN -> ReLU ->
Dropout2d(0.5). The pool branch runs pool -> 1x1 conv -> ReLU ->
align-corners upsample -> BN, in that order (aspp.py:62-65,79-81): the BN
sits after the upsample, as module ``bn_global_average_pool``.

Height-sharded (``parallel.spatial.spatial_rows``): the atrous convs
fetch their halos (``layers.Conv2d``), the pool is the mean over the
global rows (``parallel.spatial.spatial_mean``), and its upsample from
1x1, a broadcast of the one pooled row every rank holds, fills this
rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deep_active_semantic_segmentation_torch.models.layers import (
    ChannelDropout, batch_norm, conv)
from deep_active_semantic_segmentation_torch.ops.interpolate import (
    global_avg_pool, resize_bilinear_align_corners)


class _ASPPModule(nn.Module):
    def __init__(self, inplanes: int, planes: int, kernel_size: int,
                 padding: int, dilation: int):
        super().__init__()
        self.atrous_conv = conv(inplanes, planes, kernel_size, 1, padding,
                                dilation=dilation)
        self.bn = batch_norm(planes)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.atrous_conv(x)))


class _GlobalAvgPool(nn.Module):
    shard = None   # the spatial axis under spatial_rows

    def forward(self, x):
        return global_avg_pool(x, self.shard)


class ASPP(nn.Module):
    def __init__(self, inplanes: int = 320, output_stride: int = 16):
        super().__init__()
        if output_stride == 16:
            dilations = [1, 6, 12, 18]
        elif output_stride == 8:
            dilations = [1, 12, 24, 36]
        else:
            raise NotImplementedError(output_stride)
        self.aspp1 = _ASPPModule(inplanes, 256, 1, 0, dilations[0])
        self.aspp2 = _ASPPModule(inplanes, 256, 3, dilations[1], dilations[1])
        self.aspp3 = _ASPPModule(inplanes, 256, 3, dilations[2], dilations[2])
        self.aspp4 = _ASPPModule(inplanes, 256, 3, dilations[3], dilations[3])
        self.global_average_pool = nn.Sequential(
            _GlobalAvgPool(), conv(inplanes, 256, 1), nn.ReLU())
        self.bn_global_average_pool = batch_norm(256)
        self.conv1 = conv(1280, 256, 1)
        self.bn1 = batch_norm(256)
        self.relu = nn.ReLU()
        self.dropout = ChannelDropout(0.5)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x1 = self.aspp1(x)
        x2 = self.aspp2(x)
        x3 = self.aspp3(x)
        x4 = self.aspp4(x)
        x5 = self.global_average_pool(x)
        x5 = resize_bilinear_align_corners(x5, x4.shape[2], x4.shape[3])
        x5 = self.bn_global_average_pool(x5)
        y = torch.cat([x1, x2, x3, x4, x5], dim=1)
        y = self.relu(self.bn1(self.conv1(y)))
        return self.dropout(y, generator)
