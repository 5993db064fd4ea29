"""DeepLab-v3+ decoder (parity: reference models/decoder.py:9-60, JAX
package models/decoder.py).

Low-level 1x1 -> 48ch, concat ``[aspp, low]`` after the align-corners
upsample of the ASPP output (304ch), two 3x3 convs, Dropout2d(0.25) before
the classifier. Returns ``(logits, second_to_last_features)``; the
304-channel concat is the core-set / max-subset feature tap.
``last_conv`` keeps the reference's Sequential indices (the dropout at
index 6, the classifier at 7), so the state_dict keys are the reference's.
Height-sharded (``parallel.spatial.spatial_rows``), the upsample works in
global row coordinates and the 3x3 convs fetch their halos.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deep_active_semantic_segmentation_torch.constants import MC_DROPOUT_RATE
from deep_active_semantic_segmentation_torch.models.layers import (
    ChannelDropout, batch_norm, conv)
from deep_active_semantic_segmentation_torch.ops.interpolate import (
    resize_bilinear_align_corners)


class Decoder(nn.Module):
    shard = None   # the spatial axis under spatial_rows

    def __init__(self, num_classes: int, low_level_inplanes: int = 24):
        super().__init__()
        self.conv1 = conv(low_level_inplanes, 48, 1)
        self.bn1 = batch_norm(48)
        self.relu = nn.ReLU()
        self.last_conv = nn.Sequential(
            conv(304, 256, 3, 1, 1), batch_norm(256), nn.ReLU(),
            conv(256, 256, 3, 1, 1), batch_norm(256), nn.ReLU(),
            ChannelDropout(MC_DROPOUT_RATE),
            conv(256, num_classes, 1, bias=True))

    def forward(self, x, low_level_feat,
                generator: Optional[torch.Generator] = None):
        low = self.relu(self.bn1(self.conv1(low_level_feat)))
        x = resize_bilinear_align_corners(x, low.shape[2], low.shape[3], self.shard)
        second_to_last = torch.cat([x, low], dim=1)
        y = second_to_last
        for layer in self.last_conv[:6]:
            y = layer(y)
        y = self.last_conv[6](y, generator)
        return self.last_conv[7](y), second_to_last
