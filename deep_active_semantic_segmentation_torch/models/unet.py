"""Small 4-level UNet (parity: reference models/unet.py:18-71, the JAX
package's models/unet.py:188-254).

32-64-128-256 double-conv encoder with 2x2 max-pool (torch's floor drop
of an odd last row / column), bilinear align-corners skip upsampling with
a channel concat, a 1x1 classifier and a final resize to the input size,
NCHW. The error head of the two-headed accuracy predictor.

The JAX package runs the full-resolution stages space-to-depth packed, on
a zero-refreshed even canvas at odd sizes (its ops/s2d.py): TPU lane
workarounds that compute the plain UNet term for term. This is the plain
UNet. Module names are the reference's ``state_dict`` keys
(``dconv_downN.{0,1,3,4}``, ``dconv_upN.{0,1,3,4}``, ``conv_last``).

Under ``parallel.spatial.spatial_rows`` ``x`` is this rank's band of
every image's rows, a multiple of 8 rows, and the logits are the same
band of the whole image's: the 3x3 convs fetch their halos
(``layers.Conv2d``), the 2x2 pools stay local (a band's rows split
evenly at every level) and the skip resizes work in global row
coordinates.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_active_semantic_segmentation_torch.models.layers import batch_norm, conv
from deep_active_semantic_segmentation_torch.ops.interpolate import (
    resize_bilinear_align_corners)
from deep_active_semantic_segmentation_torch.parallel.spatial import check_band


def double_conv(cin: int, cout: int) -> nn.Sequential:
    """conv3x3 (bias) -> BN -> ReLU, twice (reference unet.py:8-15)."""
    return nn.Sequential(conv(cin, cout, 3, padding=1, bias=True),
                         batch_norm(cout), nn.ReLU(inplace=True),
                         conv(cout, cout, 3, padding=1, bias=True),
                         batch_norm(cout), nn.ReLU(inplace=True))


class UNet(nn.Module):
    model_name = "unet"
    shard = None   # the spatial axis under spatial_rows

    def __init__(self, in_channels: int = 3, num_classes: int = 2):
        super().__init__()
        self.num_classes = num_classes
        self.dconv_down1 = double_conv(in_channels, 32)
        self.dconv_down2 = double_conv(32, 64)
        self.dconv_down3 = double_conv(64, 128)
        self.dconv_down4 = double_conv(128, 256)
        self.dconv_up3 = double_conv(256 + 128, 128)
        self.dconv_up2 = double_conv(128 + 64, 64)
        self.dconv_up1 = double_conv(64 + 32, 32)
        self.conv_last = conv(32, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor, **_unused) -> torch.Tensor:
        """(B, Cin, H, W) -> (B, num_classes, H, W) logits. Keyword flags of
        the segmentation models (dropout, its generator) are accepted and
        ignored: the UNet has no dropout site."""
        h, w = x.shape[2:]
        if self.shard is not None:
            check_band(self, h)
        conv1 = self.dconv_down1(x)
        conv2 = self.dconv_down2(F.max_pool2d(conv1, 2))
        conv3 = self.dconv_down3(F.max_pool2d(conv2, 2))
        y = self.dconv_down4(F.max_pool2d(conv3, 2))
        for skip, block in ((conv3, self.dconv_up3), (conv2, self.dconv_up2),
                            (conv1, self.dconv_up1)):
            y = resize_bilinear_align_corners(y, *skip.shape[2:], self.shard)
            y = block(torch.cat([y, skip], dim=1))
        return resize_bilinear_align_corners(self.conv_last(y), h, w, self.shard)
