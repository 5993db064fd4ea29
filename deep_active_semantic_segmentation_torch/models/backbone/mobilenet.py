"""MobileNetV2 backbone (parity: reference models/backbone/mobilenet.py and
the JAX package's models/backbone/mobilenet.py).

Structure: stem conv_bn(32, stride 2) + 17 inverted-residual blocks with
the reference's dilation-for-output-stride rule, the low-level feature
split after the first four feature blocks, and the optional trailing and
low-level MC-dropout sites. The TF-style ``fixed_padding`` is reproduced
exactly, including its quirk of padding BEFORE the 1x1 expansion conv
(the padded border passes through expand -> BN -> ReLU6 and so is not
zero at the depthwise conv).

Height-sharded (``parallel.spatial.spatial_rows``): the pad rows exist
only at the global top and bottom, so only the first and last band pad
their rows, and they enter the expand BN's statistics there, as in the
whole image; the depthwise conv fetches its halo after the expand BN and
ReLU6 (no halo row enters any BN's statistics) and reads the padded
image's rows in global indices (``layers.Conv2d.edge_rows``).

Module names follow the reference, so ``state_dict`` keys are the
reference's: ``features.N.conv.M.*``, plus the ``low_level_features.*`` /
``high_level_features.*`` aliases the reference registers by slicing
``features`` (the same tensors under a second name).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deep_active_semantic_segmentation_torch.constants import MC_DROPOUT_RATE
from deep_active_semantic_segmentation_torch.models.layers import (
    ChannelDropout, batch_norm, conv, fixed_padding, fixed_padding_rows)

# t (expand), c (channels), n (repeats), s (stride) — mobilenet.py:91-100
INVERTED_RESIDUAL_SETTING = [
    [1, 16, 1, 1],
    [6, 24, 2, 2],
    [6, 32, 3, 2],
    [6, 64, 4, 2],
    [6, 96, 3, 1],
    [6, 160, 3, 2],
    [6, 320, 1, 1],
]


def block_plan(output_stride: int, width_mult: float = 1.0):
    """(cin, cout, stride, dilation, expand) per block: the reference's
    stride/dilation schedule (mobilenet.py:103-123)."""
    plan = []
    input_channel = int(32 * width_mult)
    current_stride = 2  # stem conv
    rate = 1
    for t, c, n, s in INVERTED_RESIDUAL_SETTING:
        if current_stride == output_stride:
            stride, dilation = 1, rate
            rate *= s
        else:
            stride, dilation = s, 1
            current_stride *= s
        output_channel = int(c * width_mult)
        for i in range(n):
            plan.append((input_channel, output_channel,
                         stride if i == 0 else 1, dilation, t))
            input_channel = output_channel
    return plan


class InvertedResidual(nn.Module):
    shard = None   # the spatial axis under spatial_rows

    def __init__(self, inplanes: int, outplanes: int, stride: int,
                 dilation: int, expand_ratio: int):
        super().__init__()
        hidden = round(inplanes * expand_ratio)
        self.dilation = dilation
        self.use_res = stride == 1 and inplanes == outplanes
        depthwise = conv(hidden, hidden, 3, stride, 0, dilation=dilation,
                         groups=hidden)
        depthwise.edge_rows = fixed_padding_rows(3, dilation)
        dw = [depthwise, batch_norm(hidden), nn.ReLU6()]
        project = [conv(hidden, outplanes, 1), batch_norm(outplanes)]
        if expand_ratio == 1:
            self.conv = nn.Sequential(*dw, *project)
        else:
            self.conv = nn.Sequential(conv(inplanes, hidden, 1),
                                      batch_norm(hidden), nn.ReLU6(),
                                      *dw, *project)

    def forward(self, x):
        y = self.conv(fixed_padding(x, 3, self.dilation, self.shard))
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    def __init__(self, input_channels: int = 3, output_stride: int = 8,
                 width_mult: float = 1.0, mc_dropout: bool = False):
        super().__init__()
        stem = int(32 * width_mult)
        layers = [nn.Sequential(conv(input_channels, stem, 3, 2, 1),
                                batch_norm(stem), nn.ReLU6())]
        layers += [InvertedResidual(*p) for p in block_plan(output_stride,
                                                             width_mult)]
        self.features = nn.Sequential(*layers)
        # the reference's split (mobilenet.py:133-134); registering the
        # slices adds their state_dict aliases, exactly as the reference
        self.low_level_features = self.features[0:4]
        self.high_level_features = self.features[4:]
        self.mc_dropout = mc_dropout
        if mc_dropout:
            self.trailing_dropout = ChannelDropout(MC_DROPOUT_RATE)
            self.low_level_dropout = ChannelDropout(MC_DROPOUT_RATE)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                features_only: bool = False, precomputed=None):
        """(high, low_level) features. ``features_only`` returns them
        BEFORE the dropout sites; ``precomputed`` feeds such a pair back
        in and applies only the dropout sites. With the same generator
        state, hoisted == monolithic: the masks are drawn in the same
        order (trailing, then low-level) either way. ``generator=None``
        turns dropout off."""
        if precomputed is not None:
            y, low = precomputed
        else:
            low = self.low_level_features(x)
            y = self.high_level_features(low)
        if features_only:
            return y, low
        if self.mc_dropout:
            y = self.trailing_dropout(y, generator)
            low = self.low_level_dropout(low, generator)
        return y, low
