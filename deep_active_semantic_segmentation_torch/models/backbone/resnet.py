"""Bottleneck ResNet backbone with a multi-grid layer4 (parity: reference
models/backbone/resnet.py, the JAX package's models/backbone/resnet.py).

The output-stride tables (os16: strides 1/2/2/1, dilations 1/1/1/2; os8:
1/2/1/1 and 1/1/2/4), the multi-grid [1, 2, 4] unit of layer4 (its
blocks' dilations are grid x the stage's), the low-level feature tap after
layer1, and the stem's ``MaxPool2d(3, 2, 1)`` (padding with -inf, as the
JAX package's reduce_window does). Module names are torchvision's
(``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``, ...),
so a torchvision or reference ``state_dict`` loads unchanged.

Height-sharded (``parallel.spatial.spatial_rows``): the 7x7 / stride 2
stem, the strided and dilated 3x3s and the stride-2 1x1 downsample are
``layers.Conv2d``s, which fetch their halos; the stem's pool is
``layers.MaxPool2d``, -inf above the global top only.

The backbone has no dropout site, so the MC hoist is trivial: the
features computed once per batch pass straight through.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from deep_active_semantic_segmentation_torch.models.layers import (
    MaxPool2d, batch_norm, conv)

LAYERS = {"resnet": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation, dilation=dilation)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = batch_norm(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(conv(inplanes, planes * 4, 1, stride),
                                         batch_norm(planes * 4))
                           if downsample else None)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


class ResNet(nn.Module):
    def __init__(self, layers: Sequence[int], output_stride: int = 16,
                 multi_grid: Sequence[int] = (1, 2, 4), input_channels: int = 3):
        super().__init__()
        if output_stride == 16:
            strides, dilations = [1, 2, 2, 1], [1, 1, 1, 2]
        elif output_stride == 8:
            strides, dilations = [1, 2, 1, 1], [1, 1, 2, 4]
        else:
            raise NotImplementedError(output_stride)
        self.conv1 = conv(input_channels, 64, 7, 2, 3)
        self.bn1 = batch_norm(64)
        self.relu = nn.ReLU()
        self.maxpool = MaxPool2d(3, 2, 1)
        inplanes = 64
        grids = [[1] * layers[0], [1] * layers[1], [1] * layers[2],
                 list(multi_grid)]
        for stage, planes in enumerate((64, 128, 256, 512)):
            blocks = []
            for i, grid in enumerate(grids[stage]):
                stride = strides[stage] if i == 0 else 1
                blocks.append(Bottleneck(
                    inplanes, planes, stride, grid * dilations[stage],
                    downsample=i == 0 and (stride != 1 or inplanes != planes * 4)))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x, generator: Optional[torch.Generator] = None,
                features_only: bool = False, precomputed=None):
        """(layer4 output, layer1 output). ``generator`` is accepted for the
        backbone interface (no dropout site draws from it); with
        ``precomputed`` the pair passes straight through."""
        if precomputed is not None:
            return precomputed
        y = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        low = self.layer1(y)
        y = self.layer4(self.layer3(self.layer2(low)))
        return y, low
