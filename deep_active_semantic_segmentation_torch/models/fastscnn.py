"""Fast-SCNN (parity: reference models/fastscnn.py:6-194, the JAX
package's models/fastscnn.py).

learning-to-downsample -> global feature extractor (inverted residuals +
PSP pooling) -> feature fusion -> classifier -> align-corners upsample,
NCHW. The reference's classifier applies ``sconv1`` twice with shared
weights (fastscnn.py:178-179), and so does this one; its ``sconv2``,
which its forward never calls, is not built, so a reference
``state_dict`` loads with its ``classifier.sconv2.*`` keys left out
(``load_reference_state_dict``). PSP's adaptive pools use torch's
``AdaptiveAvgPool2d`` bin edges, the JAX package's averaging matrices.

Module names are the reference's, so its ``state_dict`` keys are this
model's: ``learning_to_downsample.sconv1.0.weight``,
``global_feature_extractor.first_block.0.conv.3.weight``,
``global_feature_extractor.ppm.stages.2.1.weight``, ...

The model has no dropout and no noise site: ``use_dropout``,
``generator`` and ``noisy_features`` are accepted for the interface the
selectors call, and change nothing, as in the JAX package. With
``upsample_logits=False`` the forward returns the classifier's 1/8
logits, which the MC sweep upsamples and votes on unfused.

Under ``parallel.spatial.spatial_rows`` ``x`` is this rank's band of
every image's rows, a multiple of 32 rows, and the logits are the same
band of the whole image's: the strided and depthwise convs fetch their
halos (``layers.Conv2d``), PSP's adaptive pools average the global rows
(``parallel.spatial.band_adaptive_pool``: the same small map on every
rank) and resize it to this rank's rows (``resize_replicated``), and the
fusion's 4x and the final resizes work in global row coordinates.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deep_active_semantic_segmentation_torch.models.layers import batch_norm, conv
from deep_active_semantic_segmentation_torch.ops.interpolate import (
    resize_bilinear_align_corners)
from deep_active_semantic_segmentation_torch.parallel.spatial import (
    band_adaptive_pool, check_band, resize_replicated)


class ConvBlock(nn.Module):
    """conv -> BN -> ReLU (fastscnn.py:6-31)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 2,
                 padding: int = 1, groups: int = 1):
        super().__init__()
        self.conv1 = conv(cin, cout, kernel, stride, padding, groups=groups)
        self.bn = batch_norm(cout)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv1(x)))


def separable_conv(cin: int, cout: int) -> nn.Sequential:
    """3x3/s2 depthwise -> BN -> 1x1 -> BN -> ReLU (fastscnn.py:39-50)."""
    return nn.Sequential(conv(cin, cin, 3, 2, 1, groups=cin), batch_norm(cin),
                         conv(cin, cout, 1), batch_norm(cout), nn.ReLU())


class LearningToDownsample(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBlock(3, 32)
        self.sconv1 = separable_conv(32, 48)
        self.sconv2 = separable_conv(48, 64)

    def forward(self, x):
        return self.sconv2(self.sconv1(self.conv1(x)))


class InvertedResidual(nn.Module):
    """fastscnn.py:83-122: 1x1 expand -> 3x3 depthwise -> 1x1 linear."""

    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int = 6):
        super().__init__()
        hidden = round(inp * expand_ratio)
        self.use_res = stride == 1 and inp == oup
        self.conv = nn.Sequential(
            conv(inp, hidden, 1), batch_norm(hidden), nn.ReLU(),
            conv(hidden, hidden, 3, stride, 1, groups=hidden),
            batch_norm(hidden), nn.ReLU(),
            conv(hidden, oup, 1), batch_norm(oup))

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


def adaptive_pool_matrix(in_size: int, out_size: int, device,
                         dtype=torch.float32) -> torch.Tensor:
    """(out, in) averaging matrix with torch ``AdaptiveAvgPool2d``'s bin
    edges: bin i covers [floor(i*in/out), ceil((i+1)*in/out))."""
    a = torch.zeros(out_size, in_size, device=device, dtype=dtype)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)
        a[i, start:end] = 1.0 / (end - start)
    return a


class _AdaptiveAvgPool(nn.Module):
    """``AdaptiveAvgPool2d(size)`` as two averaging-matrix products in f32
    (the JAX package's ``adaptive_avg_pool``; in f64 for an f64 ``x``);
    parameter-free, so it holds the reference's ``stages.{i}.0`` slot.
    ``shard``: over the global rows of the bands."""

    shard = None   # the spatial axis under spatial_rows

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x):
        dt = torch.promote_types(x.dtype, torch.float32)
        n = self.shard.world if self.shard is not None else 1
        ah = adaptive_pool_matrix(x.shape[2] * n, self.size, x.device, dt)
        aw = adaptive_pool_matrix(x.shape[3], self.size, x.device, dt)
        if self.shard is not None:
            return band_adaptive_pool(x, ah, aw, self.shard)
        y = torch.einsum("ph,bchw,qw->bcpq", ah, x.to(dt), aw)
        return y.to(x.dtype)


class PSPModule(nn.Module):
    """fastscnn.py:126-146: pyramid adaptive pools (1, 2, 3, 6), a 1x1
    conv each, align-corners upsample, concat with the input, 1x1
    bottleneck with bias, ReLU."""

    shard = None   # the spatial axis under spatial_rows

    def __init__(self, features: int = 128, out_features: int = 128,
                 sizes=(1, 2, 3, 6)):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(_AdaptiveAvgPool(s), conv(features, features, 1))
            for s in sizes)
        self.bottleneck = conv(features * (len(sizes) + 1), out_features, 1,
                               bias=True)
        self.relu = nn.ReLU()

    def forward(self, x):
        h, w = x.shape[2:]
        if self.shard is not None:
            priors = [resize_replicated(stage(x), h, w, self.shard)
                      for stage in self.stages]
        else:
            priors = [resize_bilinear_align_corners(stage(x), h, w)
                      for stage in self.stages]
        return self.relu(self.bottleneck(torch.cat(priors + [x], dim=1)))


class GlobalFeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.first_block = nn.Sequential(InvertedResidual(64, 64, 2),
                                         InvertedResidual(64, 64, 1),
                                         InvertedResidual(64, 64, 1))
        self.second_block = nn.Sequential(InvertedResidual(64, 96, 2),
                                          InvertedResidual(96, 96, 1),
                                          InvertedResidual(96, 96, 1))
        self.third_block = nn.Sequential(InvertedResidual(96, 128, 1),
                                         InvertedResidual(128, 128, 1),
                                         InvertedResidual(128, 128, 1))
        self.ppm = PSPModule(128, 128)

    def forward(self, x):
        return self.ppm(self.third_block(self.second_block(self.first_block(x))))


class FeatureFusion(nn.Module):
    """fastscnn.py:149-166: 4x upsample of the low-resolution branch,
    depthwise ConvBlock, 1x1; plus a 1x1 of the high-resolution branch."""

    shard = None   # the spatial axis under spatial_rows

    def __init__(self):
        super().__init__()
        self.sconv1 = ConvBlock(128, 128, stride=1, groups=128)
        self.conv_low_res = conv(128, 128, 1, bias=True)
        self.conv_high_res = conv(64, 128, 1, bias=True)
        self.relu = nn.ReLU()

    def forward(self, high, low):
        low = resize_bilinear_align_corners(low, low.shape[2] * 4,
                                            low.shape[3] * 4, self.shard)
        low = self.conv_low_res(self.sconv1(low))
        return self.relu(self.conv_high_res(high) + low)


class Classifier(nn.Module):
    """fastscnn.py:169-180: ``sconv1`` twice (shared weights), 1x1 conv."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.sconv1 = ConvBlock(128, 128, stride=1, groups=128)
        self.conv = conv(128, num_classes, 1, bias=True)

    def forward(self, x):
        return self.conv(self.sconv1(self.sconv1(x)))


class FastSCNN(nn.Module):
    model_name = "fastscnn"
    shard = None   # the spatial axis under spatial_rows

    def __init__(self, num_classes: int = 19):
        super().__init__()
        self.num_classes = num_classes
        self.learning_to_downsample = LearningToDownsample()
        self.global_feature_extractor = GlobalFeatureExtractor()
        self.feature_fusion = FeatureFusion()
        self.classifier = Classifier(num_classes)

    def forward(self, x, use_dropout: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                noisy_features: bool = False, upsample_logits: bool = True):
        height = x.shape[2]
        if self.shard is not None:
            check_band(self, height)
            height *= self.shard.world
        for side in (height, x.shape[3]):
            if -(-side // 8) % 4:
                raise ValueError(
                    f"FastSCNN's feature fusion adds a 1/8 map to a 4x "
                    f"upsample of a 1/32 one, which only meet when "
                    f"ceil(side / 8) is a multiple of 4 (the reference and "
                    f"the JAX package fail at other sizes too) - got "
                    f"{(height, x.shape[3])}. Use e.g. --crop-size 512.")
        shared = self.learning_to_downsample(x)
        y = self.feature_fusion(shared, self.global_feature_extractor(shared))
        y = self.classifier(y)
        if upsample_logits:
            y = resize_bilinear_align_corners(y, x.shape[2], x.shape[3], self.shard)
        return y


def load_reference_state_dict(model: FastSCNN, state_dict) -> None:
    """Load a reference FastSCNN ``state_dict`` (strict otherwise): its
    never-called ``classifier.sconv2.*`` tensors are left out."""
    model.load_state_dict({k: v for k, v in state_dict.items()
                           if not k.startswith("classifier.sconv2.")})
