"""DeepLab-v3+ (parity: reference models/deeplab.py:11-89, JAX package
models/deeplab.py).

backbone (MobileNetV2, or ResNet-50/101) -> ASPP -> decoder ->
align-corners bilinear upsample to input resolution, NCHW; ASPP's and the
decoder's input widths are the backbone's (320 and 24 for MobileNetV2,
2048 and 256 for ResNet). Call-time flags mirror the JAX package's:

* ``use_dropout`` — activates every Dropout2d site (the reference's
  turn_on_dropout, mc_dropout.py:175-178); defaults to ``self.training``.
  The masks come from ``generator``, which dropout requires.
* ``upsample_logits=False`` — return decoder-resolution logits (the fused
  upsample+argmax kernel consumes them in MC scoring).
* ``backbone_only`` / ``backbone_features`` — the MC hoist: return the
  backbone's pre-dropout feature pair, or feed one back in and skip the
  deterministic backbone. With the same generator state the hoisted
  forward equals the monolithic one: the masks are drawn in the same
  order (backbone trailing, low-level, ASPP, decoder).
* ``noisy_features`` — MC-noise: additive gaussian noise scaled by the
  tensor's |mean| (``layers.feature_noise``) at the normalized input
  (x0.05), the backbone outputs (x0.5 each) and the ASPP output (x0.5),
  drawn from ``generator`` in that order. Refused with the backbone hoist
  (input noise makes the backbone stochastic).
* ``return_features`` — also return the decoder's 304-channel concat
  (the core-set / max-subset feature tap).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deep_active_semantic_segmentation_torch.models.aspp import ASPP
from deep_active_semantic_segmentation_torch.models.backbone import (
    FEATURE_CHANNELS, build_backbone)
from deep_active_semantic_segmentation_torch.models.decoder import Decoder
from deep_active_semantic_segmentation_torch.models.layers import feature_noise
from deep_active_semantic_segmentation_torch.ops.interpolate import (
    resize_bilinear_align_corners)


class DeepLab(nn.Module):
    model_name = "deeplab"

    def __init__(self, num_classes: int = 19, backbone: str = "mobilenet",
                 output_stride: int = 16, mc_dropout: bool = False,
                 input_channels: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = build_backbone(backbone, output_stride, mc_dropout,
                                       input_channels)
        high, low = FEATURE_CHANNELS[backbone]
        self.aspp = ASPP(high, output_stride)
        self.decoder = Decoder(num_classes, low)

    def forward(self, x, use_dropout: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                noisy_features: bool = False,
                upsample_logits: bool = True,
                return_features: bool = False,
                backbone_only: bool = False,
                backbone_features=None):
        if use_dropout is None:
            use_dropout = self.training
        if use_dropout and generator is None:
            raise ValueError("dropout needs an explicit torch.Generator")
        gen = generator if use_dropout else None

        if noisy_features:
            if generator is None:
                raise ValueError("noisy_features needs an explicit "
                                 "torch.Generator")
            if backbone_only or backbone_features is not None:
                raise ValueError("backbone hoist is incompatible with "
                                 "noisy_features (stochastic input noise)")
            x = feature_noise(x, 0.05, generator)
        if backbone_only:
            return self.backbone(x, features_only=True)
        y, low_level_feat = self.backbone(x, gen,
                                          precomputed=backbone_features)
        if noisy_features:
            y = feature_noise(y, 0.5, generator)
            low_level_feat = feature_noise(low_level_feat, 0.5, generator)
        y = self.aspp(y, gen)
        if noisy_features:
            y = feature_noise(y, 0.5, generator)
        logits, features = self.decoder(y, low_level_feat, gen)
        if upsample_logits:
            logits = resize_bilinear_align_corners(logits, x.shape[2],
                                                   x.shape[3])
        if return_features:
            return logits, features
        return logits
