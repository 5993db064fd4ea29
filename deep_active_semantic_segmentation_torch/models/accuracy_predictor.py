"""Two-headed accuracy predictor (parity: reference
models/accuracy_predictor.py:8-42, the JAX package's
models/accuracy_predictor.py:24-73).

A segmentation head (DeepLab, or ENet with ``enet``) and an error head: a
UNet over ``cat([softmax(seg_logits.detach()), image])`` (probabilities
first, as in the JAX package's channel order) that predicts per pixel
whether the segmentation is right (class 1) or wrong (class 0); with
``symmetry`` the error head is a second DeepLab at os8 with 3 + C input
channels and 2 classes. The ``detach`` is the reference's firewall: the
error loss trains the error head only.

``forward(x, unet_only_input=inp)`` runs the error head alone on ``inp``
(the input-gradient selector differentiates it with respect to ``inp``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from deep_active_semantic_segmentation_torch.models.deeplab import DeepLab
from deep_active_semantic_segmentation_torch.models.enet import ENet
from deep_active_semantic_segmentation_torch.models.unet import UNet


class DeepLabAccuracyPredictor(nn.Module):
    model_name = "accuracy_predictor"

    def __init__(self, num_classes: int = 19, backbone: str = "mobilenet",
                 output_stride: int = 16, mc_dropout: bool = False,
                 enet: bool = False, symmetry: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.enet = enet
        self.symmetry = symmetry
        if enet:
            self.deeplab = ENet(num_classes=num_classes, encoder_relu=True,
                                decoder_relu=True)
        else:
            self.deeplab = DeepLab(num_classes=num_classes, backbone=backbone,
                                   output_stride=output_stride,
                                   mc_dropout=mc_dropout)
        if symmetry:
            self.unet = DeepLab(num_classes=2, backbone=backbone,
                                output_stride=8, mc_dropout=False,
                                input_channels=3 + num_classes)
        else:
            self.unet = UNet(in_channels=3 + num_classes, num_classes=2)

    def forward(self, x: torch.Tensor, use_dropout: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                unet_only_input: Optional[torch.Tensor] = None,
                noisy_features: bool = False):
        """(seg_logits (B, C, H, W), err_logits (B, 2, H, W)); the error
        logits alone with ``unet_only_input``."""
        if unet_only_input is not None:
            return self.unet(unet_only_input, use_dropout=use_dropout,
                             generator=generator)
        seg = self.deeplab(x, use_dropout=use_dropout, generator=generator,
                           noisy_features=noisy_features)
        probs = torch.softmax(seg.detach(), dim=1)
        err = self.unet(torch.cat([probs.to(x.dtype), x], dim=1),
                        use_dropout=use_dropout, generator=generator)
        return seg, err
