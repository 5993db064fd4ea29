"""Model factory (parity: the JAX package's models/factory.py): DeepLab
(MobileNetV2, ResNet-50 or ResNet-101 backbone), ENet, FastSCNN, the UNet
and the two-headed accuracy predictor."""

from __future__ import annotations

from typing import Optional

import torch

from deep_active_semantic_segmentation_torch import resolve_device
from deep_active_semantic_segmentation_torch.models.accuracy_predictor import (
    DeepLabAccuracyPredictor)
from deep_active_semantic_segmentation_torch.models.deeplab import DeepLab
from deep_active_semantic_segmentation_torch.models.enet import ENet
from deep_active_semantic_segmentation_torch.models.fastscnn import FastSCNN
from deep_active_semantic_segmentation_torch.models.layers import init_weights
from deep_active_semantic_segmentation_torch.models.unet import UNet


def build_model(architecture: str, num_classes: int, backbone: str = "mobilenet",
                output_stride: int = 16, mc_dropout: bool = False,
                input_channels: int = 3, device=None,
                generator: Optional[torch.Generator] = None,
                enet_head: bool = False, symmetry: bool = False):
    """The model on ``device`` (the CUDA card by default), its conv kernels
    drawn from ``generator`` (a generator on that device; a fresh one
    seeded 0 when omitted), in eval mode. ``enet_head`` and ``symmetry``
    choose the accuracy predictor's heads."""
    device = resolve_device(device)
    if architecture == "deeplab":
        model = DeepLab(num_classes=num_classes, backbone=backbone,
                        output_stride=output_stride, mc_dropout=mc_dropout,
                        input_channels=input_channels)
    elif architecture == "enet":
        # the JAX package's factory (factory.py:35-37): ReLU throughout
        model = ENet(num_classes=num_classes, encoder_relu=True,
                     decoder_relu=True)
    elif architecture == "fastscnn":
        model = FastSCNN(num_classes=num_classes)
    elif architecture == "unet":
        model = UNet(in_channels=input_channels, num_classes=num_classes)
    elif architecture == "accuracy_predictor":
        model = DeepLabAccuracyPredictor(
            num_classes=num_classes, backbone=backbone,
            output_stride=output_stride, mc_dropout=mc_dropout,
            enet=enet_head, symmetry=symmetry)
    else:
        raise NotImplementedError(architecture)
    model = model.to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_weights(model, generator)
    return model.eval()


def param_groups(model: torch.nn.Module, architecture: str):
    """Optimizer parameter groups with the reference's learning-rate
    multipliers (deeplab.get_1x_lr_params / get_10x_lr_params,
    deeplab.py:71-89; the JAX package's ``lr_multiplier_tree``): for
    DeepLab the backbone at 1x and ASPP + decoder at 10x; for the
    accuracy predictor (the JAX package's models/factory.py:62-70) the
    same split in its DeepLab segmentation head and in a symmetric DeepLab
    error head, 1x for an ENet head and the UNet; one 1x group for every
    other model. ``parallel/optim.set_lr`` reads ``lr_mult``."""
    if architecture in ("deeplab", "accuracy_predictor"):
        heads = ([model] if architecture == "deeplab" else
                 [h for h in (model.deeplab, model.unet) if isinstance(h, DeepLab)])
        tenx = [p for h in heads
                for p in list(h.aspp.parameters()) + list(h.decoder.parameters())]
        ids = {id(p) for p in tenx}
        return [{"params": [p for p in model.parameters() if id(p) not in ids],
                 "lr_mult": 1.0},
                {"params": tenx, "lr_mult": 10.0}]
    return [{"params": list(model.parameters()), "lr_mult": 1.0}]
