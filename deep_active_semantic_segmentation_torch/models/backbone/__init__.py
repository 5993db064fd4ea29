"""Backbone factory (parity: reference models/backbone/__init__.py:4-10,
the JAX package's models/backbone/__init__.py). As in the reference, the
'resnet' key builds ResNet-50; 'resnet101' builds ResNet-101."""

from deep_active_semantic_segmentation_torch.models.backbone.mobilenet import MobileNetV2
from deep_active_semantic_segmentation_torch.models.backbone.resnet import LAYERS, ResNet

# (high-level, low-level) feature channels: ASPP's and the decoder's inputs
FEATURE_CHANNELS = {"mobilenet": (320, 24), "resnet": (2048, 256),
                    "resnet101": (2048, 256)}


def build_backbone(backbone: str, output_stride: int, mc_dropout: bool = False,
                   input_channels: int = 3):
    if backbone == "mobilenet":
        return MobileNetV2(input_channels=input_channels,
                           output_stride=output_stride, mc_dropout=mc_dropout)
    if backbone in LAYERS:
        return ResNet(LAYERS[backbone], output_stride=output_stride,
                      input_channels=input_channels)
    raise NotImplementedError(backbone)
