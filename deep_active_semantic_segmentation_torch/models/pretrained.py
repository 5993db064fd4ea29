"""ImageNet-pretrained backbone transplant (parity: the JAX package's
models/pretrained.py:300-347 ``load_backbone_state_dict`` and
``backbone_weights_from_state_dict``; reference
models/backbone/mobilenet.py:130-157 and resnet.py:147-157).

The reference initializes its DeepLab backbone from a downloaded torch
checkpoint; here the checkpoint is a local file: a torch ``.pth`` /
``.pth.tar`` (a bare ``state_dict`` or one under ``state_dict``) or an
``.npz`` holding the same flat keys. Its layout is the bare backbone
(torchvision's ResNet keys, the reference's MobileNetV2 ``features.N``
keys) or a full model dump with the backbone under ``backbone.`` (the
rest of such a dump is not read). The ResNet depth is the file's own
(its count of ``layer3`` blocks: 6 for ResNet-50, 23 for ResNet-101).

What the reference's key-intersection filter drops is dropped here too:
the ImageNet classifier (ResNet's ``fc.*``, MobileNetV2's
``classifier.*``), MobileNetV2's trailing 1x1 conv ``features.18.*``, and
BN's ``num_batches_tracked`` counters. Every other key must name a tensor
of the port's backbone with exactly its shape, and every tensor of the
backbone must be in the file: anything else raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from deep_active_semantic_segmentation_torch.models.backbone.resnet import LAYERS

_DROPPED = ("fc.", "classifier.", "features.18.")
# MobileNetV2 registers slices of ``features`` a second time: same tensors
_ALIASES = ("low_level_features.", "high_level_features.")


def load_backbone_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The flat ``{key: tensor}`` of a ``.pth`` / ``.pth.tar`` / ``.npz``
    file, on the CPU."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: torch.from_numpy(np.array(f[k])) for k in f.files}
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and isinstance(payload.get("state_dict"), dict):
        payload = payload["state_dict"]
    return {k: torch.as_tensor(v) for k, v in payload.items()}


def backbone_state_dict(sd: Dict[str, torch.Tensor], backbone: str
                        ) -> Dict[str, torch.Tensor]:
    """The backbone's tensors of a checkpoint, under the port's backbone
    keys (no prefix), with the dropped keys left out. For a ResNet the
    depth the file holds must be ``backbone``'s."""
    prefix = "backbone." if any(k.startswith("backbone.") for k in sd) else ""
    own = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    own = {k: v for k, v in own.items()
           if not k.startswith(_DROPPED) and not k.endswith("num_batches_tracked")}
    if backbone in LAYERS:
        blocks3 = {int(k.split(".")[1]) for k in own if k.startswith("layer3.")}
        if not blocks3:
            raise ValueError("state_dict has no layer3.* keys: not a "
                             "bottleneck-ResNet checkpoint")
        depth = {6: "resnet", 23: "resnet101"}.get(1 + max(blocks3))
        if depth != backbone:
            raise ValueError(f"the checkpoint's ResNet has {1 + max(blocks3)} "
                             f"layer3 blocks; backbone '{backbone}' has "
                             f"{LAYERS[backbone][2]}")
    elif backbone != "mobilenet":
        raise NotImplementedError(f"no pretrained-backbone mapping for '{backbone}'")
    return own


@torch.no_grad()
def transplant_backbone(module: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` (``backbone_state_dict``'s output) into the backbone
    ``module`` in place; every key and shape must match exactly."""
    target = {k: v for k, v in module.state_dict(keep_vars=True).items()
              if not k.startswith(_ALIASES) and not k.endswith("num_batches_tracked")}
    unknown = sorted(set(weights) - set(target))
    missing = sorted(set(target) - set(weights))
    if unknown or missing:
        raise KeyError(f"backbone checkpoint mismatch: unknown keys "
                       f"{unknown[:5]}, missing keys {missing[:5]}")
    for key, value in weights.items():
        dst = target[key]
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, "
                             f"model shape {tuple(dst.shape)}")
        dst.copy_(value.to(dtype=dst.dtype))
