"""Core-set selector: k-center greedy over decoder features (parity:
reference active_selection/core_set.py, the JAX package's
selection/core_set.py).

Features keep the reference's pooling geometry, 64x64 / stride 32 for
DeepLab and 32x32 / stride 16 for ENet (core_set.py:44-56), clamped to
the map (``kernels.pooled_features``); they stay on the device, and the
greedy loop runs there (``ops/distance.kcenter_greedy``), TF32 off.
"""

from __future__ import annotations

import torch

from deep_active_semantic_segmentation_torch.ops.distance import kcenter_greedy
from deep_active_semantic_segmentation_torch.selection import kernels
from deep_active_semantic_segmentation_torch.selection.base import (
    ActiveSelectionBase, ModelBundle)

POOLING = {"deeplab": (64, 32), "enet": (32, 16)}


class ActiveSelectionCoreSet(ActiveSelectionBase):
    def extract_features(self, bundle: ModelBundle, images) -> torch.Tensor:
        """(len(images), D) pooled feature vectors on the device."""
        self._check_bundle(bundle)
        model = bundle.model.eval()
        kernel, stride = POOLING[model.model_name]
        chunks = [kernels.pooled_features(model, batch["image"], kernel,
                                          stride)[:batch["nvalid"]]
                  for batch in self._paths_loader(images, include_labels=False)]
        return torch.cat(chunks)

    def get_k_center_greedy_selections(self, selection_size,
                                       bundle: ModelBundle,
                                       candidate_image_batch,
                                       already_selected_image_batch):
        """core_set.py:40-69: features over selected + candidates, k-center
        greedy seeded by the selected set."""
        combined = (list(already_selected_image_batch)
                    + list(candidate_image_batch))
        features = self.extract_features(bundle, combined)
        seed_mask = torch.zeros(len(combined), dtype=torch.bool)
        seed_mask[:len(already_selected_image_batch)] = True
        with kernels._deterministic_precision():
            picked = kcenter_greedy(features, seed_mask, int(selection_size))
        return [combined[i] for i in picked.tolist()]
