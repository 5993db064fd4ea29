"""MC-dropout selector — modes random / variance / variance_representative
(parity: reference active_selection/mc_dropout.py, the JAX package's
selection/mc_dropout.py).

Each pool batch runs one ``mc_vote_entropy_maps`` sweep of MC_STEPS
dropout forwards on the device with a generator seeded from (seed, batch
index); images are ranked by mean vote entropy with the reference's
stable descending sort; regions go through the shared region pipeline
(region_pipeline.py).
"""

from __future__ import annotations

import random
from typing import Dict, Tuple

from deep_active_semantic_segmentation_torch import constants
from deep_active_semantic_segmentation_torch.ops.entropy import mean_over_pixels
from deep_active_semantic_segmentation_torch.selection import kernels
from deep_active_semantic_segmentation_torch.selection.base import (
    ActiveSelectionBase, ModelBundle, collect_scores, rank_descending)
from deep_active_semantic_segmentation_torch.selection.region_pipeline import (
    create_region_maps_from_scorer)


class ActiveSelectionMCDropout(ActiveSelectionBase):
    def __init__(self, dataset_num_classes, dataset_store, crop_size,
                 dataloader_batch_size, device=None, mc_dtype=None):
        super().__init__(dataset_store, crop_size, dataloader_batch_size,
                         device=device, mc_dtype=mc_dtype)
        self.dataset_num_classes = dataset_num_classes

    def get_random_uncertainity(self, images, selection_count, rng=None):
        """Random baseline (mc_dropout.py:23-28): python random scores +
        the same stable sort as every other ranker. The scores come from
        ``rng`` (a ``random.Random``; the AL loop passes its host stream),
        else from the module-level ``random``."""
        draw = (rng or random).random
        scores = [draw() for _ in range(len(images))]
        return rank_descending(scores, images, selection_count)

    def _entropy_scorer(self, bundle: ModelBundle, seed: int):
        self._check_bundle(bundle)
        model = kernels.cast_for_mc(bundle.model.eval(), self.mc_dtype())
        batch_index = [0]

        def score_batch(batch):
            gen = kernels.mc_generator(seed, batch_index[0], self.device)
            batch_index[0] += 1
            return kernels.mc_vote_entropy_maps(
                model, batch["image"], batch["label"], gen,
                self.dataset_num_classes, constants.MC_STEPS, "dropout",
                fused_upsample=True, compute_dtype=self.mc_dtype(),
                labels_packed=True)
        return score_batch

    def get_vote_entropy_for_images(self, bundle: ModelBundle, images,
                                    selection_count, seed: int = 0):
        """mc_dropout.py:173-196: rank pool by mean vote entropy."""
        loader = self._paths_loader(images, include_labels=True,
                                    labels_as_mask=self.dataset_num_classes)
        scorer = self._entropy_scorer(bundle, seed)
        scores = collect_scores(loader,
                                lambda batch: mean_over_pixels(scorer(batch)))
        return rank_descending(scores, list(images), selection_count)

    def create_region_maps(self, bundle: ModelBundle, images,
                           existing_regions, region_size, selection_size,
                           seed: int = 0) -> Tuple[Dict, int]:
        """mc_dropout.py:123-171: score every image in ``images``, suppress
        its ``existing_regions``, box-sum, normalize and take square boxes
        on the device. Returns ({path: [(r, c, size, size)]}, box count)."""
        base_size = 512 if self.crop_size == -1 else self.crop_size
        loader = self._paths_loader(images, include_labels=True,
                                    labels_as_mask=self.dataset_num_classes)
        return create_region_maps_from_scorer(
            self._entropy_scorer(bundle, seed), loader, list(images),
            existing_regions, region_size, selection_size, base_size)
