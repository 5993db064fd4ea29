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

from deep_active_semantic_segmentation_torch.selection.base import (
    ActiveSelectionMC, ModelBundle, rank_descending)


class ActiveSelectionMCDropout(ActiveSelectionMC):
    def get_random_uncertainity(self, images, selection_count, rng=None):
        """Random baseline (mc_dropout.py:23-28): python random scores +
        the same stable sort as every other ranker. The scores come from
        ``rng`` (a ``random.Random``; the AL loop passes its host stream),
        else from the module-level ``random``."""
        draw = (rng or random).random
        scores = [draw() for _ in range(len(images))]
        return rank_descending(scores, images, selection_count)

    def get_vote_entropy_for_images(self, bundle: ModelBundle, images,
                                    selection_count, seed: int = 0):
        """mc_dropout.py:173-196: rank pool by mean vote entropy."""
        return self._rank(bundle, images, selection_count, seed)

    def create_region_maps(self, bundle: ModelBundle, images,
                           existing_regions, region_size, selection_size,
                           seed: int = 0) -> Tuple[Dict, int]:
        """mc_dropout.py:123-171: score every image in ``images``, suppress
        its ``existing_regions``, box-sum, normalize and take square boxes
        on the device. Returns ({path: [(r, c, size, size)]}, box count)."""
        return self._region_maps(bundle, images, existing_regions,
                                 region_size, selection_size, seed)
