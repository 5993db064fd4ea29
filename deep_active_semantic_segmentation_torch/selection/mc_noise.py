"""MC-noise selector — modes noise_image / noise_feature / noise_variance
(parity: reference active_selection/mc_noise.py, the JAX package's
selection/mc_noise.py).

Vote entropy where the stochasticity is additive input noise sigma=0.125
(mc_noise.py:21-44), the models' feature noise (mc_noise.py:62-84), or
the sum of the feature-noise and the MC-dropout entropies
(mc_noise.py:131-149). All run ``kernels.mc_vote_entropy_maps`` with
another ``noise_mode`` through the MC selectors' shared per-batch scorer
(``base.ActiveSelectionMC._scorer``): batch i draws from
``mc_generator(seed, i)``; the combined scorer draws its feature noise
from ``mc_generator(seed, 2i)`` and its dropout masks from
``mc_generator(seed, 2i + 1)``, as the JAX package folds 2i and 2i + 1
into its key.
"""

from __future__ import annotations

from typing import Dict, Tuple

from deep_active_semantic_segmentation_torch.selection.base import (
    ActiveSelectionMC, ModelBundle)


class ActiveSelectionMCNoise(ActiveSelectionMC):
    def get_vote_entropy_for_images_with_input_noise(
            self, bundle: ModelBundle, images, selection_count, seed: int = 0):
        """mc_noise.py:46-60."""
        return self._rank(bundle, images, selection_count, seed, ("input",))

    def get_vote_entropy_for_images_with_feature_noise(
            self, bundle: ModelBundle, images, selection_count, seed: int = 0):
        """mc_noise.py:116-129."""
        return self._rank(bundle, images, selection_count, seed, ("feature",))

    def get_vote_entropy_for_batch_with_noise_and_vote_entropy(
            self, bundle: ModelBundle, images, selection_count, seed: int = 0):
        """mc_noise.py:131-149: the feature-noise + MC-dropout entropy sum."""
        return self._rank(bundle, images, selection_count, seed,
                          ("feature", "dropout"))

    def create_region_maps(self, bundle: ModelBundle, images,
                           existing_regions, region_size, selection_size,
                           seed: int = 0) -> Tuple[Dict, int]:
        """mc_noise.py:151-195: the combined feature-noise + dropout
        entropy through the shared region pipeline."""
        return self._region_maps(bundle, images, existing_regions,
                                 region_size, selection_size, seed,
                                 ("feature", "dropout"))
