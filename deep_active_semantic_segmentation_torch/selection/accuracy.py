"""Accuracy selectors, the oracle half (parity: reference
active_selection/accuracy.py, the JAX package's selection/accuracy.py):
``accuracy_labels`` ranks the pool by its count of mispredicted valid
pixels against the ground truth (accuracy.py:18-37), and
``accuracy_eval`` replays another run's selections.txt
(accuracy.py:185-197). The accuracy-predictor scorers (the error head,
input gradients, the unsure score and their region maps) are not ported
yet and raise, naming ROADMAP A13b.
"""

from __future__ import annotations

import os
import time

from deep_active_semantic_segmentation_torch.selection import kernels
from deep_active_semantic_segmentation_torch.selection.base import (
    ActiveSelectionBase, ModelBundle, collect_scores, rank_descending)


def _not_ported(*_args, **_kwargs):
    raise NotImplementedError("the accuracy-predictor scorers are not "
                              "ported yet (ROADMAP A13b)")


class ActiveSelectionAccuracy(ActiveSelectionBase):
    def __init__(self, num_classes, dataset_store, crop_size,
                 dataloader_batch_size, device=None):
        super().__init__(dataset_store, crop_size, dataloader_batch_size,
                         device=device)
        self.num_classes = num_classes

    def get_least_accurate_sample_using_labels(self, bundle: ModelBundle,
                                               images, selection_count):
        """The images with the most mispredicted valid pixels first; the
        oracle reads the full label plane, not the packed mask."""
        self._check_bundle(bundle)
        model = bundle.model.eval()
        scores = collect_scores(
            self._paths_loader(images, include_labels=True),
            lambda batch: kernels.misprediction_counts(
                model, batch["image"], batch["label"], self.num_classes))
        return rank_descending(scores, list(images), selection_count)

    get_least_accurate_samples = _not_ported
    get_adversarially_vulnarable_samples = _not_ported
    get_unsure_samples = _not_ported
    get_least_accurate_region_maps = _not_ported

    @staticmethod
    def wait_for_selected_samples(location_to_monitor, images,
                                  poll_seconds: float = 5.0,
                                  timeout: float = None):
        """The paths of ``location_to_monitor`` (a producer run's
        selections.txt) that are in ``images``, in the file's order, once
        the file exists; polled every ``poll_seconds``, and TimeoutError
        after ``timeout`` seconds (None: wait for ever, as the reference
        does)."""
        waited = 0.0
        while not os.path.exists(location_to_monitor):
            time.sleep(poll_seconds)
            waited += poll_seconds
            if timeout is not None and waited >= timeout:
                raise TimeoutError(location_to_monitor)
        with open(location_to_monitor, "r") as f:
            paths = [x.strip().encode("ascii") for x in f.readlines()
                     if x.strip()]
        pool = set(images)
        return [x for x in paths if x in pool]
