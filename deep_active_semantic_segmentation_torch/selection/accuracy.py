"""Accuracy selectors (parity: reference active_selection/accuracy.py,
the JAX package's selection/accuracy.py).

The oracle half: ``accuracy_labels`` ranks the pool by its count of
mispredicted valid pixels against the ground truth (accuracy.py:18-37),
and ``accuracy_eval`` replays another run's selections.txt
(accuracy.py:185-197).

The accuracy predictor's half, on the two-headed model: the error head's
summed P(wrong) or predicted-wrong count (accuracy.py:39-71), the input
gradient's norm (accuracy.py:73-96), the unsure score 4p - 4p^2
(accuracy.py:98-117) and the error maps' regions (accuracy.py:131-183).
These read labels only through the valid mask, so their loaders ship the
packed 1-bit mask.
"""

from __future__ import annotations

import os
import time

from deep_active_semantic_segmentation_torch.selection import kernels
from deep_active_semantic_segmentation_torch.selection.base import (
    ActiveSelectionBase, ModelBundle, collect_scores, rank_descending)
from deep_active_semantic_segmentation_torch.selection.region_pipeline import (
    create_region_maps_from_scorer)


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

    def _rank_by(self, bundle: ModelBundle, images, selection_count, kernel,
                 *args):
        """``images`` ranked by ``kernel(model, images, packed mask,
        num_classes, *args, labels_packed=True)`` -> (B,) per batch, the
        reference's stable descending sort, top ``selection_count``."""
        self._check_bundle(bundle)
        model = bundle.model.eval()
        scores = collect_scores(
            self._paths_loader(images, include_labels=True,
                               labels_as_mask=self.num_classes),
            lambda batch: kernel(model, batch["image"], batch["label"],
                                 self.num_classes, *args, labels_packed=True))
        return rank_descending(scores, list(images), selection_count)

    def get_least_accurate_samples(self, bundle: ModelBundle, images,
                                   selection_count, mode="softmax"):
        """The images the error head finds most wrong: summed P(wrong)
        (``softmax``) or predicted-wrong pixel count (``argmax``)."""
        if mode not in ("softmax", "argmax"):
            raise NotImplementedError(mode)
        return self._rank_by(bundle, images, selection_count,
                             kernels.error_head_scores, mode)

    def get_adversarially_vulnarable_samples(self, bundle: ModelBundle, images,
                                             selection_count):
        """The images whose error head is most sensitive to its input
        (``kernels.input_gradient_norms``)."""
        return self._rank_by(bundle, images, selection_count,
                             kernels.input_gradient_norms)

    def get_unsure_samples(self, bundle: ModelBundle, images, selection_count):
        """The images whose error head is least sure (mean 4p - 4p^2)."""
        return self._rank_by(bundle, images, selection_count,
                             kernels.error_head_scores, "unsure")

    def get_least_accurate_region_maps(self, bundle: ModelBundle, images,
                                       existing_regions, region_size,
                                       selection_size):
        """Boxes over the error head's P(wrong) maps through the region
        pipeline (base 512 at crop -1). Returns ({path: [(r, c, size,
        size)]}, box count)."""
        self._check_bundle(bundle)
        model = bundle.model.eval()
        base_size = 512 if self.crop_size == -1 else self.crop_size
        loader = self._paths_loader(images, include_labels=True,
                                    labels_as_mask=self.num_classes)
        return create_region_maps_from_scorer(
            lambda batch: kernels.error_head_maps(
                model, batch["image"], batch["label"], self.num_classes,
                labels_packed=True),
            loader, list(images), existing_regions, region_size,
            selection_size, base_size)

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
