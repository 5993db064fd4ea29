"""CEAL selector — confidence / margin / entropy / fusion / weak labels
(parity: reference active_selection/ceal.py, the JAX package's
selection/ceal.py).

Every scorer is one deterministic forward per batch on the device, TF32
off, with masked per-pixel maps reduced there (ceal.py:19-126); fusion is
the shuffled union (ceal.py:133-140); weak labels are {path: masked argmax
prediction} for the images below a decaying entropy threshold
(ceal.py:142-166). With a mesh, every pass is sharded by scoring batch
and gathered (``base``), and the fusion's shuffled union is rank 0's:
the set's order follows each process's hash seed.
"""

from __future__ import annotations

import random
from typing import Dict, List

from deep_active_semantic_segmentation_torch.selection import kernels
from deep_active_semantic_segmentation_torch.selection.base import (
    ActiveSelectionBase, ModelBundle, rank_ascending, rank_descending)


class ActiveSelectionCEAL(ActiveSelectionBase):
    def __init__(self, dataset_num_classes, dataset_store, crop_size,
                 dataloader_batch_size, device=None, mesh=None):
        super().__init__(dataset_store, crop_size, dataloader_batch_size,
                         device=device, mesh=mesh)
        self.dataset_num_classes = dataset_num_classes

    def _loader_kw(self):
        return dict(include_labels=True, labels_as_mask=self.dataset_num_classes)

    def _score(self, bundle: ModelBundle, images, mode: str) -> List[float]:
        self._check_bundle(bundle)
        model = bundle.model.eval()
        return self._collect_scores(
            images, lambda batch: kernels.softmax_score_per_image(
                model, batch["image"], batch["label"],
                self.dataset_num_classes, mode, labels_packed=True),
            **self._loader_kw())

    def get_least_confident_samples(self, bundle, images, selection_count):
        return rank_ascending(self._score(bundle, images, "confidence"),
                              list(images), selection_count)

    def get_least_margin_samples(self, bundle, images, selection_count):
        return rank_ascending(self._score(bundle, images, "margin"),
                              list(images), selection_count)

    def get_maximum_entropy_samples(self, bundle, images, selection_count):
        """(top ``selection_count`` by entropy, every image's entropy)."""
        entropies = self._score(bundle, images, "entropy")
        return (rank_descending(entropies, list(images), selection_count),
                entropies)

    def get_fusion_of_confidence_margin_entropy_samples(
            self, bundle, images, selection_count, rng: random.Random):
        """The union of the three rankers' picks, shuffled by ``rng`` (the
        AL loop passes its host stream). The union is a ``set`` of paths,
        so its order before the shuffle follows the process's hash seed,
        as in the reference."""
        samples1 = self.get_least_confident_samples(bundle, images,
                                                    selection_count)
        samples2 = self.get_least_margin_samples(bundle, images,
                                                 selection_count)
        samples3 = self.get_maximum_entropy_samples(bundle, images,
                                                    selection_count)[0]
        samples = list(set(samples1 + samples2 + samples3))
        rng.shuffle(samples)
        if self.mesh is not None:
            samples = self.mesh.broadcast_object(samples)
        return samples[:selection_count]

    def get_weakly_labeled_data(self, bundle, images, threshold,
                                entropies=None) -> Dict:
        """{path: (H, W) uint8 prediction, 255 at ignored pixels} for the
        images whose entropy is below ``threshold``."""
        if not entropies:
            entropies = self._score(bundle, images, "entropy")
        selected_images = [img for img, e in zip(images, entropies)
                           if e < threshold]
        if not selected_images:
            return {}
        self._check_bundle(bundle)
        model = bundle.model.eval()
        preds = self._collect_rows(
            selected_images, lambda batch: kernels.weak_label_predictions(
                model, batch["image"], batch["label"],
                self.dataset_num_classes, labels_packed=True)[:batch["nvalid"]],
            **self._loader_kw())
        return dict(zip(selected_images, preds.cpu().numpy()))
