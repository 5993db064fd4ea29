"""Max-subset (representativeness) selector, the second stage of
``variance_representative`` (parity: reference
active_selection/max_subset.py, the JAX package's selection/max_subset.py):
greedy max coverage keeping half the candidates (max_subset.py:121,134)
over pooled features of whole images (max_subset.py:73-89), or over the
mean features of region-grid tiles of the pool and of each candidate
region's crop of the feature map (max_subset.py:49-71,91-113; the
reference's oversized avg-pool kernel is read, as in the JAX package, as
the mean over the crop).

Features are taken on the device with TF32 off and stay there: the tile
and region means are formed on the card and only the picks cross to the
host. With a mesh each rank takes the features of its scoring batches,
and every rank gathers them all and runs the same greedy pass (``base``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from deep_active_semantic_segmentation_torch.ops.distance import max_representative
from deep_active_semantic_segmentation_torch.selection import kernels
from deep_active_semantic_segmentation_torch.selection.base import (
    ActiveSelectionBase, ModelBundle)


class ActiveSelectionMaxSubset(ActiveSelectionBase):
    def _max_representative_samples(self, image_features, candidate_features,
                                     selection_count) -> List[int]:
        with kernels._deterministic_precision():
            picked = max_representative(image_features, candidate_features,
                                        int(selection_count))
        return picked.tolist()

    @staticmethod
    def _convert_regions_to_list(regions: Dict) -> Tuple[List, List]:
        list_images, list_regions = [], []
        for ir in sorted(regions.keys()):
            for r in regions[ir]:
                list_images.append(ir)
                list_regions.append(r)
        return list_images, list_regions

    def _features(self, bundle: ModelBundle, images, row_fn) -> torch.Tensor:
        """``row_fn(model, batch)`` -> the batch's feature rows, over the
        image-only scoring batches of ``images`` (``_collect_rows``)."""
        self._check_bundle(bundle)
        model = bundle.model.eval()
        return self._collect_rows(images, lambda batch: row_fn(model, batch),
                                  include_labels=False)

    def _get_features_for_images(self, bundle: ModelBundle,
                                 images) -> torch.Tensor:
        return self._features(bundle, images, lambda model, batch: (
            kernels.pooled_features(model, batch["image"], 64,
                                    32)[:batch["nvalid"]]))

    def _get_features_for_image_regions(self, bundle: ModelBundle, images,
                                        region_size) -> torch.Tensor:
        """Mean features of the grid tiles of each image's feature map
        (max_subset.py:49-71), (image, tile row, tile column) order."""
        def tile_means(model, batch):
            fmap = kernels.raw_features(model, batch["image"])[:batch["nvalid"]]
            b, fh, fw, c = fmap.shape
            h = math.floor(region_size * fh / self.crop_size)
            w = math.floor(region_size * fw / self.crop_size)
            rows, cols = fh // h, fw // w
            tiles = fmap[:, :rows * h, :cols * w].reshape(b, rows, h, cols, w, c)
            return tiles.mean(dim=(2, 4)).reshape(-1, c)

        return self._features(bundle, images, tile_means)

    def _get_features_for_regions(self, bundle: ModelBundle, list_images,
                                  list_regions) -> torch.Tensor:
        """Mean features of each region's crop of its image's feature map
        (max_subset.py:91-113); a crop is at least one cell each way."""
        def region_means(model, batch):
            fmap = kernels.raw_features(model, batch["image"])
            ratio_r = fmap.shape[1] / self.crop_size
            ratio_c = fmap.shape[2] / self.crop_size
            first = batch["index"] * self.dataloader_batch_size
            feats = []
            for b, region in enumerate(
                    list_regions[first:first + batch["nvalid"]]):
                r = math.floor(region[0] * ratio_r)
                c = math.floor(region[1] * ratio_c)
                h = max(math.floor(region[2] * ratio_r), 1)
                w = max(math.floor(region[3] * ratio_c), 1)
                feats.append(fmap[b, r:r + h, c:c + w].mean(dim=(0, 1)))
            return torch.stack(feats)

        return self._features(bundle, list_images, region_means)

    def get_representative_images(self, bundle: ModelBundle, all_images,
                                  candidate_images):
        """max_subset.py:130-136: keep the representative half."""
        all_feats = self._get_features_for_images(bundle, all_images)
        cand_feats = self._get_features_for_images(bundle, candidate_images)
        picked = self._max_representative_samples(all_feats, cand_feats,
                                                  len(cand_feats) // 2)
        return [candidate_images[i] for i in picked]

    def get_representative_regions(self, bundle: ModelBundle, all_images,
                                   candidate_regions, region_size):
        """max_subset.py:115-128: ({path: [region, ...]}, count)."""
        cand_images, cand_regions = self._convert_regions_to_list(
            candidate_regions)
        all_feats = self._get_features_for_image_regions(bundle, all_images,
                                                         region_size)
        region_feats = self._get_features_for_regions(bundle, cand_images,
                                                      cand_regions)
        picked = self._max_representative_samples(all_feats, region_feats,
                                                  len(region_feats) // 2)
        selected = {}
        for i in picked:
            selected.setdefault(cand_images[i], []).append(cand_regions[i])
        return selected, len(picked)
