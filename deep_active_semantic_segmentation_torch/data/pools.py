"""Active-learning pool bookkeeping, image and region level (own copy of
the JAX package's data/pools.py:33-302).

Parity targets:
* image-level AL pool — reference active_cityscapes.py:19-95 /
  active_pascal.py (seed-set load, current vs remaining paths, weak labels
  served past the labeled range, pixel accounting);
* region-level AL pool — region_cityscapes.py:14-95 / region_pascal.py
  (OrderedDict path -> [(r, c, h, w)], masked targets via the inverse crop
  mapping, labeled-pixel accumulation);
* pad-to-batch-multiple / reset — cityscapes_base.py:103-119.

Dataset-family differences are captured in ``DatasetSpec``. The uint8
wire is always on: the host does geometry only and the steps normalize on
the device. The train transforms' flips and blurs draw from the
``random.Random`` the pool is given. The passive pool comes with
``train.py`` (ROADMAP A14).
"""

from __future__ import annotations

import os
import random
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from deep_active_semantic_segmentation_torch.constants import IGNORE_INDEX
from deep_active_semantic_segmentation_torch.data import transforms as tr
from deep_active_semantic_segmentation_torch.data.store import CachingStore


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_classes: int
    # crop_size == -1 behaviour differs: cityscapes scales the short side
    # (cityscapes_base.py:26-29), pascal letterboxes (pascal_base.py:26-29).
    letterbox_when_uncropped: bool
    # labeled-pixel fraction denominator: crop^2 for cityscapes
    # (cityscapes_base.py:121-125), base^2 for pascal (pascal_base.py:105-109).
    fraction_uses_base_size: bool
    # region target geometry: crop-space inverse for cityscapes
    # (region_cityscapes.py:81-84), letterbox-space for pascal
    # (region_pascal.py:91).
    region_invert_uses_base_size: bool


CITYSCAPES = DatasetSpec("cityscapes", 19, False, False, False)
PASCAL = DatasetSpec("pascal", 21, True, True, True)


def _scalecrop_for(spec: DatasetSpec, base_size: int, crop_size: int):
    if crop_size == -1:
        if spec.letterbox_when_uncropped:
            return tr.ScaleWithPadding(base_size=base_size)
        return tr.Scale(base_size=base_size)
    return tr.FixScaleCrop(crop_size=crop_size)


class BasePool:
    """Shared store access + transform pipelines (cityscapes_base.py:12-88)."""

    def __init__(self, spec: DatasetSpec, store, base_size: int, crop_size: int,
                 split: str, overfit: bool = False, memory_hog: bool = False,
                 rng: Optional[random.Random] = None):
        self.spec = spec
        self.NUM_CLASSES = spec.num_classes
        self.store = CachingStore(store) if memory_hog else store
        self.memory_hog = memory_hog
        self.split = split
        self.base_size = base_size
        self.crop_size = crop_size
        self.overfit = overfit
        self.image_paths: List[bytes] = list(store.keys())
        if overfit:
            self.image_paths = self.image_paths[:1]
        if not self.image_paths:
            raise Exception("No images found in dataset directory")
        rng = rng if rng is not None else random.Random(0)
        self.scalecrop = _scalecrop_for(spec, base_size, crop_size)
        self._train_tf = tr.Compose([self.scalecrop,
                                     tr.RandomHorizontalFlip(rng),
                                     tr.RandomGaussianBlur(rng),
                                     tr.ToUint8Wire()])
        self._eval_tf = tr.Compose([self.scalecrop, tr.ToUint8Wire()])
        self._pixel_side = (base_size if spec.fraction_uses_base_size
                            else crop_size)

    def load_record(self, path: bytes) -> np.ndarray:
        return np.asarray(self.store.get(path))

    def transform(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.overfit or self.split != "train":
            return self._eval_tf(sample)
        return self._train_tf(sample)

    @staticmethod
    def _pad_to_multiple(paths: List, batch_size: int) -> List:
        remainder = len(paths) % batch_size
        if remainder != 0:
            paths = paths + paths[: batch_size - remainder]
        return paths

    # The labeled-pool bookkeeping below is shared by both AL pools: a
    # subclass sets ``current_image_paths`` and ``labeled_pixel_count``.

    def make_dataset_multiple_of_batchsize(self, batch_size: int):
        self._original_size_current = len(self.current_image_paths)
        self.current_image_paths = self._pad_to_multiple(
            self.current_image_paths, batch_size)

    def reset_dataset(self):
        self.current_image_paths = self.current_image_paths[: self._original_size_current]

    def get_fraction_of_labeled_data(self) -> float:
        s = self._pixel_side
        return self.labeled_pixel_count / (len(self.image_paths) * s * s)

    def get_next_est_fraction_of_labeled_data(self, active_batch_size: int) -> float:
        s = self._pixel_side
        return ((self.labeled_pixel_count + active_batch_size * s * s)
                / (len(self.image_paths) * s * s))


class ActiveImagePool(BasePool):
    """Image-level AL pool (active_cityscapes.py:19-95)."""

    def __init__(self, spec, store, base_size, crop_size, split,
                 init_set: Optional[str] = None, seed_dir: Optional[str] = None,
                 overfit: bool = False, memory_hog: bool = False,
                 rng: Optional[random.Random] = None):
        super().__init__(spec, store, base_size, crop_size, split, overfit,
                         memory_hog, rng)
        self.current_image_paths: List[bytes] = list(self.image_paths)
        self.remaining_image_paths: List[bytes] = []
        self.weakly_labeled_image_paths: List[bytes] = []
        self.weakly_labeled_targets: Dict[bytes, np.ndarray] = {}
        if split == "train" and init_set is not None:
            seed_path = os.path.join(seed_dir or "", init_set)
            with open(seed_path, "r") as f:
                self.current_image_paths = [
                    x.strip().encode("ascii") for x in f.readlines() if x.strip()]
            current = set(self.current_image_paths)
            self.remaining_image_paths = [
                x for x in self.image_paths if x not in current]
        side = self._pixel_side
        self.labeled_pixel_count = len(self.current_image_paths) * side * side
        if self.memory_hog:
            self.store.preload(self.current_image_paths)
        self._original_size_current = len(self.current_image_paths)
        self._original_size_weak = 0

    def __len__(self):
        return len(self.current_image_paths) + len(self.weakly_labeled_image_paths)

    def get_item(self, index: int) -> Dict[str, np.ndarray]:
        n_labeled = len(self.current_image_paths)
        if index < n_labeled:
            rec = self.load_record(self.current_image_paths[index])
            return self.transform({"image": rec[:, :, 0:3], "label": rec[:, :, 3]})
        # weak samples: the eval transform and the stored pseudo-label
        # (active_cityscapes.py:68-72)
        path = self.weakly_labeled_image_paths[index - n_labeled]
        rec = self.load_record(path)
        out = self._eval_tf({"image": rec[:, :, 0:3], "label": rec[:, :, 3]})
        return {"image": out["image"],
                "label": self.weakly_labeled_targets[path].astype(np.uint8)}

    def expand_training_set(self, paths: Sequence[bytes]):
        self.current_image_paths.extend(paths)
        for x in paths:
            self.remaining_image_paths.remove(x)
        if self.memory_hog:
            self.store.preload(self.current_image_paths)
        self.labeled_pixel_count = (
            len(self.current_image_paths) * self._pixel_side * self._pixel_side)

    def add_weak_labels(self, predictions_dict: Dict[bytes, np.ndarray]):
        self.weakly_labeled_image_paths = list(predictions_dict.keys())
        self.weakly_labeled_targets = predictions_dict

    def clear_weak_labels(self):
        self.weakly_labeled_targets = {}
        self.weakly_labeled_image_paths = []

    def make_dataset_multiple_of_batchsize(self, batch_size: int):
        super().make_dataset_multiple_of_batchsize(batch_size)
        self._original_size_weak = len(self.weakly_labeled_image_paths)
        self.weakly_labeled_image_paths = self._pad_to_multiple(
            self.weakly_labeled_image_paths, batch_size)

    def reset_dataset(self):
        super().reset_dataset()
        self.weakly_labeled_image_paths = self.weakly_labeled_image_paths[
            : self._original_size_weak]


class ActiveRegionPool(BasePool):
    """Region-level AL pool (region_cityscapes.py:14-95)."""

    def __init__(self, spec, store, base_size, crop_size, split,
                 init_set: Optional[str] = None, seed_dir: Optional[str] = None,
                 overfit: bool = False, memory_hog: bool = False,
                 rng: Optional[random.Random] = None):
        super().__init__(spec, store, base_size, crop_size, split, overfit,
                         memory_hog, rng)
        self.current_paths_to_regions_map: "OrderedDict[bytes, List]" = OrderedDict()
        full_side = base_size if spec.region_invert_uses_base_size else crop_size
        if split == "train" and init_set is not None:
            with open(os.path.join(seed_dir or "", init_set), "r") as f:
                for line in f.readlines():
                    if line.strip():
                        self.current_paths_to_regions_map[
                            line.strip().encode("ascii")] = [
                                (0, 0, full_side, full_side)]
        else:
            for path in self.image_paths:
                self.current_paths_to_regions_map[path] = [
                    (0, 0, full_side, full_side)]
        self.current_image_paths = list(self.current_paths_to_regions_map.keys())
        if self.memory_hog:
            self.store.preload(self.current_image_paths)
        side = self._pixel_side
        self.labeled_pixel_count = side * side * len(self.current_image_paths)
        self._original_size_current = len(self.current_image_paths)

    def __len__(self):
        return len(self.current_image_paths)

    def get_item(self, index: int) -> Dict[str, np.ndarray]:
        """The labeled boxes' ground truth copied into a 255-filled
        full-resolution target, then the pool's transform."""
        path = self.current_image_paths[index]
        rec = self.load_record(path)
        target_full = rec[:, :, 3]
        target_masked = np.full(target_full.shape, IGNORE_INDEX, target_full.dtype)
        for r in self.current_paths_to_regions_map[path]:
            if self.spec.region_invert_uses_base_size:
                tr.invert_scale_crop(target_full, target_masked, r, self.base_size)
            else:
                tr.invert_fix_scale_crop(target_full, target_masked, r,
                                         self.crop_size)
        return self.transform({"image": rec[:, :, 0:3], "label": target_masked})

    def expand_training_set(self, new_regions: Dict[bytes, List],
                            labeled_pixels: int):
        for path, regions in new_regions.items():
            if path in self.current_paths_to_regions_map:
                self.current_paths_to_regions_map[path].extend(regions)
            else:
                self.current_paths_to_regions_map[path] = list(regions)
        self.labeled_pixel_count += labeled_pixels
        self.current_image_paths = list(self.current_paths_to_regions_map.keys())
        if self.memory_hog:
            self.store.preload(self.current_image_paths)

    def get_existing_region_maps(self) -> List[List]:
        return [self.current_paths_to_regions_map.get(path, [])
                for path in self.image_paths]
