"""Active-learning pool bookkeeping (own copy of the JAX package's
data/pools.py:33-222, image level).

Parity targets: the image-level AL pool of reference active_cityscapes.py
:19-95 / active_pascal.py (seed-set load, current vs remaining paths,
pixel accounting) and
pad-to-batch-multiple / reset (cityscapes_base.py:103-119). Dataset-family
differences are captured in ``DatasetSpec``.

The uint8 wire is always on: the host does geometry only and the steps
normalize on the device. The train transforms' flips and blurs draw from
the ``random.Random`` the pool is given. The passive pool comes with
``train.py`` (ROADMAP A14), the region pool with region mode (A8), the
weak labels served past the labeled range with the CEAL modes (A9).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

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
        if split == "train" and init_set is not None:
            seed_path = os.path.join(seed_dir or "", init_set)
            with open(seed_path, "r") as f:
                self.current_image_paths = [
                    x.strip().encode("ascii") for x in f.readlines() if x.strip()]
            current = set(self.current_image_paths)
            self.remaining_image_paths = [
                x for x in self.image_paths if x not in current]
        side = self.base_size if spec.fraction_uses_base_size else self.crop_size
        self._pixel_side = side
        self.labeled_pixel_count = len(self.current_image_paths) * side * side
        if self.memory_hog:
            self.store.preload(self.current_image_paths)
        self._original_size_current = len(self.current_image_paths)

    def __len__(self):
        return len(self.current_image_paths)

    def get_item(self, index: int) -> Dict[str, np.ndarray]:
        rec = self.load_record(self.current_image_paths[index])
        return self.transform({"image": rec[:, :, 0:3], "label": rec[:, :, 3]})

    def expand_training_set(self, paths: Sequence[bytes]):
        self.current_image_paths.extend(paths)
        for x in paths:
            self.remaining_image_paths.remove(x)
        if self.memory_hog:
            self.store.preload(self.current_image_paths)
        self.labeled_pixel_count = (
            len(self.current_image_paths) * self._pixel_side * self._pixel_side)

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


class ActiveRegionPool:
    """Region-level AL pool: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("region-level pools are not ported yet "
                                  "(ROADMAP A8)")
