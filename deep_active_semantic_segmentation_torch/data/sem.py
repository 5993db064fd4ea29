"""SEM electron-microscopy binary-segmentation dataset (own copy of the JAX
package's data/sem.py:22-54; parity: reference dataloaders/dataset/sem.py
:13-67).

Grayscale PNG folders ``sem/<split>/{images,masks}``, FixScaleCrop and,
for the train split, the random flip and blur, drawn from the explicit
``random.Random`` ``rng`` in the JAX package's order (it draws from the
module-level ``random``).

Samples travel on the port's uint8 wire, not the JAX package's f32 one:
the image stays the geometry stages' uint8 (H, W, 1) plane, normalized on
the device with SEM's mean and std (``MEAN``, ``STD``; pass them as the
steps' ``norm``) in the host Normalize's f32 arithmetic, so the network
input equals the JAX package's. The label is the class the JAX package's
float mask truncates to in its loss and confusion matrix: 1 where the
resized mask is 255, else 0; a Loader's padded rows carry 255, ignored.
(A mask pixel strictly between 0 and 255 is class 0 in both packages;
only the JAX trainer's float pixel-accuracy comparison counts it wrong
whatever the prediction.)
"""

from __future__ import annotations

import glob
import os
import random
from typing import Dict, Optional

import numpy as np
from PIL import Image

from deep_active_semantic_segmentation_torch import constants
from deep_active_semantic_segmentation_torch.data import transforms as tr

MEAN = (0.4911,)
STD = (0.1658,)


class SEMData:
    NUM_CLASSES = 2

    def __init__(self, crop_size: int, split: str, dataset_root=None,
                 rng: Optional[random.Random] = None):
        root = dataset_root or constants.DATASET_ROOT
        self.mask_paths = sorted(glob.glob(os.path.join(root, f"sem/{split}/masks/*")))
        self.image_paths = sorted(glob.glob(os.path.join(root, f"sem/{split}/images/*")))
        self.split = split
        self.crop_size = crop_size
        rng = rng if rng is not None else random.Random(0)
        self._scalecrop = tr.FixScaleCrop(crop_size=crop_size)
        self._flip = tr.RandomHorizontalFlip(rng)
        self._blur = tr.RandomGaussianBlur(rng)

    def __len__(self):
        return len(self.image_paths)

    def skip_item(self, index: int):
        """The host stream's draws that ``get_item(index)`` would take
        (the train split's flip, then blur), taken without reading the
        files (a data-parallel rank passing over another rank's rows);
        ``get_item(index, draws)`` replays them. None on other splits."""
        if self.split != "train":
            return None
        return self._flip.draw(), self._blur.draw()

    def get_item(self, index: int, draws=None) -> Dict[str, np.ndarray]:
        """{'image': (crop, crop, 1) uint8, 'label': (crop, crop) uint8 in
        {0, 1}}; ``draws`` as in ``skip_item``."""
        image = np.array(Image.open(self.image_paths[index]))
        mask = np.array(Image.open(self.mask_paths[index])) / 255.0
        # the JAX package's round trip of the mask through float
        sample = {"image": image, "label": (mask * 255).astype(np.uint8)}
        sample = self._scalecrop(sample)
        if self.split == "train":
            flip, blur = draws or (None, None)
            sample = self._blur(self._flip(sample, flip), blur)
        image = np.asarray(sample["image"], np.uint8)
        label = (np.asarray(sample["label"]) == 255).astype(np.uint8)
        return {"image": image[..., None] if image.ndim == 2 else image,
                "label": label}
