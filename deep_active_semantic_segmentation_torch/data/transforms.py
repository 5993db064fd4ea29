"""Sample transforms with reference-exact numerics (own copy of the parts
of the JAX package's data/transforms.py that pool scoring and training
run).

Samples are ``{'image': HxWxC, 'label': HxW}`` numpy arrays. The random
train transforms draw from an explicit ``random.Random`` that the pool
passes in, the same draws in the same order as the JAX package's calls
of the module-level ``random``: one seed gives one stream. Resizing
reproduces the deprecated ``scipy.misc.imresize`` the reference depends
on: uint8 arrays routed through PIL with the requested resample mode, the
code path old scipy used, so results are bit-identical for uint8 inputs.
The JAX package's native C++ resampler (bit-identical to PIL) is a later
item of the port (ROADMAP); here PIL does every resize.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np
from PIL import Image
from scipy.ndimage import gaussian_filter

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imresize(arr: np.ndarray, size: Tuple[int, int], interp: str = "bilinear") -> np.ndarray:
    """scipy.misc.imresize replica for uint8 inputs: PIL resize.

    size is (height, width), matching the scipy/reference convention.
    """
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        # old scipy bytescaled non-uint8 input; the reference only ever
        # resizes uint8 data, so clip-cast is sufficient here.
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    oh, ow = int(size[0]), int(size[1])
    resample = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
                "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}[interp]
    return np.array(Image.fromarray(arr).resize((ow, oh), resample))


def _short_side_dims(w: int, h: int, target: int) -> Tuple[int, int]:
    """(oh, ow) scaling the short side to ``target`` (FixScaleCrop rule)."""
    if w > h:
        oh = target
        ow = int(1.0 * w * oh / h)
    else:
        ow = target
        oh = int(1.0 * h * ow / w)
    return oh, ow


def _center_crop_origin(oh: int, ow: int, crop: int) -> Tuple[int, int]:
    return int(round((ow - crop) / 2.0)), int(round((oh - crop) / 2.0))


class ToUint8Wire:
    """Terminal stage of the uint8 train/eval wire: the geometry stages'
    uint8 image (cast back exactly where a stage produced an integer-valued
    f32 buffer, ScaleWithPadding's letterbox) and uint8 label. The
    /255-mean/std normalize runs on the device
    (``parallel/steps.ingest``)."""

    def __call__(self, sample):
        return {"image": np.asarray(sample["image"]).astype(np.uint8),
                "label": np.asarray(sample["label"]).astype(np.uint8)}


class RandomHorizontalFlip:
    """Reference custom_transforms.py:57-69; one draw from ``rng``."""

    def __init__(self, rng: random.Random):
        self.rng = rng

    def __call__(self, sample):
        img, mask = sample["image"], sample["label"]
        if self.rng.random() < 0.5:
            img = np.fliplr(img)
            mask = np.fliplr(mask)
        return {"image": img, "label": mask}


class RandomGaussianBlur:
    """Reference custom_transforms.py:88-97: with p=0.5 (one draw), blur
    the uint8 image across ALL axes, channels included, with sigma ~
    U(0,1) (a second draw)."""

    def __init__(self, rng: random.Random):
        self.rng = rng

    def __call__(self, sample):
        img, mask = sample["image"], sample["label"]
        if self.rng.random() < 0.5:
            img = gaussian_filter(img, sigma=self.rng.random())
        return {"image": img, "label": mask}


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class FixScaleCrop:
    """Reference custom_transforms.py:138-166: short side -> crop_size,
    center crop."""

    def __init__(self, crop_size):
        self.crop_size = crop_size

    def __call__(self, sample):
        img = np.asarray(sample["image"])
        mask = np.asarray(sample["label"])
        h, w = img.shape[0], img.shape[1]
        oh, ow = _short_side_dims(w, h, self.crop_size)
        x1, y1 = _center_crop_origin(oh, ow, self.crop_size)
        cs = self.crop_size
        img = imresize(img, (oh, ow))[y1:y1 + cs, x1:x1 + cs]
        mask = imresize(mask, (oh, ow), "nearest")[y1:y1 + cs, x1:x1 + cs]
        return {"image": img, "label": mask}


class Scale:
    """Reference custom_transforms.py:169-190: short side -> base_size, no
    crop."""

    def __init__(self, base_size):
        self.base_size = base_size

    def __call__(self, sample):
        img = np.asarray(sample["image"])
        mask = np.asarray(sample["label"])
        oh, ow = _short_side_dims(img.shape[1], img.shape[0], self.base_size)
        return {"image": imresize(img, (oh, ow)),
                "label": imresize(mask, (oh, ow), "nearest")}


class FixScaleCropImageOnly:
    """Reference custom_transforms.py:277-297."""

    def __init__(self, crop_size):
        self.crop_size = crop_size

    def __call__(self, img):
        img = np.asarray(img)
        h, w = img.shape[0], img.shape[1]
        oh, ow = _short_side_dims(w, h, self.crop_size)
        x1, y1 = _center_crop_origin(oh, ow, self.crop_size)
        cs = self.crop_size
        return imresize(img, (oh, ow))[y1:y1 + cs, x1:x1 + cs]


def _letterbox_dims(w: int, h: int, base_size: int) -> Tuple[int, int]:
    """ScaleWithPadding size rule (custom_transforms.py:227-236): long side
    -> base_size, short side even-rounded up."""
    if w < h:
        oh = base_size
        ow = int(1.0 * w * oh / h)
        if ow % 2 != 0:
            ow += 1
    else:
        ow = base_size
        oh = int(1.0 * h * ow / w)
        if oh % 2 != 0:
            oh += 1
    return oh, ow


class ScaleWithPadding:
    """Reference custom_transforms.py:214-245: letterbox into base_size^2;
    mask pad=255. The scaled content sits at the reference's integer-half
    offsets. The image plane is f32 holding integer values, as in the
    reference; the uint8 wire casts it back exactly."""

    def __init__(self, base_size):
        self.base_size = base_size

    def __call__(self, sample):
        img = np.asarray(sample["image"])
        mask = np.asarray(sample["label"])
        h, w = img.shape[0], img.shape[1]
        out_image = np.zeros((self.base_size, self.base_size, 3), np.float32)
        out_mask = np.full((self.base_size, self.base_size), 255, np.uint8)
        oh, ow = _letterbox_dims(w, h, self.base_size)
        b = self.base_size
        rows = slice(b // 2 - oh // 2, b // 2 + oh // 2)
        cols = slice(b // 2 - ow // 2, b // 2 + ow // 2)
        out_image[rows, cols] = imresize(img, (oh, ow))
        out_mask[rows, cols] = imresize(mask, (oh, ow), "nearest")
        return {"image": out_image, "label": out_mask}


class ScaleWithPaddingImageOnly:
    """Reference custom_transforms.py:248-274."""

    def __init__(self, base_size):
        self.base_size = base_size

    def __call__(self, img):
        img = np.asarray(img)
        h, w = img.shape[0], img.shape[1]
        out_image = np.zeros((self.base_size, self.base_size, 3), np.float32)
        oh, ow = _letterbox_dims(w, h, self.base_size)
        b = self.base_size
        out_image[b // 2 - oh // 2: b // 2 + oh // 2,
                  b // 2 - ow // 2: b // 2 + ow // 2] = imresize(img, (oh, ow))
        return out_image


def invert_fix_scale_crop(label: np.ndarray, output: np.ndarray,
                          region, crop_size: int) -> None:
    """Reference custom_transforms.py:300-315: project a crop-space (r, c,
    h, w) box back to full-resolution label space and copy the ground
    truth there into ``output``."""
    h, w = label.shape
    oh, ow = _short_side_dims(w, h, crop_size)
    x1, y1 = _center_crop_origin(oh, ow, crop_size)
    b0 = round((region[0] + y1) * (h / oh))
    b1 = round((region[1] + x1) * (w / ow))
    b2 = round(region[2] * (h / oh))
    b3 = round(region[3] * (w / ow))
    output[b0: b0 + b2, b1: b1 + b3] = label[b0: b0 + b2, b1: b1 + b3]


def invert_scale_crop(label: np.ndarray, output: np.ndarray,
                      region, base_size: int) -> None:
    """Reference custom_transforms.py:318-342: letterbox-space box ->
    full-resolution copy."""
    h, w = label.shape
    oh, ow = _letterbox_dims(w, h, base_size)
    padding_h = abs(base_size - oh) // 2
    padding_w = abs(base_size - ow) // 2
    b0 = round(max(region[0] - padding_h, 0) * (h / oh))
    b1 = round(max(region[1] - padding_w, 0) * (w / ow))
    b2 = round(region[2] * (h / oh))
    b3 = round(region[3] * (w / ow))
    output[b0: b0 + b2, b1: b1 + b3] = label[b0: b0 + b2, b1: b1 + b3]
