"""Segmentation colormaps (own copy of the JAX package's data/colormaps.py;
parity: reference dataloaders/utils.py:5-98)."""

from __future__ import annotations

import numpy as np


def create_cityscapes_label_colormap():
    return {
        0: [128, 64, 128], 1: [244, 35, 232], 2: [70, 70, 70],
        3: [102, 102, 156], 4: [190, 153, 153], 5: [153, 153, 153],
        6: [250, 170, 30], 7: [220, 220, 0], 8: [107, 142, 35],
        9: [152, 251, 152], 10: [70, 130, 180], 11: [220, 20, 60],
        12: [255, 0, 0], 13: [0, 0, 142], 14: [0, 0, 70],
        15: [0, 60, 100], 16: [0, 80, 100], 17: [0, 0, 230],
        18: [119, 11, 32], 255: [255, 255, 255],
    }


def create_binary_colormap():
    return {0: [255, 20, 0], 1: [0, 0, 127], 255: [255, 255, 255]}


def create_pascal_label_colormap():
    """Bit-twiddled VOC colormap (reference dataloaders/utils.py:40-58)."""

    def bit_get(val, idx):
        return (val >> idx) & 1

    colormap = np.zeros((256, 3), dtype=int)
    ind = np.arange(256, dtype=int)
    for shift in reversed(range(8)):
        for channel in range(3):
            colormap[:, channel] |= bit_get(ind, channel) << shift
        ind >>= 3
    return {i: colormap[i, :].tolist() for i in range(256)}


def get_colormap(dataset: str):
    if "cityscapes" in dataset:
        return create_cityscapes_label_colormap()
    if dataset == "binary":
        return create_binary_colormap()
    if "pascal" in dataset:
        return create_pascal_label_colormap()
    raise Exception("No colormap for dataset found")


def map_segmentation_to_colors(segmentation: np.ndarray, dataset: str) -> np.ndarray:
    colormap = get_colormap(dataset)
    colored = np.zeros((*segmentation.shape, 3))
    for label in np.unique(segmentation).tolist():
        colored[segmentation == label, :] = colormap[label]
    return colored / 255.0


def map_segmentations_to_colors(segmentations, dataset: str) -> np.ndarray:
    return np.stack([map_segmentation_to_colors(s, dataset)
                     for s in segmentations])
