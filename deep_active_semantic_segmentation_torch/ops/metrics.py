"""Segmentation metrics (parity: the JAX package's ops/metrics.py, itself
the reference utils/metrics.py:6-49).

The confusion matrix is one ``torch.bincount`` per batch on the device,
accumulated there in int64 and fetched to the host once, when a metric is
read at the end of the epoch.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(gt: torch.Tensor, pred: torch.Tensor,
                     num_class: int) -> torch.Tensor:
    """(num_class, num_class) int64 counts, rows ground truth, columns
    prediction (reference metrics.py:37-42). Pixels whose ground truth lies
    outside [0, num_class) are ignored: they go to one extra bin that is
    dropped."""
    gt = gt.long()
    valid = (gt >= 0) & (gt < num_class)
    idx = torch.where(valid, num_class * gt + pred.long(), num_class * num_class)
    counts = torch.bincount(idx.flatten(), minlength=num_class * num_class + 1)
    return counts[:num_class * num_class].reshape(num_class, num_class)


class Evaluator:
    """Streaming evaluator with the reference's metric definitions; the
    matrix lives on ``device`` and is fetched to the host once after the
    last batch added, however many metrics are read."""

    def __init__(self, num_class: int, device="cpu"):
        self.num_class = num_class
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self._mat = torch.zeros((self.num_class, self.num_class),
                                dtype=torch.int64, device=self.device)
        self._host = None

    def add_batch(self, gt_image, pre_image):
        assert gt_image.shape == pre_image.shape
        self.add_matrix(confusion_matrix(torch.as_tensor(gt_image),
                                         torch.as_tensor(pre_image),
                                         self.num_class))

    def add_matrix(self, mat):
        self._mat += torch.as_tensor(mat).to(self.device, torch.int64)
        self._host = None

    @property
    def confusion(self) -> np.ndarray:
        if self._host is None:
            self._host = self._mat.cpu().numpy().astype(np.float64)
        return self._host

    # Metric definitions follow reference metrics.py:13-35 exactly
    # (nan-mean over classes, frequency weighting over present classes).
    def Pixel_Accuracy(self) -> float:
        m = self.confusion
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.diag(m).sum() / m.sum())

    def Pixel_Accuracy_Class(self) -> float:
        m = self.confusion
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.divide(np.diag(m), m.sum(axis=1))
        return float(np.nanmean(acc))

    def Mean_Intersection_over_Union(self) -> float:
        m = self.confusion
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.divide(np.diag(m), m.sum(axis=1) + m.sum(axis=0) - np.diag(m))
        return float(np.nanmean(iou))

    def Frequency_Weighted_Intersection_over_Union(self) -> float:
        m = self.confusion
        with np.errstate(divide="ignore", invalid="ignore"):
            freq = m.sum(axis=1) / m.sum()
            iou = np.divide(np.diag(m), m.sum(axis=1) + m.sum(axis=0) - np.diag(m))
        return float((freq[freq > 0] * iou[freq > 0]).sum())
