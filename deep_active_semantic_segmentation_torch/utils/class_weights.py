"""Balanced class weights (own copy of the JAX package's
utils/class_weights.py; parity: reference utils/calculate_weights.py:7-30).

Same formula including its quirks: log of raw counts first, weights
1/log(1.02 + log-count share), nan_to_num at the end.
"""

from __future__ import annotations

import numpy as np
import torch


def calculate_weights_labels(dataloader, num_classes: int,
                             mesh=None) -> np.ndarray:
    """``mesh``: ``dataloader`` yields this rank's rows, and the class
    counts are summed over the ranks (exactly: integer counts in f64)."""
    z = np.zeros((num_classes,))
    for batch in dataloader:
        y = np.asarray(batch["label"])
        mask = np.logical_and(y >= 0, y < num_classes)
        labels = y[mask].astype(np.uint8)
        z += np.bincount(labels, minlength=num_classes)
    if mesh is not None and mesh.distributed:
        z = mesh.all_reduce(torch.from_numpy(z)).numpy()
    z = np.log(z)
    total_frequency = np.sum(z)
    class_weights = [1 / (np.log(1.02 + (freq / total_frequency)))
                     for freq in z]
    return np.nan_to_num(np.array(class_weights))
