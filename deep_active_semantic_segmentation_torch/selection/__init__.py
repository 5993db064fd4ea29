"""Active-selection engine: batched on-device pool sweeps (parity: the JAX
package's selection/__init__.py factory surface). Ported: the MC-dropout
modes (image and region level) and the CEAL modes; every other mode
raises, naming the ROADMAP item that ports it."""

from deep_active_semantic_segmentation_torch.selection.base import ModelBundle
from deep_active_semantic_segmentation_torch.selection.ceal import (
    ActiveSelectionCEAL)
from deep_active_semantic_segmentation_torch.selection.mc_dropout import (
    ActiveSelectionMCDropout)

__all__ = ["ModelBundle", "ActiveSelectionCEAL", "ActiveSelectionMCDropout",
           "get_active_selection_class"]

_NOT_PORTED = {
    "coreset": "A10",
    "noise_image": "A11", "noise_feature": "A11", "noise_variance": "A11",
    "accuracy_labels": "A13", "accuracy_eval": "A13",
}


def get_active_selection_class(active_selection_method, dataset_num_classes,
                               store, crop_size, dataloader_batch_size,
                               device=None, mc_dtype=None):
    """reference active_selection/__init__.py:9-21 (store replaces the lmdb
    env). ``device``: where pool batches are scored (the CUDA card by
    default); ``mc_dtype``: the MC forwards' compute dtype."""
    m = active_selection_method
    if m in ("ceal_confidence", "ceal_margin", "ceal_entropy", "ceal_fusion",
             "ceal_entropy_weakly_labeled"):
        return ActiveSelectionCEAL(dataset_num_classes, store, crop_size,
                                   dataloader_batch_size, device=device)
    if m in ("variance", "variance_representative", "random"):
        return ActiveSelectionMCDropout(dataset_num_classes, store, crop_size,
                                        dataloader_batch_size, device=device,
                                        mc_dtype=mc_dtype)
    if m in _NOT_PORTED:
        raise NotImplementedError(f"selection mode '{m}' is not ported yet "
                                  f"(ROADMAP {_NOT_PORTED[m]})")
    raise NotImplementedError(m)
