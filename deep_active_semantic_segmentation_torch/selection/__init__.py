"""Active-selection engine: batched on-device pool sweeps (parity: the JAX
package's selection/__init__.py factory surface): every selection mode of
``active_train.py`` on the port's selectors."""

from deep_active_semantic_segmentation_torch.selection.accuracy import (
    ActiveSelectionAccuracy)
from deep_active_semantic_segmentation_torch.selection.base import ModelBundle
from deep_active_semantic_segmentation_torch.selection.ceal import (
    ActiveSelectionCEAL)
from deep_active_semantic_segmentation_torch.selection.core_set import (
    ActiveSelectionCoreSet)
from deep_active_semantic_segmentation_torch.selection.max_subset import (
    ActiveSelectionMaxSubset)
from deep_active_semantic_segmentation_torch.selection.mc_dropout import (
    ActiveSelectionMCDropout)
from deep_active_semantic_segmentation_torch.selection.mc_noise import (
    ActiveSelectionMCNoise)

__all__ = ["ModelBundle", "ActiveSelectionAccuracy", "ActiveSelectionCEAL",
           "ActiveSelectionCoreSet", "ActiveSelectionMaxSubset",
           "ActiveSelectionMCDropout", "ActiveSelectionMCNoise",
           "get_active_selection_class", "get_max_subset_active_selector"]


def get_active_selection_class(active_selection_method, dataset_num_classes,
                               store, crop_size, dataloader_batch_size,
                               device=None, mc_dtype=None, mesh=None):
    """reference active_selection/__init__.py:9-21 (store replaces the lmdb
    env). ``device``: where pool batches are scored (the CUDA card by
    default); ``mc_dtype``: the MC forwards' compute dtype; ``mesh``: the
    ranks the pool is sharded over (``selection/base.py``)."""
    m = active_selection_method
    if m == "coreset":
        return ActiveSelectionCoreSet(store, crop_size, dataloader_batch_size,
                                      device=device, mesh=mesh)
    if m in ("ceal_confidence", "ceal_margin", "ceal_entropy", "ceal_fusion",
             "ceal_entropy_weakly_labeled"):
        return ActiveSelectionCEAL(dataset_num_classes, store, crop_size,
                                   dataloader_batch_size, device=device, mesh=mesh)
    if m in ("noise_image", "noise_feature", "noise_variance"):
        return ActiveSelectionMCNoise(dataset_num_classes, store, crop_size,
                                      dataloader_batch_size, device=device,
                                      mc_dtype=mc_dtype, mesh=mesh)
    if m in ("variance", "variance_representative", "random"):
        return ActiveSelectionMCDropout(dataset_num_classes, store, crop_size,
                                        dataloader_batch_size, device=device,
                                        mc_dtype=mc_dtype, mesh=mesh)
    if m in ("accuracy_labels", "accuracy_eval"):
        return ActiveSelectionAccuracy(dataset_num_classes, store, crop_size,
                                       dataloader_batch_size, device=device, mesh=mesh)
    raise NotImplementedError(m)


def get_max_subset_active_selector(store, crop_size, dataloader_batch_size,
                                   device=None, mesh=None):
    """reference active_selection/__init__.py:23-25."""
    return ActiveSelectionMaxSubset(store, crop_size, dataloader_batch_size,
                                    device=device, mesh=mesh)
