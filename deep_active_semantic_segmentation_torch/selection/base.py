"""Selector base + the model handle selectors score with (parity: the JAX
package's selection/base.py).

``ModelBundle`` holds the ``nn.Module`` and the device it lives on. The
selector owns the pool-scoring loader: host geometry in ordered prefetch
workers, then a pinned-memory, non-blocking copy of the uint8 wire to the
card. ``ActiveSelectionMC`` is the MC selectors' shared per-batch
vote-entropy scorer, ranking and region maps.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from deep_active_semantic_segmentation_torch import constants, resolve_device
from deep_active_semantic_segmentation_torch.data.loader import (
    PathsLoader, prefetch_to_device, to_device)
from deep_active_semantic_segmentation_torch.ops import entropy as ent_ops
from deep_active_semantic_segmentation_torch.selection import kernels
from deep_active_semantic_segmentation_torch.selection.region_pipeline import (
    create_region_maps_from_scorer)

# Compute dtype for the MC vote-entropy forwards. Votes are per-pixel
# argmaxes, robust to bf16 rounding next to the MC sampling noise itself.
# 'auto' resolves to float32: the JAX package picks bfloat16 only on a TPU.
MC_SCORING_DTYPE = os.environ.get("DASS_MC_SCORING_DTYPE", "auto")


def mc_scoring_dtype() -> str:
    """Resolve MC_SCORING_DTYPE ('auto' -> 'float32' off the TPU)."""
    return "float32" if MC_SCORING_DTYPE == "auto" else MC_SCORING_DTYPE


@dataclass
class ModelBundle:
    model: torch.nn.Module
    device: torch.device


class ActiveSelectionBase:
    def __init__(self, dataset_store, crop_size, dataloader_batch_size,
                 device=None, mc_dtype=None):
        self.store = dataset_store
        self.crop_size = crop_size
        self.dataloader_batch_size = dataloader_batch_size
        self.device = resolve_device(device)
        self._mc_dtype = mc_dtype

    def mc_dtype(self) -> str:
        """Compute dtype for this selector's MC vote-entropy forwards."""
        return self._mc_dtype or mc_scoring_dtype()

    def _check_bundle(self, bundle: ModelBundle) -> None:
        if torch.device(bundle.device) != self.device:
            raise ValueError(f"model lives on {bundle.device}, selector "
                             f"scores on {self.device}")

    def _paths_loader(self, images, include_labels=True,
                      labels_as_mask=None):
        loader = PathsLoader(self.store, images, self.crop_size,
                             self.dataloader_batch_size,
                             include_labels=include_labels,
                             labels_as_mask=labels_as_mask)
        device = self.device

        def build_and_put(chunk):
            out = loader.build_batch(chunk)
            for k in ("image", "label"):
                if k in out:
                    out[k] = to_device(out[k], device)
            return out

        # ordered multi-worker prefetch: workers run the store reads and
        # host geometry (PIL releases the GIL) and start the copies ahead
        # of the consumer; batches arrive in order
        workers = int(os.environ.get("DASS_PREFETCH_WORKERS", "3"))
        return prefetch_to_device(loader.iter_chunks(), build_and_put,
                                  depth=2, workers=workers)


class ActiveSelectionMC(ActiveSelectionBase):
    """Base of the MC selectors (dropout and noise): per-batch vote-entropy
    sweeps on the device."""

    def __init__(self, dataset_num_classes, dataset_store, crop_size,
                 dataloader_batch_size, device=None, mc_dtype=None):
        super().__init__(dataset_store, crop_size, dataloader_batch_size,
                         device=device, mc_dtype=mc_dtype)
        self.dataset_num_classes = dataset_num_classes

    def _scorer(self, bundle: ModelBundle, seed: int, modes=("dropout",)):
        """batch -> (B, H, W) masked vote-entropy maps, summed over one
        ``kernels.mc_vote_entropy_maps`` sweep per noise mode in ``modes``.
        Batch i's sweep j draws from ``mc_generator(seed, len(modes) * i +
        j)``: the port's counterpart of the JAX selectors' ``fold_in(key,
        i)`` (and of 2i, 2i + 1 in the combined noise + dropout scorer)."""
        self._check_bundle(bundle)
        model = kernels.cast_for_mc(bundle.model.eval(), self.mc_dtype())
        batch_index = [0]

        def score_batch(batch):
            total = None
            for j, mode in enumerate(modes):
                gen = kernels.mc_generator(
                    seed, len(modes) * batch_index[0] + j, self.device)
                maps = kernels.mc_vote_entropy_maps(
                    model, batch["image"], batch["label"], gen,
                    self.dataset_num_classes, constants.MC_STEPS, mode,
                    fused_upsample=True, compute_dtype=self.mc_dtype(),
                    labels_packed=True)
                total = maps if total is None else total + maps
            batch_index[0] += 1
            return total
        return score_batch

    def _rank(self, bundle: ModelBundle, images, selection_count, seed: int,
              modes=("dropout",)):
        """``images`` ranked by mean vote entropy (``_scorer``), the
        reference's stable descending sort, top ``selection_count``."""
        loader = self._paths_loader(images, include_labels=True,
                                    labels_as_mask=self.dataset_num_classes)
        scorer = self._scorer(bundle, seed, modes)
        scores = collect_scores(loader, lambda batch: ent_ops.mean_over_pixels(
            scorer(batch)))
        return rank_descending(scores, list(images), selection_count)

    def _region_maps(self, bundle: ModelBundle, images, existing_regions,
                     region_size, selection_size, seed: int,
                     modes=("dropout",)):
        """Every image of ``images`` scored (``_scorer``), its
        ``existing_regions`` suppressed, then box sums, normalization and
        square boxes on the device (``region_pipeline``). Returns ({path:
        [(r, c, size, size)]}, box count)."""
        base_size = 512 if self.crop_size == -1 else self.crop_size
        loader = self._paths_loader(images, include_labels=True,
                                    labels_as_mask=self.dataset_num_classes)
        return create_region_maps_from_scorer(
            self._scorer(bundle, seed, modes), loader, list(images),
            existing_regions, region_size, selection_size, base_size)


def collect_scores(loader, score_batch_fn) -> list:
    """Drain a prefetched loader through a per-batch device scorer. The
    per-batch results stay on the device until the sweep is done, so the
    host never waits for the card inside the loop."""
    pending = [(score_batch_fn(batch), batch["nvalid"]) for batch in loader]
    scores = []
    for out, nvalid in pending:
        scores.extend(out[:nvalid].cpu().tolist())
    return scores


def rank_descending(scores, images, selection_count):
    """reference sorted(zip(scores, images), reverse=True)[:k] — stable on
    ties, keeping pool order (python sorted / stable argsort equivalence)."""
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind="stable")
    return [images[i] for i in order[:selection_count]]


def rank_ascending(scores, images, selection_count):
    """reference sorted(zip(scores, images))[:k] — stable on ties."""
    scores = np.asarray(scores, np.float64)
    order = np.argsort(scores, kind="stable")
    return [images[i] for i in order[:selection_count]]
