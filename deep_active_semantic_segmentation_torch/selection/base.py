"""Selector base + the model handle selectors score with (parity: the JAX
package's selection/base.py).

``ModelBundle`` holds the ``nn.Module`` and the device it lives on. The
selector owns the pool-scoring loader: host geometry in ordered prefetch
workers, then a pinned-memory, non-blocking copy of the uint8 wire to the
card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from deep_active_semantic_segmentation_torch import resolve_device
from deep_active_semantic_segmentation_torch.data.loader import (
    PathsLoader, prefetch_to_device, to_device)

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
