"""Dataset/loader factory (parity: the JAX package's data/factory.py:29,
itself the reference dataloaders/__init__.py:7-96): the same dataset keys
and return tuple ``(train_set, train_loader, val_loader, None,
num_classes)``.

Ported: the passive datasets (``cityscapes``, ``pascal``) and the image-
and region-level AL datasets (``active_{cityscapes,pascal}_{image,region}``)
on a ``DirectoryStore``; LMDB stores are ROADMAP A16b.
"""

from __future__ import annotations

import os
import random
from typing import Optional

from deep_active_semantic_segmentation_torch import constants, resolve_device
from deep_active_semantic_segmentation_torch.data.loader import Loader
from deep_active_semantic_segmentation_torch.data.pools import (
    CITYSCAPES, PASCAL, ActiveImagePool, ActiveRegionPool, PassivePool)
from deep_active_semantic_segmentation_torch.data.store import DirectoryStore


def _resolve_store(dataset_path: str, split: str):
    """``<split>/`` as a DirectoryStore (``<split>.db`` is LMDB: A16)."""
    directory = os.path.join(dataset_path, split)
    if os.path.exists(os.path.join(directory, DirectoryStore.INDEX)):
        return DirectoryStore(directory)
    if os.path.exists(os.path.join(dataset_path, split + ".db")):
        raise NotImplementedError("LMDB stores are not ported yet (ROADMAP A16b)")
    raise FileNotFoundError(f"no store for split '{split}' under {dataset_path}")


def make_dataloader(dataset: str, base_size: int, crop_size: int,
                    batch_size: int, num_workers: int = 0,
                    overfit: bool = False, *, init_set: Optional[str] = None,
                    memory_hog: bool = False, dataset_root: Optional[str] = None,
                    seed: Optional[int] = None,
                    rng: Optional[random.Random] = None, device=None,
                    mesh=None):
    """The pools and loaders of ``dataset``. ``seed`` seeds the train
    loader's shuffle; ``rng`` is the host stream the train transforms draw
    from; the loaders put their batches on ``device`` (the CUDA card by
    default). ``num_workers`` is accepted for the reference's signature:
    the train loader runs one producer thread, so the draws keep their
    order. ``mesh``: the loaders yield its rank's rows of each global
    batch of ``batch_size``, on its device."""
    device = mesh.device if mesh is not None else resolve_device(device)
    shard = dict(rank=mesh.rank, world=mesh.world) if mesh is not None else {}
    if not (dataset in ("cityscapes", "pascal")
            or dataset.endswith(("_image", "_region"))):
        raise NotImplementedError(dataset)
    root = dataset_root or constants.DATASET_ROOT
    family = PASCAL if "pascal" in dataset else CITYSCAPES
    dataset_path = os.path.join(root, family.name)
    seed_dir = os.path.join(dataset_path, "seed_sets")
    stores = {split: _resolve_store(dataset_path, split)
              for split in ("train", "val")}

    if dataset in ("cityscapes", "pascal"):
        train_set, val_set = (
            PassivePool(family, stores[split], base_size, crop_size, split,
                        overfit, memory_hog, rng) for split in ("train", "val"))
    else:
        pool = ActiveImagePool if dataset.endswith("_image") else ActiveRegionPool
        train_set = pool(family, stores["train"], base_size, crop_size,
                         "train", init_set, seed_dir, overfit, memory_hog, rng)
        val_set = pool(family, stores["val"], base_size, crop_size, "val",
                       None, seed_dir, overfit, memory_hog, rng)
    train_loader = Loader(train_set, batch_size, shuffle=True, seed=seed,
                          device=device, **shard)
    val_loader = Loader(val_set, batch_size, shuffle=False, device=device,
                        **shard)
    return train_set, train_loader, val_loader, None, train_set.NUM_CLASSES
