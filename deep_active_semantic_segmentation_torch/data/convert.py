"""Offline dataset converters (own copy of the JAX package's
data/convert.py:30-136; parity: reference utils/cityscapes_to_lmdb.py and
utils/pascal_to_lmdb.py).

Write a ``DirectoryStore``, or with ``--lmdb`` the reference's LMDB
store (``LmdbStore``; it needs the ``lmdb`` binding, and without it
raises as the JAX converter does): key = image path, value = the HxWx4
uint8 ``np.dstack((rgb, label))``, each record byte-equal to the JAX
converter's; Cityscapes labels are remapped from the 34 labelIds to the
19 trainIds (the rest 255). A train split also gets a seed set,
``seed_sets/set_0.txt`` beside the store.

    python -m deep_active_semantic_segmentation_torch.data.convert \\
        cityscapes <cityscapes root> train datasets/cityscapes/train
    python -m deep_active_semantic_segmentation_torch.data.convert \\
        pascal <VOC2012 root> val datasets/pascal/val
"""

from __future__ import annotations

import argparse
import glob
import os
from pathlib import Path

import numpy as np
from PIL import Image

from deep_active_semantic_segmentation_torch.data.store import (
    HAVE_LMDB, DirectoryStore, LmdbStore)
from deep_active_semantic_segmentation_torch.utils.seed_tools import (
    create_initial_set, write_seed_set)

CITYSCAPES_IGNORE_INDEX = 255

# reference utils/cityscapes_to_lmdb.py:16-21
CITYSCAPES_VOID_CLASSES = [0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30, -1]
CITYSCAPES_VALID_CLASSES = [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25,
                            26, 27, 28, 31, 32, 33]


def cityscapes_class_map() -> np.ndarray:
    """Dense 256-entry remap table for gtFine labelIds -> trainIds."""
    table = np.full(256, CITYSCAPES_IGNORE_INDEX, np.uint8)
    for train_id, label_id in enumerate(CITYSCAPES_VALID_CLASSES):
        table[label_id] = train_id
    return table


def _make_store(out_path: str, use_lmdb: bool):
    if use_lmdb:
        if not HAVE_LMDB:
            raise RuntimeError("lmdb binding not available; use DirectoryStore")
        return LmdbStore(out_path, readonly=False)
    return DirectoryStore(out_path, readonly=False)


def emit_seed_set(keys, out_path: str, count: int, seed: int) -> str:
    """Write ``seed_sets/set_0.txt`` beside the store at
    ``out_path``: ``count`` of ``keys`` sampled from ``seed`` (the
    reference ships such sets, drawn by create_initial_set.py:9 with an
    unseeded ``random.sample``). Returns its path."""
    sel = create_initial_set([k.decode() for k in keys],
                             count=min(count, len(keys)), seed=seed)
    path = os.path.join(os.path.dirname(os.path.normpath(out_path)),
                        "seed_sets", "set_0.txt")
    write_seed_set(path, sel)
    return path


def cityscapes_to_store(root_path: str, split: str, out_path: str,
                        use_lmdb: bool = False) -> list:
    """Convert a Cityscapes split (reference cityscapes_to_lmdb.py:13-58):
    ``leftImg8bit/<split>/<city>/*.png`` with their
    ``gtFine_trainvaltest/gtFine/<split>/<city>/*_gtFine_labelIds.png``.
    Returns the keys in store order."""
    store = _make_store(out_path, use_lmdb)
    images_base = os.path.join(root_path, "leftImg8bit", split)
    labels_base = os.path.join(root_path, "gtFine_trainvaltest", "gtFine", split)
    image_paths = sorted(glob.glob(os.path.join(images_base, "**", "*.png"),
                                   recursive=True))
    table = cityscapes_class_map()
    keys = []
    for img_path in image_paths:
        label_path = os.path.join(
            labels_base, Path(img_path).parts[-2],
            f"{os.path.basename(img_path)[:-15]}gtFine_labelIds.png")
        image = np.array(Image.open(img_path).convert("RGB"), np.uint8)
        label = table[np.array(Image.open(label_path), np.uint8)]
        key = "/".join(img_path.replace(root_path, "").split(os.path.sep)
                       ).encode("ascii")
        store.put(key, np.dstack((image, label)))
        keys.append(key)
    store.finalize(keys)
    return keys


def pascal_to_store(root_path: str, split: str, out_path: str,
                    use_lmdb: bool = False) -> list:
    """Convert a Pascal VOC split (reference pascal_to_lmdb.py:11-60): the
    names of ``ImageSets/Segmentation/<split>.txt``, their ``JPEGImages``
    and ``SegmentationClassRaw`` PNGs. Returns the keys in store order."""
    store = _make_store(out_path, use_lmdb)
    split_txt = os.path.join(root_path, "ImageSets/Segmentation", f"{split}.txt")
    with open(split_txt, "r") as f:
        names = [x.strip() for x in f.readlines() if x.strip()]
    keys = []
    for name in names:
        image = np.array(Image.open(os.path.join(
            root_path, "JPEGImages", f"{name}.jpg")).convert("RGB"), np.uint8)
        label = np.array(Image.open(os.path.join(
            root_path, "SegmentationClassRaw", f"{name}.png")), np.uint8)
        key = name.encode("ascii")
        store.put(key, np.dstack((image, label)))
        keys.append(key)
    store.finalize(keys)
    return keys


def main(argv=None):
    parser = argparse.ArgumentParser(description="dataset -> store converter")
    parser.add_argument("family", choices=["cityscapes", "pascal"])
    parser.add_argument("root")
    parser.add_argument("split")
    parser.add_argument("out")
    parser.add_argument("--lmdb", action="store_true",
                        help="write the reference's LMDB format (needs the "
                             "lmdb binding)")
    parser.add_argument("--seed-set-count", type=int, default=50,
                        help="train splits also emit seed_sets/set_0.txt "
                             "with this many paths (reference "
                             "create_initial_set.py samples 50); 0 disables")
    parser.add_argument("--seed-set-seed", type=int, default=0,
                        help="RNG seed for the emitted seed set")
    ns = parser.parse_args(argv)
    fn = cityscapes_to_store if ns.family == "cityscapes" else pascal_to_store
    keys = fn(ns.root, ns.split, ns.out, use_lmdb=ns.lmdb)
    print(f"wrote {len(keys)} records to {ns.out}")
    if ns.split == "train" and ns.seed_set_count > 0:
        path = emit_seed_set(keys, ns.out, ns.seed_set_count,
                             ns.seed_set_seed)
        print(f"wrote seed set to {path}")
    return keys


if __name__ == "__main__":
    main()
