"""Key-value image stores (own copy of the JAX package's data/store.py).

Every sample is an ``np.dstack((rgb, label))`` HxWx4 uint8 array keyed by
image path, the reference's LMDB wire format. Two backends are ported:

* ``DirectoryStore`` — one ``.npy`` per record plus a pickled key index;
  memory-mapped reads, safe for concurrent readers. Reads and writes the
  same files as the JAX package's ``DirectoryStore``.
* ``MemoryStore`` — in-process dict, used by tests and tiny experiments.

Both share ``keys()``, ``get(key)``, ``put(key, arr)``, ``finalize(keys)``.
``get`` is safe to call from several threads at once (PathsLoader runs
store reads inside its prefetch workers); ``put``/``finalize`` are
single-threaded. ``CachingStore`` wraps either for ``--memory-hog``.
``LmdbStore`` is a later item (ROADMAP A16).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np


class MemoryStore:
    """Dict-backed store (tests / tiny experiments)."""

    def __init__(self, records: Optional[Dict[bytes, np.ndarray]] = None):
        self._records: Dict[bytes, np.ndarray] = dict(records or {})

    def keys(self) -> List[bytes]:
        return list(self._records.keys())

    def get(self, key: bytes) -> np.ndarray:
        return self._records[key]

    def put(self, key: bytes, arr: np.ndarray) -> None:
        self._records[bytes(key)] = np.asarray(arr)

    def finalize(self, keys: Optional[Sequence[bytes]] = None) -> None:
        pass


class DirectoryStore:
    """One .npy per record + a pickled ordered key index.

    Filenames are content-addressed by key hash so arbitrary path-like keys
    (e.g. ``/leftImg8bit/train/city/frame.png``) are filesystem-safe.
    """

    INDEX = "__keys__.pkl"

    def __init__(self, root: str, readonly: bool = True):
        self.root = root
        self.readonly = readonly
        os.makedirs(root, exist_ok=True)
        index_path = os.path.join(root, self.INDEX)
        if os.path.exists(index_path):
            with open(index_path, "rb") as f:
                self._keys: List[bytes] = pickle.load(f)
        else:
            self._keys = []

    @staticmethod
    def _fname(key: bytes) -> str:
        return hashlib.sha1(bytes(key)).hexdigest() + ".npy"

    def keys(self) -> List[bytes]:
        return list(self._keys)

    def get(self, key: bytes) -> np.ndarray:
        return np.load(os.path.join(self.root, self._fname(key)), mmap_mode="r")

    def put(self, key: bytes, arr: np.ndarray) -> None:
        if self.readonly:
            raise PermissionError("store opened readonly")
        np.save(os.path.join(self.root, self._fname(key)), np.asarray(arr))
        self._keys.append(bytes(key))

    def finalize(self, keys: Optional[Sequence[bytes]] = None) -> None:
        if keys is not None:
            self._keys = [bytes(k) for k in keys]
        with open(os.path.join(self.root, self.INDEX), "wb") as f:
            pickle.dump(self._keys, f)


class CachingStore:
    """Memory-hog mode (the JAX package's ``CachingStore``): labeled paths
    are preloaded by the pools and every other record is cached on first
    read, so after one pool sweep the whole split is resident."""

    def __init__(self, base):
        self.base = base
        self._cache: Dict[bytes, np.ndarray] = {}

    def keys(self) -> List[bytes]:
        return self.base.keys()

    def preload(self, keys: Sequence[bytes]) -> None:
        for k in keys:
            if k not in self._cache:
                self._cache[k] = np.asarray(self.base.get(k))

    def get(self, key: bytes) -> np.ndarray:
        hit = self._cache.get(key)
        if hit is None:
            # concurrent prefetch workers may race to fill the same key;
            # setdefault publishes exactly one load
            hit = self._cache.setdefault(key, np.asarray(self.base.get(key)))
        return hit
