"""Key-value image stores (own copy of the JAX package's data/store.py).

Every sample is an ``np.dstack((rgb, label))`` HxWx4 uint8 array keyed by
image path, the reference's LMDB wire format. Three backends:

* ``LmdbStore`` — the reference's ``.db`` files: each record pickled
  (protocol 3) under its key, with ``__keys__`` / ``__len__`` metadata
  records (reference utils/cityscapes_to_lmdb.py:44-55), opened with the
  reference's flags. It needs the ``lmdb`` binding, an optional import
  here as in the JAX package (``HAVE_LMDB``); without it, opening one
  raises.
* ``DirectoryStore`` — one ``.npy`` per record plus a pickled key index;
  memory-mapped reads, safe for concurrent readers. Reads and writes the
  same files as the JAX package's ``DirectoryStore``.
* ``MemoryStore`` — in-process dict, used by tests and tiny experiments.

All share ``keys()``, ``get(key)``, ``put(key, arr)``, ``finalize(keys)``,
and write the JAX package's bytes. ``get`` is safe to call from several
threads at once (PathsLoader runs store reads inside its prefetch
workers; ``LmdbStore`` opens a read transaction per call);
``put``/``finalize`` are single-threaded. ``CachingStore`` wraps any of
them for ``--memory-hog``. ``open_store`` picks the backend of a path.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

try:  # the optional native binding of the reference's on-disk format
    import lmdb  # type: ignore

    HAVE_LMDB = True
except Exception:  # the binding is absent
    lmdb = None
    HAVE_LMDB = False


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


class LmdbStore:
    """Reader and writer of the reference's LMDB format (pickled uint8
    stacks; the JAX package's ``LmdbStore``, store.py:108-138)."""

    def __init__(self, path: str, readonly: bool = True, map_size: int = 1 << 34):
        if not HAVE_LMDB:
            raise RuntimeError("lmdb binding not available")
        # the reference's open flags (cityscapes_base.py:17)
        self.env = lmdb.open(path, subdir=os.path.isdir(path), readonly=readonly,
                             lock=False, readahead=False, meminit=False,
                             **({} if readonly else {"map_size": map_size}))
        self._pending: List[bytes] = []

    def keys(self) -> List[bytes]:
        with self.env.begin(write=False) as txn:
            return pickle.loads(txn.get(b"__keys__"))

    def get(self, key: bytes) -> np.ndarray:
        with self.env.begin(write=False) as txn:
            return pickle.loads(txn.get(key))

    def put(self, key: bytes, arr: np.ndarray) -> None:
        with self.env.begin(write=True) as txn:
            txn.put(bytes(key), pickle.dumps(np.asarray(arr), protocol=3))
        self._pending.append(bytes(key))

    def finalize(self, keys: Optional[Sequence[bytes]] = None) -> None:
        """``__keys__`` (``keys``, or every key put) and ``__len__``."""
        keys = [bytes(k) for k in (keys if keys is not None else self._pending)]
        with self.env.begin(write=True) as txn:
            txn.put(b"__keys__", pickle.dumps(keys, protocol=3))
            txn.put(b"__len__", pickle.dumps(len(keys), protocol=3))
        self.env.sync()


def open_store(path: str):
    """The store at ``path`` (the JAX package's ``open_store``): a
    directory with a ``DirectoryStore`` index, else an LMDB file or
    directory when the binding imports, else a directory as an (empty)
    ``DirectoryStore``; ``FileNotFoundError`` otherwise."""
    if os.path.isdir(path) and os.path.exists(os.path.join(path, DirectoryStore.INDEX)):
        return DirectoryStore(path, readonly=True)
    if HAVE_LMDB and os.path.exists(path):
        return LmdbStore(path, readonly=True)
    if os.path.isdir(path):
        return DirectoryStore(path, readonly=True)
    raise FileNotFoundError(
        f"No store found at {path} (DirectoryStore index missing"
        f"{', lmdb binding unavailable' if not HAVE_LMDB else ''})")


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
