"""The port's LMDB store (``data/store.py`` ``LmdbStore`` and
``open_store``, the factory's ``<split>.db`` lookup, the converter's
``--lmdb``) against the JAX package's.

The ``lmdb`` binding is an optional dependency the project does not
install, so the stores run on an in-memory stand-in for the module:
``open`` with the flags recorded, ``begin(write=)`` as a context manager
with ``get`` / ``put`` that commits on a clean exit, and ``sync``; an
environment's
committed records also land pickled in the file at its path, so the
stores' existence checks see it. The stand-in is set at test time with
monkeypatch on ``lmdb`` and ``HAVE_LMDB`` of both packages'
``data/store.py`` and on both ``data/convert.py``s' imported
``HAVE_LMDB``; no file of the JAX package is edited. The real binding is
not run.

Every comparison is exact: records, ``__keys__`` and ``__len__`` bytes,
the open flags, the uint8 wire of the loaders, the errors' types and
messages without the binding."""

import os
import pickle

import numpy as np
import pytest

from deep_active_semantic_segmentation_torch.data import convert as pt_convert
from deep_active_semantic_segmentation_torch.data import factory as pt_factory
from deep_active_semantic_segmentation_torch.data import store as pt_store
from deep_active_semantic_segmentation_tpu.data import convert as jx_convert
from deep_active_semantic_segmentation_tpu.data import factory as jx_factory
from deep_active_semantic_segmentation_tpu.data import store as jx_store
from test_torch_tools import _cityscapes_tree
from torch_port_helpers import one_torch_thread  # noqa: F401

SIDE = 9


class _Txn:
    def __init__(self, env, write):
        self.env, self.write, self.pending = env, write, {}

    def __enter__(self):
        return self

    def __exit__(self, kind, *_):
        if kind is None and self.pending:
            self.env.records.update(self.pending)
            with open(self.env.path, "wb") as f:
                pickle.dump(self.env.records, f)
        return False

    def get(self, key):
        return self.pending.get(bytes(key), self.env.records.get(bytes(key)))

    def put(self, key, value):
        if not self.write:
            raise RuntimeError("put in a read transaction")
        self.pending[bytes(key)] = bytes(value)


class _Env:
    def __init__(self, path, flags):
        self.path, self.flags, self.syncs = path, flags, 0
        self.records = {}
        if os.path.exists(path):
            with open(path, "rb") as f:
                self.records = pickle.load(f)
        elif flags.get("readonly"):
            raise RuntimeError(f"no environment at {path}")

    def begin(self, write=False):
        if write and self.flags.get("readonly"):
            raise RuntimeError("write transaction on a readonly environment")
        return _Txn(self, write)

    def sync(self):
        self.syncs += 1


class StandInLmdb:
    """The slice of the py-lmdb module the stores use; ``opened`` records
    every ``open``'s (path, flags)."""

    def __init__(self):
        self.opened = []
        self.envs = []

    def open(self, path, **flags):
        self.opened.append((path, flags))
        self.envs.append(_Env(path, flags))
        return self.envs[-1]


@pytest.fixture
def lmdb(monkeypatch):
    fake = StandInLmdb()
    for module in (pt_store, jx_store):
        monkeypatch.setattr(module, "lmdb", fake, raising=False)
        monkeypatch.setattr(module, "HAVE_LMDB", True)
    for module in (pt_convert, jx_convert):
        monkeypatch.setattr(module, "HAVE_LMDB", True)
    return fake


def _records(n, seed):
    rng = np.random.RandomState(seed)
    return [(f"/leftImg8bit/train/c/img_{i:03d}.png".encode(),
             rng.randint(0, 256, (7, 11, 4), dtype=np.uint8)) for i in range(n)]


def test_port_store_writes_the_jax_store_bytes(lmdb, tmp_path):
    """Records put one by one, then ``finalize`` with the key order: the
    port's environment holds the JAX store's bytes (pickle protocol 3),
    ``__keys__`` and ``__len__`` included, opened with the same flags and
    synced; both read every record back from either file."""
    records = _records(5, 0)
    keys = [k for k, _ in records][::-1]     # an order of its own
    for name, module in (("jax", jx_store), ("port", pt_store)):
        store = module.LmdbStore(str(tmp_path / f"{name}.db"), readonly=False)
        for key, arr in records:
            store.put(key, arr)
        store.finalize(keys)
    (jpath, jflags), (ppath, pflags) = lmdb.opened
    assert pflags == jflags and pflags["map_size"] == 1 << 34 and not pflags["subdir"]
    assert (pflags["lock"], pflags["readahead"], pflags["meminit"]) == (False,) * 3
    jenv, penv = lmdb.envs
    assert penv.records == jenv.records and len(penv.records) == 7
    assert pickle.loads(penv.records[b"__len__"]) == 5 and penv.syncs == jenv.syncs == 1
    assert penv.records[b"__keys__"] == pickle.dumps(keys, protocol=3)
    for key, arr in records:
        assert penv.records[key] == pickle.dumps(arr, protocol=3)
    for path in (jpath, ppath):
        for module in (jx_store, pt_store):
            store = module.open_store(path)
            assert isinstance(store, module.LmdbStore) and store.keys() == keys
            for key, arr in records:
                got = store.get(key)
                assert got.dtype == np.uint8 and got.tobytes() == arr.tobytes()
    assert lmdb.opened[-1][1] == {"subdir": False, "readonly": True, "lock": False,
                                  "readahead": False, "meminit": False}
    # finalize without keys: every key put, in order
    store = pt_store.LmdbStore(str(tmp_path / "pending.db"), readonly=False)
    for key, arr in records:
        store.put(key, arr)
    store.finalize()
    assert pt_store.open_store(str(tmp_path / "pending.db")).keys() == [k for k, _ in records]


def _wire(loader):
    return [(np.asarray(b["image"]).tobytes(), np.asarray(b["label"]).tobytes(),
             int(b["nvalid"])) for b in loader]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_converted_lmdb_store_loads_through_both_factories(lmdb, tmp_path, writer):
    """A Cityscapes tree converted with ``--lmdb`` by one package's
    converter (``<split>.db`` and the seed set beside it) loads through
    the other's and the same package's factory: the pools read the LMDB
    store, ahead of a ``<split>/`` DirectoryStore beside it, and the val
    loaders ship the same uint8 wire byte for byte."""
    src = str(tmp_path / "src")
    rng = np.random.RandomState(4)
    for split in ("train", "val"):
        _cityscapes_tree(src, split, 6, rng)
    root = tmp_path / "datasets"
    (root / "cityscapes").mkdir(parents=True)   # lmdb makes no parent folder
    module = jx_convert if writer == "jax" else pt_convert
    for split in ("train", "val"):
        out = str(root / "cityscapes" / f"{split}.db")
        module.main(["cityscapes", src, split, out, "--lmdb", "--seed-set-count", "3"])
        assert os.path.isfile(out)
        # a DirectoryStore of other records beside it is not read
        decoy = pt_store.DirectoryStore(str(root / "cityscapes" / split), readonly=False)
        decoy.put(b"decoy", np.zeros((3, 3, 4), np.uint8))
        decoy.finalize()
    wires = {}
    for name, factory, extra in (("jax", jx_factory, {"device_normalize": True}),
                                 ("port", pt_factory, {"device": "cpu"})):
        train_set, _, val_loader, _, nclass = factory.make_dataloader(
            "active_cityscapes_image", SIDE, SIDE, 4, dataset_root=str(root),
            init_set="set_0.txt", seed=0, **extra)
        store_type = (jx_store if name == "jax" else pt_store).LmdbStore
        assert isinstance(train_set.store, store_type) and nclass == 19
        assert len(train_set.image_paths) == 6 and b"decoy" not in train_set.image_paths
        assert len(train_set.current_image_paths) == 3
        wires[name] = _wire(val_loader)
    assert wires["port"] == wires["jax"] and [w[2] for w in wires["port"]] == [4, 2]


def test_without_the_binding_both_packages_raise_alike(tmp_path):
    """Without the binding: ``--lmdb`` raises the JAX converter's
    RuntimeError and writes nothing, an ``LmdbStore`` cannot be opened, and
    a ``<split>.db`` file is a FileNotFoundError naming the missing binding,
    in both packages alike."""
    assert not pt_store.HAVE_LMDB and pt_store.lmdb is None
    src = str(tmp_path / "src")
    _cityscapes_tree(src, "train", 2, np.random.RandomState(0))
    errors = {}
    for name, module in (("jax", jx_convert), ("port", pt_convert)):
        out = tmp_path / name / "cityscapes" / "train.db"
        with pytest.raises(RuntimeError) as err:
            module.main(["cityscapes", src, "train", str(out), "--lmdb"])
        errors[name] = str(err.value)
        assert not (tmp_path / name).exists()
    assert errors["port"] == errors["jax"] == "lmdb binding not available; use DirectoryStore"
    db = tmp_path / "data" / "cityscapes" / "train.db"
    db.parent.mkdir(parents=True)
    db.write_bytes(b"not read")
    for kind, call in (("store", lambda m: m.LmdbStore(str(db))),
                       ("open_store", lambda m: m.open_store(str(db))),
                       ("factory", lambda m: m._resolve_store(str(db.parent), "train"))):
        raised = []
        for module in ((jx_store, pt_store) if kind != "factory"
                       else (jx_factory, pt_factory)):
            with pytest.raises((RuntimeError, FileNotFoundError)) as err:
                call(module)
            raised.append((type(err.value), str(err.value)))
        assert raised[0] == raised[1], kind
        assert "lmdb binding" in raised[1][1]
