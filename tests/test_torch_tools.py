"""The port's offline tools against the JAX package's: the dataset
converter (``data/convert.py``), the seed-set tools, ``compare_selections``
and the profiling helpers. Every comparison is exact: the stores' files,
the seed sets and the per-round agreement counts are byte- or
value-equal."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from deep_active_semantic_segmentation_torch.config import parse_cli
from deep_active_semantic_segmentation_torch.data import convert as pt_convert
from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
from deep_active_semantic_segmentation_torch.engine.active_loop import run_active_loop
from deep_active_semantic_segmentation_torch.utils import compare_selections as pt_cmp
from deep_active_semantic_segmentation_torch.utils import profiling
from deep_active_semantic_segmentation_torch.utils import seed_tools as pt_seed
from deep_active_semantic_segmentation_tpu.data import convert as jx_convert
from deep_active_semantic_segmentation_tpu.utils import compare_selections as jx_cmp
from deep_active_semantic_segmentation_tpu.utils import seed_tools as jx_seed
from torch_port_helpers import one_torch_thread, write_dataset  # noqa: F401


def _cityscapes_tree(root, split, n, rng):
    """leftImg8bit/<split>/<city>/*.png with their gtFine labelIds (every
    labelId 0-33 and 255 drawn), over two cities."""
    for i in range(n):
        city = ("aachen", "bonn")[i % 2]
        img_dir = os.path.join(root, "leftImg8bit", split, city)
        lab_dir = os.path.join(root, "gtFine_trainvaltest", "gtFine", split, city)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lab_dir, exist_ok=True)
        stem = f"{city}_{i:06d}_000019"
        Image.fromarray(rng.randint(0, 256, (12, 20, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f"{stem}_leftImg8bit.png"))
        Image.fromarray(rng.choice(list(range(34)) + [255], (12, 20)).astype(np.uint8)).save(
            os.path.join(lab_dir, f"{stem}_gtFine_labelIds.png"))


def _pascal_tree(root, split, n, rng):
    """JPEGImages/*.jpg, SegmentationClassRaw/*.png and the split's list."""
    for sub in ("JPEGImages", "SegmentationClassRaw", "ImageSets/Segmentation"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = [f"2007_{i:06d}" for i in range(n)]
    for name in names:
        Image.fromarray(rng.randint(0, 256, (15, 21, 3), dtype=np.uint8)).save(
            os.path.join(root, "JPEGImages", f"{name}.jpg"))
        Image.fromarray(rng.choice(list(range(21)) + [255], (15, 21)).astype(np.uint8)).save(
            os.path.join(root, "SegmentationClassRaw", f"{name}.png"))
    with open(os.path.join(root, "ImageSets/Segmentation", f"{split}.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def _files(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("family,tree", [("cityscapes", _cityscapes_tree),
                                         ("pascal", _pascal_tree)])
def test_converted_stores_and_seed_sets_are_byte_equal_to_jax(tmp_path, family, tree):
    src = str(tmp_path / "src")
    rng = np.random.RandomState(3)
    for split in ("train", "val"):
        tree(src, split, 6, rng)
    for split in ("train", "val"):
        outs = {}
        for name, module in (("jax", jx_convert), ("port", pt_convert)):
            outs[name] = str(tmp_path / name / family / split)
            module.main([family, src, split, outs[name], "--seed-set-count", "4",
                         "--seed-set-seed", "7"])
        got, ref = _files(outs["port"]), _files(outs["jax"])
        assert got == ref and len(got) == 7   # 6 records and the key index
    seed_sets = [str(tmp_path / name / family / "seed_sets" / "set_0.txt")
                 for name in ("port", "jax")]
    assert open(seed_sets[0], "rb").read() == open(seed_sets[1], "rb").read()
    assert len(open(seed_sets[0]).read().splitlines()) == 4
    store = DirectoryStore(str(tmp_path / "port" / family / "train"))
    rec = np.asarray(store.get(store.keys()[0]))
    if family == "cityscapes":
        assert store.keys()[0] == b"/leftImg8bit/train/aachen/aachen_000000_000019_leftImg8bit.png"
        assert set(np.unique(rec[..., 3])) <= set(range(19)) | {255}
        table = pt_convert.cityscapes_class_map()
        assert [int(table[i]) for i in (7, 8, 26, 33, 0, 255)] == [0, 1, 13, 18, 255, 255]
    else:
        assert store.keys()[0] == b"2007_000000" and rec.shape == (15, 21, 4)


def test_lmdb_raises_naming_its_item_and_writes_nothing(tmp_path):
    src = str(tmp_path / "src")
    _cityscapes_tree(src, "train", 2, np.random.RandomState(0))
    out = tmp_path / "out" / "cityscapes" / "train"
    # without the lmdb binding (an optional dependency), as the JAX
    # converter raises; with it, test_torch_lmdb.py
    with pytest.raises(RuntimeError, match="lmdb binding not available; use DirectoryStore"):
        pt_convert.main(["cityscapes", src, "train", str(out), "--lmdb"])
    assert not (tmp_path / "out").exists()


def test_seed_tools_give_the_jax_sets(tmp_path):
    keys = [f"/leftImg8bit/train/c/img_{i:03d}.png" for i in range(40)]
    for seed in (0, 1, 123):
        got = pt_seed.create_initial_set(keys, count=12, seed=seed)
        assert got == jx_seed.create_initial_set(keys, count=12, seed=seed)
        assert len(set(got)) == 12
    for name, module in (("port", pt_seed), ("jax", jx_seed)):
        module.write_seed_set(str(tmp_path / name / "set_0.txt"),
                              [k.encode() for k in keys[:5]] + keys[5:8])
    assert ((tmp_path / "port" / "set_0.txt").read_bytes()
            == (tmp_path / "jax" / "set_0.txt").read_bytes())
    clusters = tmp_path / "clusters"
    for c, files in (("0", ["aachen_000001_leftImg8bit.png"]),
                     ("1", ["bonn_000002_leftImg8bit.png", "aachen_000003_leftImg8bit.png"])):
        (clusters / c).mkdir(parents=True)
        for f in files:
            (clusters / c / f).touch()
    got = pt_seed.create_cluster_set(str(clusters), str(tmp_path / "port.json"))
    ref = jx_seed.create_cluster_set(str(clusters), str(tmp_path / "jax.json"))
    assert got == ref and json.loads((tmp_path / "port.json").read_text()) == ref
    assert sorted(got["1"]) == ["/leftImg8bit/train/aachen/aachen_000003_leftImg8bit.png",
                                "/leftImg8bit/train/bonn/bonn_000002_leftImg8bit.png"]


@pytest.fixture(scope="module")
def two_port_runs(tmp_path_factory):
    """Two 2-round port loops (``random`` mode, crop 33, seeds 3 and 4)
    over one 10-image pool with a 4-image seed set."""
    root = str(tmp_path_factory.mktemp("data"))
    write_dataset(root, n_train=10, seed_sets=(("set_0.txt", 4),))
    runs = str(tmp_path_factory.mktemp("runs"))
    argv = ["--dataset", "active_cityscapes_image", "--backbone", "mobilenet",
            "--base-size", "33", "--crop-size", "33", "--batch-size", "2",
            "--epochs", "1", "--lr", "0.01", "--active-batch-size", "3",
            "--max-iterations", "2", "--active-selection-mode", "random",
            "--workers", "0", "--no-early-stop"]
    for seed in (3, 4):
        cfg = parse_cli(argv + ["--seed", str(seed), "--checkname", f"s{seed}"]).finalize()
        run_active_loop(cfg, dataset_root=root, runs_root=runs, device="cpu")
    return [os.path.join(runs, "active_cityscapes_image", f"s{seed}") for seed in (3, 4)]


def test_compare_selections_gives_the_jax_results(two_port_runs, tmp_path, capsys):
    a, b = two_port_runs
    pairs = [(a, a), (a, b)]
    perturbed = str(tmp_path / "perturbed")
    shutil.copytree(a, perturbed)
    run = sorted(d for d in os.listdir(perturbed) if d.startswith("run_"))[-1]
    path = os.path.join(perturbed, run, "selections.txt")
    lines = open(path).read().splitlines()
    lines[-1] = "/leftImg8bit/train/city/not_selected.png"
    open(path, "w").write("\n".join(lines) + "\n")
    pairs.append((a, perturbed))
    for x, y in pairs:
        got = pt_cmp.compare_selections(x, y)
        out = capsys.readouterr().out
        ref = jx_cmp.compare_selections(x, y)
        assert got == ref and out == capsys.readouterr().out
        assert len(got) == 2 and got[min(got)] == (4, 4)
    same = pt_cmp.compare_selections(a, a, verbose=False)
    assert all(n == total for n, total in same.values())
    bumped = pt_cmp.compare_selections(a, perturbed, verbose=False)
    assert bumped[run] == (same[run][0] - 1, same[run][1])
    # a round with more selections in one run than the other
    open(path, "a").write("/leftImg8bit/train/city/extra.png\n")
    with pytest.raises(ValueError, match="unequal"):
        pt_cmp.compare_selections(a, perturbed, verbose=False)
    with pytest.raises(AssertionError, match="unequal"):
        jx_cmp.compare_selections(a, perturbed, verbose=False)


def test_throughput_counts_and_trace(tmp_path):
    t = profiling.Throughput()
    t.mark(4)                     # an unstarted counter: starts the clock
    assert t.items_per_sec == 0.0
    t.mark(8, result=torch.ones(3))
    t.mark(8, result=torch.ones(()))
    assert t._count == 16 and t.items_per_sec > 0
    assert abs(t.items_per_sec - 16 / t._elapsed) < 1e-9
    assert t.summary() == f"{t.items_per_sec:.2f} imgs/s"
    assert t.summary("images").endswith(" images/s")
    t.reset()
    assert t.items_per_sec == 0.0
    with profiling.trace(None):   # off: a no-op
        torch.ones(2) + 1
    assert not list(tmp_path.iterdir())
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
