"""The port's active-learning loop against the JAX package's: pool
bookkeeping, checkpoints, the run directory's text files, the CLI's
configuration, and the slice as a whole — a 2-round `random`-mode loop in
both packages with the same seed gives byte-identical `selections.txt`
files (the port draws its host randomness in the JAX package's order), and
a `variance`-mode port loop picks the top-K of its own scorer on the
round's `best.ckpt`."""

import dataclasses
import filecmp
import os
import random

import numpy as np
import pytest
import torch

import active_train_torch
from deep_active_semantic_segmentation_torch import constants as pt_constants
from deep_active_semantic_segmentation_torch import config as pt_config
from deep_active_semantic_segmentation_torch.data import pools as pt_pools
from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
from deep_active_semantic_segmentation_torch.engine.active_loop import (
    run_active_loop as pt_run_active_loop)
from deep_active_semantic_segmentation_torch.models.factory import (
    build_model, param_groups)
from deep_active_semantic_segmentation_torch.parallel.optim import (
    build_optimizer, set_lr)
from deep_active_semantic_segmentation_torch.utils import saver as pt_saver
from deep_active_semantic_segmentation_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint)
from deep_active_semantic_segmentation_tpu import config as jx_config
from deep_active_semantic_segmentation_tpu.data import pools as jx_pools
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JxDirectoryStore)
from deep_active_semantic_segmentation_tpu.engine.active_loop import (
    run_active_loop as jx_run_active_loop)
from deep_active_semantic_segmentation_tpu.utils import saver as jx_saver
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, one_torch_thread, write_pool)

SIDE = 33
POOL, SEED_SET = 16, 5

# the canonical experiment's flags (test_scripts/cs_experiments_*.sh) at
# toy geometry
CANONICAL = ["--dataset", "active_cityscapes_image", "--backbone", "mobilenet",
             "--lr", "0.01", "--use-lr-scheduler", "--use-balanced-weights",
             "--workers", "0", "--no-early-stop"]
TOY = ["--base-size", str(SIDE), "--crop-size", str(SIDE), "--batch-size", "2",
       "--epochs", "1", "--active-batch-size", "3", "--max-iterations", "2",
       "--seed", "3"]


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """A 16-image train pool (seed set of 5) and a 4-image val split."""
    root = str(tmp_path_factory.mktemp("data"))
    city = os.path.join(root, "cityscapes")
    keys = write_pool(DirectoryStore(os.path.join(city, "train"), readonly=False),
                      POOL, seed=0)
    write_pool(DirectoryStore(os.path.join(city, "val"), readonly=False), 4, seed=1)
    os.makedirs(os.path.join(city, "seed_sets"))
    with open(os.path.join(city, "seed_sets", "set_0.txt"), "w") as f:
        f.writelines(k.decode() + "\n" for k in keys[:SEED_SET])
    return root


def _run_files(runs, checkname):
    """{relative path: bytes} of the loop's text files; names of the rest."""
    exp = os.path.join(runs, "active_cityscapes_image", checkname)
    texts, names = {}, set()
    for dirpath, _, files in os.walk(exp):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), exp)
            if f.endswith(".txt"):
                texts[rel] = open(os.path.join(dirpath, f), "rb").read()
            elif not f.startswith("events.out"):
                names.add(rel)
    return texts, names


# ------------------------------------------------------------------ config

def test_parse_cli_gives_the_jax_config():
    argv = CANONICAL + ["--crop-size", "513", "--batch-size", "5",
                        "--eval-interval", "5", "--active-selection-mode", "variance"]
    got, ref = pt_config.parse_cli(argv), jx_config.parse_cli(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    random.seed(0)
    ref = ref.finalize(n_devices=1)
    random.seed(0)
    got = got.finalize(n_devices=1)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.dtype == "bfloat16" and got.mc_dropout and got.epochs == 200
    with pytest.raises(NotImplementedError, match="A15"):
        pt_config.parse_cli(argv + ["--num-devices", "2"]).finalize()


# ------------------------------------------------------------- bookkeeping

@pytest.mark.parametrize("memory_hog", [False, True])
def test_pool_bookkeeping_equals_jax(dataset_root, memory_hog):
    city = os.path.join(dataset_root, "cityscapes")
    args = (SIDE, SIDE, "train", "set_0.txt", os.path.join(city, "seed_sets"))
    jp = jx_pools.ActiveImagePool(jx_pools.CITYSCAPES,
                                  JxDirectoryStore(os.path.join(city, "train")),
                                  *args, memory_hog=memory_hog, device_normalize=True)
    pp = pt_pools.ActiveImagePool(pt_pools.CITYSCAPES,
                                  DirectoryStore(os.path.join(city, "train")), *args,
                                  memory_hog=memory_hog)

    def state(p):
        return (list(p.current_image_paths), list(p.remaining_image_paths), len(p),
                p.labeled_pixel_count, p.get_fraction_of_labeled_data(),
                p.get_next_est_fraction_of_labeled_data(3))

    assert state(pp) == state(jp)
    for pool in (jp, pp):
        pool.expand_training_set(pool.remaining_image_paths[2:5])
        pool.make_dataset_multiple_of_batchsize(3)
    assert state(pp) == state(jp) and len(pp) == 9
    for pool in (jp, pp):
        pool.reset_dataset()
    assert state(pp) == state(jp) and len(pp) == 8
    if memory_hog:   # the labeled records are resident
        assert set(pp.store._cache) == set(pp.current_image_paths)
    # val pools serve the eval transform: the same uint8 samples
    val_args = (SIDE, SIDE, "val")
    jv = jx_pools.ActiveImagePool(jx_pools.CITYSCAPES,
                                  JxDirectoryStore(os.path.join(city, "val")),
                                  *val_args, device_normalize=True)
    pv = pt_pools.ActiveImagePool(pt_pools.CITYSCAPES,
                                  DirectoryStore(os.path.join(city, "val")), *val_args,
                                  memory_hog=memory_hog)
    for i in range(len(pv)):
        a, b = pv.get_item(i), jv.get_item(i)
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype == np.uint8
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_round_trip_is_exact(tmp_path):
    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device="cpu")
    opt = build_optimizer("SGD", param_groups(model, "deeplab"))
    model.train()
    loss = model(torch.randn(2, 3, SIDE, SIDE), use_dropout=False).square().mean()
    loss.backward()
    set_lr(opt, 0.01)
    opt.step()                                   # momentum buffers exist now
    path = str(tmp_path / "best.ckpt")
    save_checkpoint(path, model, opt, epoch=3, best_pred=0.25, step=7)

    fresh = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    fresh_opt = build_optimizer("SGD", param_groups(fresh, "deeplab"))
    payload = load_checkpoint(path, fresh, fresh_opt, "cpu")
    assert (payload["epoch"], payload["step"], payload["best_pred"]) == (3, 7, 0.25)
    assert set(payload) == {"epoch", "state_dict", "optimizer", "step", "best_pred",
                            "extra"}
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    a, b = opt.state_dict(), fresh_opt.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        assert torch.equal(st["momentum_buffer"], b["state"][i]["momentum_buffer"])


def test_saver_text_files_equal_jax_byte_for_byte(tmp_path):
    import jax.numpy as jnp

    from deep_active_semantic_segmentation_tpu.parallel.steps import TrainState

    cfg = pt_config.parse_cli(CANONICAL + TOY + ["--checkname", "sv"]).finalize()
    jcfg = jx_config.parse_cli(CANONICAL + TOY + ["--checkname", "sv"]).finalize()
    paths = [f"/leftImg8bit/train/city/img_{i:03d}.png".encode() for i in range(4)]
    regions = [[(0, 0, 33, 33)], [(1, 2, 3, 4), (5, 6, 7, 8)], [(9, 9, 9, 9)],
               [(0, 1, 2, 3)]]
    model = build_model("deeplab", 5, device="cpu")
    state = TrainState(params={"w": jnp.zeros(2)}, batch_stats={},
                       opt_state={}, step=jnp.zeros((), jnp.int32))
    out = {}
    for name, mod, c in (("port", pt_saver, cfg), ("jax", jx_saver, jcfg)):
        root = str(tmp_path / name)
        top = mod.Saver(c, runs_root=root)
        top.save_experiment_config()
        for pct, regs in ((31, None), (50, regions)):
            s = mod.ActiveSaver(c, pct, runs_root=root)
            s.save_experiment_config()
            s.save_active_selections(paths, regs)
            if name == "port":
                s.save_checkpoint(model, None, 2, 0.125, is_best=True)
            else:
                s.save_checkpoint(state, 2, 0.125, is_best=True)
        out[name] = _run_files(root, "sv")
    assert out["port"][0] == out["jax"][0]
    assert sorted(out["port"][0]) == [
        "parameters.txt", "run_0031/best_pred.txt", "run_0031/parameters.txt",
        "run_0031/selections.txt", "run_0050/best_pred.txt",
        "run_0050/parameters.txt", "run_0050/selections.txt"]
    assert out["port"][1] == out["jax"][1] == {
        f"run_{p}/{f}" for p in ("0031", "0050") for f in ("best.ckpt", "checkpoint.ckpt")}


# -------------------------------------------------------------------- loop

def test_random_mode_loop_selections_equal_jax_byte_for_byte(dataset_root, tmp_path):
    """Both packages' 2-round loops from one seed: the same run directories
    and byte-identical text files but best_pred.txt (the two trainings
    draw their weights and dropout masks from different generators)."""
    argv = CANONICAL + TOY + ["--checkname", "rnd", "--active-selection-mode", "random"]
    port_runs, jax_runs = str(tmp_path / "port"), str(tmp_path / "jax")
    history = pt_run_active_loop(pt_config.parse_cli(argv).finalize(),
                                 dataset_root=dataset_root, runs_root=port_runs,
                                 device="cpu")
    jx_run_active_loop(jx_config.parse_cli(argv).finalize(n_devices=1), mesh=None,
                       dataset_root=dataset_root, runs_root=jax_runs)
    (pt_texts, pt_names), (jx_texts, jx_names) = (
        _run_files(port_runs, "rnd"), _run_files(jax_runs, "rnd"))
    assert pt_names == jx_names and set(pt_texts) == set(jx_texts)
    assert {k for k in pt_texts if k.endswith("selections.txt")} == {
        "run_0031/selections.txt", "run_0050/selections.txt"}
    for rel in pt_texts:
        if not rel.endswith("best_pred.txt"):
            assert pt_texts[rel] == jx_texts[rel], rel
    lines = [pt_texts[f"run_{p}/selections.txt"].decode().splitlines()
             for p in ("0031", "0050")]
    assert len(lines[0]) == SEED_SET and len(lines[1]) == SEED_SET + 3
    assert lines[1][:SEED_SET] == lines[0]
    assert sorted(history) == [31, 50]
    for round_ in history.values():
        assert 0.0 <= round_["mIoU"] <= 1.0
        assert set(round_["seconds"]) == {"train", "validate", "select"}


def test_variance_mode_loop_picks_the_top_k_of_its_scorer(dataset_root, tmp_path,
                                                          monkeypatch):
    """The port's `variance` loop, through the CLI driver on the CPU: round
    1's new lines are the top 3 of the port's own scorer on round 0's
    best.ckpt with the loop's seed; best.ckpt reloads exactly."""
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)

    monkeypatch.setattr(pt_constants, "DATASET_ROOT", dataset_root)
    monkeypatch.setattr(pt_constants, "RUNS", str(tmp_path))
    argv = CANONICAL + TOY + ["--checkname", "var", "--active-selection-mode",
                              "variance", "--dtype", "float32"]
    history = active_train_torch.main(argv, device="cpu")
    assert sorted(history) == [31, 50]
    exp = os.path.join(str(tmp_path), "active_cityscapes_image", "var")
    sel = [open(os.path.join(exp, f"run_{p}", "selections.txt")).read().splitlines()
           for p in ("0031", "0050")]
    assert sel[1][:SEED_SET] == sel[0]
    new = [s.encode() for s in sel[1][SEED_SET:]]

    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device="cpu")
    payload = load_checkpoint(os.path.join(exp, "run_0031", "best.ckpt"), model)
    for k, v in payload["state_dict"].items():
        assert torch.equal(model.state_dict()[k], v), k
    train = os.path.join(dataset_root, "cityscapes", "train")
    remaining = [k for k in DirectoryStore(train).keys()
                 if k.decode() not in set(sel[0])]
    scorer = get_active_selection_class("variance", NUM_CLASSES, DirectoryStore(train),
                                        SIDE, 2, device="cpu")
    top = scorer.get_vote_entropy_for_images(ModelBundle(model, torch.device("cpu")),
                                             remaining, 3, seed=3 + 0)
    assert new == top
    assert filecmp.cmp(os.path.join(exp, "run_0031", "parameters.txt"),
                       os.path.join(exp, "run_0050", "parameters.txt"), shallow=False)


def test_unported_parts_raise_naming_their_item(dataset_root, tmp_path):
    base = CANONICAL + TOY + ["--checkname", "x"]
    region = ["--dataset", "active_cityscapes_region"]
    for extra, item in ((region + ["--active-selection-mode", "noise_image"],
                         "does not support region datasets"),
                        (region + ["--active-selection-mode", "accuracy_eval"],
                         r"ROADMAP C, accuracy_eval on region"),
                        (region + ["--active-selection-mode", "accuracy_labels"],
                         r"ROADMAP C, accuracy_labels on region"),
                        (region + ["--active-selection-mode", "ceal_entropy"],
                         "does not support region datasets"),
                        (region, r"ROADMAP C, random on region"),
                        (["--dataset", "cityscapes"], "A14"),
                        (["--architecture", "enet"], "A12"),
                        (["--pretrained-weights", "w.pth"], "A14"),
                        (["--remat"], "remat")):
        cfg = pt_config.parse_cli(base + extra).finalize()
        with pytest.raises(NotImplementedError, match=item):
            pt_run_active_loop(cfg, dataset_root=dataset_root,
                               runs_root=str(tmp_path), device="cpu")
    # the JAX loop's own up-front check: core-set on images only
    cfg = pt_config.parse_cli(base + region + ["--active-selection-mode",
                                               "coreset"]).finalize()
    with pytest.raises(AssertionError, match="only images"):
        pt_run_active_loop(cfg, dataset_root=dataset_root,
                           runs_root=str(tmp_path), device="cpu")


def test_random_on_regions_fails_in_jax_and_is_rejected_before_training(
        dataset_root, tmp_path):
    """The JAX loop lists `random` as region-capable, but its branch reads
    `remaining_image_paths`, which the region pool lacks, and hands one
    list to an `expand_training_set` that takes (regions, pixels): it fails
    after a whole training round. The port refuses before training."""
    city = os.path.join(dataset_root, "cityscapes")
    pool = jx_pools.ActiveRegionPool(
        jx_pools.CITYSCAPES, JxDirectoryStore(os.path.join(city, "train")), SIDE,
        SIDE, "train", "set_0.txt", os.path.join(city, "seed_sets"))
    assert not hasattr(pool, "remaining_image_paths")
    with pytest.raises(TypeError):
        pool.expand_training_set([pool.image_paths[-1]])
    cfg = pt_config.parse_cli(CANONICAL + TOY + [
        "--checkname", "rr", "--dataset", "active_cityscapes_region",
        "--active-selection-mode", "random"]).finalize()
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        pt_run_active_loop(cfg, dataset_root=dataset_root,
                           runs_root=str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)           # no run directory, no training


@pytest.mark.parametrize("mode", ["accuracy_eval", "accuracy_labels"])
def test_accuracy_on_regions_fails_in_jax_and_is_rejected_before_training(
        dataset_root, tmp_path, monkeypatch, mode):
    """The JAX loop lists both oracle modes as region-capable, but their
    branches read `remaining_image_paths`, which the region pool lacks: the
    JAX loop (its training skipped here) fails at its first selection with
    AttributeError. The port refuses before training."""
    from torch_port_helpers import jax_deeplab, select_with_shared_weights

    argv = CANONICAL + TOY + ["--checkname", "acc", "--dataset",
                              "active_cityscapes_region", "--active-selection-mode",
                              mode, "--monitor-directory", "producer"]
    select_with_shared_weights(monkeypatch, *jax_deeplab(seed=0)[1:])
    with pytest.raises(AttributeError, match="remaining_image_paths"):
        jx_run_active_loop(jx_config.parse_cli(argv).finalize(n_devices=1), mesh=None,
                           dataset_root=dataset_root, runs_root=str(tmp_path / "jax"))
    port_runs = tmp_path / "port"
    port_runs.mkdir()
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        pt_run_active_loop(pt_config.parse_cli(argv).finalize(),
                           dataset_root=dataset_root, runs_root=str(port_runs),
                           device="cpu")
    assert not os.listdir(port_runs)          # no run directory, no training


REGION = 9


def test_region_variance_loop_picks_the_boxes_of_its_scorer(dataset_root, tmp_path,
                                                            monkeypatch, capsys):
    """A 2-round `variance` loop on `active_cityscapes_region` through
    `active_train_torch.main` on the CPU: selections.txt carries the JAX
    package's region lines, the labeled pixels grow by count * region²,
    and round 1's boxes are those of the port's own region pipeline on
    round 0's best.ckpt."""
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)

    monkeypatch.setattr(pt_constants, "DATASET_ROOT", dataset_root)
    monkeypatch.setattr(pt_constants, "RUNS", str(tmp_path))
    argv = CANONICAL + TOY + ["--checkname", "reg", "--dataset",
                              "active_cityscapes_region", "--active-selection-mode",
                              "variance", "--active-region-size", str(REGION),
                              "--dtype", "float32"]
    history = active_train_torch.main(argv, device="cpu")
    requested = -(-3 * SIDE ** 2 // REGION ** 2)
    got = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("Got ")]
    assert len(got) == 1 and got[0].endswith(f"/{requested} regions")
    count = int(got[0].split()[1].split("/")[0])
    assert 1 <= count <= requested
    pixels = (SEED_SET * SIDE ** 2, SEED_SET * SIDE ** 2 + count * REGION ** 2)
    assert sorted(history) == [round(p / (POOL * SIDE ** 2) * 100) for p in pixels]

    exp = os.path.join(str(tmp_path), "active_cityscapes_region", "reg")
    runs = sorted(d for d in os.listdir(exp) if d.startswith("run_"))
    lines = [open(os.path.join(exp, d, "selections.txt")).read().splitlines()
             for d in runs]
    seed_paths = [line.split(",")[0] for line in lines[0]]
    assert lines[0] == [f"{p},0,0,{SIDE},{SIDE}" for p in seed_paths]

    def parse(line):
        path, *nums = line.split(",")
        nums = [int(x) for x in nums]
        return path.encode(), [tuple(nums[i:i + 4]) for i in range(0, len(nums), 4)]
    after = dict(parse(line) for line in lines[1])
    assert list(after)[:SEED_SET] == [p.encode() for p in seed_paths]
    assert sum(len(v) for v in after.values()) == SEED_SET + count

    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device="cpu")
    load_checkpoint(os.path.join(exp, runs[0], "best.ckpt"), model)
    train = os.path.join(dataset_root, "cityscapes", "train")
    image_paths = list(DirectoryStore(train).keys())
    existing = [[(0, 0, SIDE, SIDE)] if p.decode() in seed_paths else []
                for p in image_paths]
    sel = get_active_selection_class("variance", NUM_CLASSES, DirectoryStore(train),
                                     SIDE, 2, device="cpu")
    regions, n = sel.create_region_maps(ModelBundle(model, torch.device("cpu")),
                                        image_paths, existing, REGION, 3, seed=3 + 0)
    assert n == count
    expected = {p.encode(): [(0, 0, SIDE, SIDE)] for p in seed_paths}
    for path, boxes in regions.items():
        expected.setdefault(path, []).extend(boxes)
    assert after == expected and list(after) == list(expected)


def test_ceal_weak_label_loop_picks_the_top_k_and_labels_the_rest(
        dataset_root, tmp_path, monkeypatch):
    """A 2-round `ceal_entropy_weakly_labeled` loop through
    `active_train_torch.main` on the CPU: round 1's new lines are the top 3 entropies of the port's
    scorer on round 0's best.ckpt, and every other remaining image (all sit
    under the threshold) is weakly labeled with its prediction, served by
    the pool in round 1's training."""
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)

    added = []
    real_add = pt_pools.ActiveImagePool.add_weak_labels

    def spy(pool, weak):
        added.append(dict(weak))
        real_add(pool, weak)
        added.append(len(pool))

    monkeypatch.setattr(pt_pools.ActiveImagePool, "add_weak_labels", spy)
    monkeypatch.setattr(pt_constants, "DATASET_ROOT", dataset_root)
    monkeypatch.setattr(pt_constants, "RUNS", str(tmp_path))
    argv = CANONICAL + TOY + ["--checkname", "weak", "--active-selection-mode",
                              "ceal_entropy_weakly_labeled", "--dtype", "float32",
                              "--weak-label-entropy-threshold", "4.3"]
    history = active_train_torch.main(argv, device="cpu")
    assert sorted(history) == [31, 50]
    exp = os.path.join(str(tmp_path), "active_cityscapes_image", "weak")
    sel = [open(os.path.join(exp, f"run_{p}", "selections.txt")).read().splitlines()
           for p in ("0031", "0050")]
    assert sel[1][:SEED_SET] == sel[0] and len(sel[1]) == SEED_SET + 3
    new = [s.encode() for s in sel[1][SEED_SET:]]

    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device="cpu")
    load_checkpoint(os.path.join(exp, "run_0031", "best.ckpt"), model)
    train = os.path.join(dataset_root, "cityscapes", "train")
    remaining = [k for k in DirectoryStore(train).keys()
                 if k.decode() not in set(sel[0])]
    scorer = get_active_selection_class("ceal_entropy_weakly_labeled", NUM_CLASSES,
                                        DirectoryStore(train), SIDE, 2, device="cpu")
    bundle = ModelBundle(model, torch.device("cpu"))
    top, entropies = scorer.get_maximum_entropy_samples(bundle, remaining, 3)
    assert new == top and max(entropies) < 4.3
    weak, pool_len = added
    assert list(weak) == [p for p in remaining if p not in top]
    assert pool_len == SEED_SET + 3 + len(weak)
    ref = scorer.get_weakly_labeled_data(bundle, remaining, 4.3, entropies)
    for p, target in weak.items():
        np.testing.assert_array_equal(target, ref[p])
