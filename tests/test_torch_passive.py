"""The passive trainer CLI: ``train_torch.main`` against the JAX package's
``train.main`` on the same toy ``cityscapes`` root, and the savers'
``experiment_{n}`` / ``model_best`` rule against the JAX savers'.

Held equal: the run layout (experiment directories and their files, the
TensorBoard event files aside), ``parameters.txt`` byte for byte,
``best_pred.txt``'s form (the best mIoU, then its epoch + 1), the
promotion rule on one sequence of results, and the epoch a resume starts
from. The mIoU values themselves are not compared across the packages:
the two trainings start from different random weights."""

import os
import types

import numpy as np
import pytest
import torch

import train as jx_train
import train_torch as pt_train
from deep_active_semantic_segmentation_torch.utils import saver as pt_saver
from deep_active_semantic_segmentation_torch.utils import summaries as pt_summaries
from deep_active_semantic_segmentation_tpu.utils import saver as jx_saver
from torch_port_helpers import one_torch_thread, write_dataset  # noqa: F401

ARGV = ["--dataset", "cityscapes", "--architecture", "fastscnn",
        "--base-size", "32", "--crop-size", "32", "--epochs", "2",
        "--batch-size", "2", "--lr", "0.01", "--seed", "3", "--checkname", "p",
        "--num-devices", "1"]


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("passive"))
    write_dataset(root, n_train=6)
    return root


def _layout(runs):
    """{relative dir: sorted file names}, event files left out."""
    top = os.path.join(runs, "cityscapes", "p")
    return {os.path.relpath(d, top): sorted(f for f in files
                                            if not f.startswith("events."))
            for d, _, files in os.walk(top)}


def _drive(main, dataset_root, runs, capsys, **kw):
    """Two runs, then a resume of experiment_0 to 3 epochs: (trainers,
    the 'Starting Epoch' of each run)."""
    trainers, starts = [], []
    resume = ["--resume-checkpoint",
              os.path.join(runs, "cityscapes", "p", "experiment_0", "checkpoint.ckpt")]
    for argv in (ARGV, ARGV, ARGV[:-8] + ["--epochs", "3"] + ARGV[-6:] + resume):
        trainers.append(main(argv, dataset_root=dataset_root, runs_root=runs, **kw))
        out = capsys.readouterr().out
        starts.append(int(out.split("Starting Epoch:")[1].split()[0]))
    return trainers, starts


def test_train_torch_main_matches_train_main(dataset_root, tmp_path, capsys):
    jruns, pruns = str(tmp_path / "jax"), str(tmp_path / "port")
    jtrainers, jstarts = _drive(jx_train.main, dataset_root, jruns, capsys)
    ptrainers, pstarts = _drive(pt_train.main, dataset_root, pruns, capsys,
                                device="cpu")
    assert pstarts == jstarts == [0, 0, 2]
    for runs in (jruns, pruns):
        assert sorted(_layout(runs)) == [".", "experiment_0", "experiment_1",
                                         "experiment_2"]
    jl, pl = _layout(jruns), _layout(pruns)
    for d in (".", "experiment_0", "experiment_1"):
        assert pl[d] == jl[d], d
    # the resumed run writes best_pred.txt only if it beats the best it
    # resumed with, in either package
    assert set(pl["experiment_2"]) ^ set(jl["experiment_2"]) <= {"best_pred.txt"}
    for d in ("experiment_0", "experiment_1", "experiment_2"):
        with open(os.path.join(jruns, "cityscapes", "p", d, "parameters.txt")) as a, \
                open(os.path.join(pruns, "cityscapes", "p", d, "parameters.txt")) as b:
            assert a.read() == b.read()
    top = os.path.join(pruns, "cityscapes", "p")
    bests = []
    for d, trainer in zip(("experiment_0", "experiment_1", "experiment_2"), ptrainers):
        path = os.path.join(top, d, "best_pred.txt")
        if not os.path.exists(path):
            assert d == "experiment_2"
            assert trainer.best_pred == ptrainers[0].best_pred   # resumed with it
            continue
        with open(path) as f:
            value, epoch = f.read().split("\n")
        assert float(value) == trainer.best_pred and 1 <= int(epoch) <= 3
        bests.append(float(value))
    # each run that beat every earlier run's best promoted its checkpoint
    payload = torch.load(os.path.join(top, "model_best.ckpt"), weights_only=True)
    assert payload["best_pred"] == max(bests)
    for trainers in (jtrainers, ptrainers):   # the resume carried best_pred on
        assert trainers[2].best_pred >= trainers[0].best_pred


def _saver_rule(module, runs, monkeypatch, sequence):
    """Drive ``module``'s PassiveSaver through ``sequence`` (one list of
    (epoch, best_pred, is_best) per experiment), checkpoints written as the
    text of their (experiment, epoch)."""
    def fake_save(path, *args):
        epoch = args[1] if module is jx_saver else args[2]
        with open(path, "w") as f:
            f.write(f"{os.path.basename(os.path.dirname(path))}@{epoch}")

    monkeypatch.setattr(module, "save_checkpoint", fake_save)
    cfg = types.SimpleNamespace(dataset="cityscapes", checkname="s")
    for experiment in sequence:
        saver = module.PassiveSaver(cfg, runs_root=runs)
        for epoch, best, is_best in experiment:
            if module is jx_saver:
                saver.save_checkpoint(None, epoch, best, is_best)
            else:
                saver.save_checkpoint(None, None, epoch, best, is_best)
    top = os.path.join(runs, "cityscapes", "s")
    return {os.path.relpath(os.path.join(d, f), top): open(os.path.join(d, f)).read()
            for d, _, files in os.walk(top) for f in files}


def test_passive_saver_promotion_equals_jax(tmp_path, monkeypatch):
    """Twelve experiments with bests that rise, fall and tie. The
    reference numbers a run one past the LAST ``experiment_*`` in string
    order, so once ``experiment_10`` exists (it sorts before
    ``experiment_2``) the next run is ``experiment_10`` again: kept."""
    rng = np.random.RandomState(0)
    sequence = []
    for _ in range(11):
        best, rows = 0.0, []
        for epoch in range(1, 4):
            miou = float(np.round(rng.uniform(0.2, 0.6), 2))
            rows.append((epoch, max(best, miou), miou > best))
            best = max(best, miou)
        sequence.append(rows)
    sequence.append([(1, 0.0, False)])   # a run that never improves
    ref = _saver_rule(jx_saver, str(tmp_path / "jax"), monkeypatch, sequence)
    got = _saver_rule(pt_saver, str(tmp_path / "port"), monkeypatch, sequence)
    assert got == ref
    assert "model_best.ckpt" in got and got["experiment_10/checkpoint.ckpt"] == (
        "experiment_10@1")
    assert not any(k.startswith("experiment_11") for k in got)


def test_saver_remove_existing_equals_jax(tmp_path):
    cfg = types.SimpleNamespace(dataset="cityscapes", checkname="r")
    for module, root in ((jx_saver, tmp_path / "jax"), (pt_saver, tmp_path / "port")):
        module.Saver(cfg, runs_root=str(root))
        stale = root / "cityscapes" / "r" / "stale.txt"
        stale.write_text("x")
        module.Saver(cfg, runs_root=str(root))
        assert stale.exists()
        module.Saver(cfg, remove_existing=True, runs_root=str(root))
        assert not stale.exists() and stale.parent.is_dir()


@pytest.mark.parametrize("extra,arch", [
    ([], "deeplab"),                                        # ResNet-50
    (["--architecture", "enet", "--optimizer", "Adam"], "enet"),
    (["--backbone", "mobilenet", "--use-balanced-weights", "--use-lr-scheduler"],
     "deeplab"),
])
def test_every_model_trains_through_train_torch(dataset_root, tmp_path, monkeypatch,
                                                extra, arch):
    """The default (DeepLab-ResNet-50), ENet with Adam and the MobileNetV2
    DeepLab with balanced weights and the poly schedule, 2 epochs each: a
    train grid written every epoch (picked over the val loader's length,
    2 here, so always inside the 3 train batches), finite losses."""
    grids = []
    monkeypatch.setattr(pt_summaries.TensorboardSummary, "visualize_image",
                        lambda self, writer, dataset, image, target, output,
                        step, prefix="val": grids.append((prefix, step, image.shape)))
    argv = [a for a in ARGV if a not in ("--architecture", "fastscnn")]
    trainer = pt_train.main(argv + extra, dataset_root=str(dataset_root),
                            runs_root=str(tmp_path), device="cpu")
    assert [g[:2] for g in grids] == [("train", 0), ("train", 1)]
    assert grids[0][2] == (2, 32, 32, 3)
    assert np.isfinite(trainer.best_pred)
    assert trainer.model.model_name == arch
    if not extra:
        assert trainer.args.backbone == "resnet"
        assert type(trainer.model.backbone).__name__ == "ResNet"


def test_train_torch_refuses_what_train_py_refuses(dataset_root, monkeypatch):
    with pytest.raises(SystemExit):
        pt_train.main(["--dataset", "active_cityscapes_image"], device="cpu")
    # a global batch the ranks do not divide, before any rank starts
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        pt_train.main(ARGV[:-2] + ["--num-devices", "2", "--batch-size", "3"],
                      device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_train.main(ARGV, dataset_root=dataset_root)
