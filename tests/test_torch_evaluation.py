"""Checkpoint replay in the port (``engine/evaluation.py``,
``visualize_torch.py``, ``eval_series_torch.py``) against the JAX
package's, on a 2-round port AL loop at crop 33 on the CPU.

Tolerances: a replayed mIoU equals the one the loop logged in
best_pred.txt to 1e-9; the PNGs are byte-equal to the JAX package's; the
same weights carried into JAX and run through its ``evaluate_checkpoint``
give the same confusion matrix and the same PNGs, and a pixel whose two
packages' argmax differ must have its top-two logits within 1e-4
(measured: no such pixel, the confusion matrices are equal)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accuracy_predictor_train_torch as pt_acc_cli
import eval_series_torch
import visualize_torch
from deep_active_semantic_segmentation_torch import constants
from deep_active_semantic_segmentation_torch.config import parse_cli
from deep_active_semantic_segmentation_torch.engine import evaluation as pt_evaluation
from deep_active_semantic_segmentation_torch.engine.active_loop import run_active_loop
from deep_active_semantic_segmentation_torch.utils.summaries import (
    TensorboardSummary as PtSummary)
from deep_active_semantic_segmentation_tpu.engine import evaluation as jx_evaluation
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    deeplab_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.parallel.steps import TrainState
from deep_active_semantic_segmentation_tpu.utils.checkpoint import (
    save_checkpoint as jx_save_checkpoint)
from deep_active_semantic_segmentation_tpu.utils.summaries import (
    TensorboardSummary as JxSummary)
from torch_port_helpers import one_torch_thread, write_dataset  # noqa: F401

SIDE = 33
DATASET = "active_cityscapes_image"
ARGV = ["--dataset", DATASET, "--backbone", "mobilenet", "--lr", "0.01",
        "--use-lr-scheduler", "--use-balanced-weights", "--workers", "0",
        "--no-early-stop", "--base-size", str(SIDE), "--crop-size", str(SIDE),
        "--batch-size", "2", "--epochs", "2", "--active-batch-size", "2",
        "--max-iterations", "2", "--seed", "3", "--checkname", "replay"]
ROW = re.compile(r"run_(\d{4}): Acc:(\S+), Acc_class:(\S+), mIoU:(\S+), "
                 r"fwIoU: (\S+?)(?:, UNetAcc: (\S+), UNetmIoU: (\S+))?$")


@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    """(dataset root, runs root, experiment dir): 2 rounds of the port's
    loop in ``random`` mode over 8 train images (seed set 4) and 4 val
    images."""
    root = str(tmp_path_factory.mktemp("data"))
    write_dataset(root, n_train=8, seed_sets=(("set_0.txt", 4),))
    runs = str(tmp_path_factory.mktemp("runs"))
    cfg = parse_cli(ARGV + ["--active-selection-mode", "random"]).finalize()
    run_active_loop(cfg, dataset_root=root, runs_root=runs, device="cpu")
    exp = os.path.join(runs, DATASET, "replay")
    assert sorted(d for d in os.listdir(exp) if d.startswith("run_")) == [
        "run_0050", "run_0075"]
    return root, runs, exp


def _best_pred(run_dir):
    with open(os.path.join(run_dir, "best_pred.txt")) as f:
        return float(f.readline())


def test_visualize_replays_the_logged_miou(loop_run, capsys):
    root, _, exp = loop_run
    for run in ("run_0050", "run_0075"):
        run_dir = os.path.join(exp, run)
        m = visualize_torch.main(ARGV + ["--checkpoint", os.path.join(run_dir, "best.ckpt")],
                                 dataset_root=root, device="cpu")
        out = capsys.readouterr().out
        assert abs(m["mIoU"] - _best_pred(run_dir)) < 1e-9, (m, run)
        assert ("Acc:{}, Acc_class:{}, mIoU:{}, fwIoU: {}".format(
            m["Acc"], m["Acc_class"], m["mIoU"], m["FWIoU"]) in out)
        assert "Loss: %.3f" % m["loss"] in out and np.isfinite(m["loss"])
        assert set(m) == {"epoch", "loss", "Acc", "Acc_class", "mIoU", "FWIoU"}
        pngs = sorted(os.listdir(os.path.join(run_dir, constants.VISUALIZATIONS_FOLDER)))
        # one img/tgt/prd triple per val image: 4 images in batches of 2
        assert pngs == sorted(f"{kind}_{b:04d}_{i:02d}.png" for kind in ("img", "tgt", "prd")
                              for b in range(2) for i in range(2))
    # N ranks split each global batch by rows (test_torch_parallel_drivers.py);
    # a batch they do not divide is refused before any rank starts
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        visualize_torch.main(ARGV + ["--checkpoint", "x", "--num-devices", "3"],
                             dataset_root=root, device="cpu")


@pytest.mark.parametrize("dataset,classes", [("active_cityscapes_image", 19),
                                             ("active_pascal_image", 21)])
def test_pngs_are_byte_equal_to_jax(tmp_path, dataset, classes):
    rng = np.random.RandomState(classes)
    image = rng.randint(0, 256, (3, 17, 23, 3), dtype=np.uint8)
    target = rng.randint(0, classes, (3, 17, 23)).astype(np.uint8)
    target[:, :4] = 255
    pred = rng.randint(0, classes, (3, 17, 23)).astype(np.int64)
    JxSummary.visualize_images_to_folder(str(tmp_path / "jax"), 7, image, target, pred,
                                         dataset)
    PtSummary.visualize_images_to_folder(str(tmp_path / "port"), 7, torch.from_numpy(image),
                                         torch.from_numpy(target), torch.from_numpy(pred),
                                         dataset)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 9
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


class _Recording(jx_evaluation.Evaluator):
    made = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _Recording.made.append(self)


def test_the_same_weights_in_jax_give_the_same_confusion(loop_run, tmp_path, monkeypatch):
    """Round 1's best.ckpt carried into the JAX package's trees (its own
    ``deeplab_state_dict_to_flax``), saved with its own
    ``save_checkpoint`` and replayed by its ``evaluate_checkpoint`` (on
    the trainer state, loader, eval step and class weights its
    ``visualize.main`` builds, without the Trainer's train-step set-up,
    which the replay does not use): the same
    confusion matrix as the port's replay, every differing argmax a
    near-tie. The two replays' prd_ PNGs are the predictions: byte-equal
    folders mean no pixel differs (the logits are compared pixel by pixel
    only when a PNG differs)."""
    root, _, exp = loop_run
    ckpt = os.path.join(exp, "run_0075", "best.ckpt")
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    params, stats = deeplab_state_dict_to_flax(
        {k: v.numpy() for k, v in payload["state_dict"].items()}, "mobilenet")
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=jx_optim.init_opt_state(params, "SGD"),
                       step=jnp.zeros((), jnp.int32))
    jx_dir = tmp_path / "jax_run"
    jx_dir.mkdir()
    jx_ckpt = str(jx_dir / "best.ckpt")
    jx_save_checkpoint(jx_ckpt, state, payload["epoch"], payload["best_pred"])
    vis = constants.VISUALIZATIONS_FOLDER
    monkeypatch.setattr(jx_evaluation, "Evaluator", _Recording)
    _Recording.made.clear()
    ref = jx_evaluation.evaluate_checkpoint(_jax_trainer(root, state), jx_ckpt,
                                            vis_folder=str(jx_dir / vis))
    jx_confusion = _Recording.made[0]._mat

    made = []
    real = pt_evaluation.Evaluator
    monkeypatch.setattr(pt_evaluation, "Evaluator",
                        lambda *a: made.append(real(*a)) or made[-1])
    got = visualize_torch.main(ARGV + ["--checkpoint", ckpt], dataset_root=root,
                               device="cpu")
    assert got["epoch"] == ref["epoch"]
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])

    # the prd_ PNGs are the predictions: byte-equal folders, equal argmax
    port_vis, jax_vis = os.path.join(exp, "run_0075", vis), str(jx_dir / vis)
    names = sorted(os.listdir(jax_vis))
    assert names == sorted(os.listdir(port_vis)) and len(names) == 12
    differing = [n for n in names if open(os.path.join(port_vis, n), "rb").read()
                 != open(os.path.join(jax_vis, n), "rb").read()]
    near_ties = _near_ties(payload["state_dict"], params, stats, root) if differing else 0
    print(f"pixels whose argmax differs between the packages: {near_ties}")
    jx_confusion = np.asarray(jx_confusion)
    if near_ties == 0:
        assert not differing
        np.testing.assert_array_equal(made[0].confusion, jx_confusion)
        assert got["mIoU"] == ref["mIoU"]
    else:   # each differing pixel moves one count from one cell to another
        assert np.abs(made[0].confusion - jx_confusion).sum() <= 2 * near_ties


def _jax_trainer(root, state):
    """What the JAX package's ``evaluate_checkpoint`` reads of a Trainer,
    as its ``visualize.main`` builds it for ``ARGV``."""
    import types

    from deep_active_semantic_segmentation_tpu.config import parse_cli as jx_parse_cli
    from deep_active_semantic_segmentation_tpu.data import make_dataloader as jx_make_dataloader
    from deep_active_semantic_segmentation_tpu.models.deeplab import DeepLab
    from deep_active_semantic_segmentation_tpu.parallel.steps import make_eval_step
    from deep_active_semantic_segmentation_tpu.utils.class_weights import (
        calculate_weights_labels)

    cfg = jx_parse_cli(ARGV).finalize(n_devices=1)
    _, train_loader, val_loader, _, nclass = jx_make_dataloader(
        cfg.dataset, cfg.base_size, cfg.crop_size, cfg.batch_size, cfg.workers,
        cfg.overfit, init_set=cfg.seed_set, dataset_root=root, seed=cfg.seed,
        device_normalize=True)
    model = DeepLab(num_classes=nclass, backbone="mobilenet", output_stride=16,
                    mc_dropout=True)
    weights = calculate_weights_labels(train_loader, nclass)
    return types.SimpleNamespace(
        state=state, mesh=None, nclass=nclass, dual_head=False, args=cfg,
        val_loader=val_loader, _prefetched=iter,
        eval_step=make_eval_step(model, nclass, class_weights=weights))


def _near_ties(state_dict, params, stats, root):
    """The number of val pixels whose argmax differs between the port's
    and the JAX package's logits on the same batches; each must have its
    port top-two logits within 1e-4."""
    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection.kernels import (
        normalize_on_device)
    from deep_active_semantic_segmentation_tpu.models.deeplab import DeepLab

    model = build_model("deeplab", 19, mc_dropout=True, device="cpu")
    model.load_state_dict(state_dict)
    jmodel = DeepLab(num_classes=19, backbone="mobilenet", output_stride=16,
                     mc_dropout=True)
    _, _, val_loader, _, _ = make_dataloader(DATASET, SIDE, SIDE, 2, init_set="set_0.txt",
                                             dataset_root=root, device="cpu")
    count = 0
    for batch in val_loader:
        x = normalize_on_device(torch.from_numpy(batch["image"]))
        with torch.no_grad():
            logits = model(x).permute(0, 2, 3, 1).numpy()
        jlogits = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                          jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                          train=False))
        differ = logits.argmax(-1) != jlogits.argmax(-1)
        top2 = np.sort(logits, axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0])[differ].max(initial=0.0) <= 1e-4
        count += int(differ.sum())
    return count


def _rows(text):
    rows = [ROW.match(line) for line in text.splitlines() if line.startswith("run_")]
    assert rows and all(rows), text
    return rows


def test_eval_series_matches_each_rounds_best_pred(loop_run, capsys):
    root, runs, exp = loop_run
    series = eval_series_torch.main(ARGV, dataset_root=root, runs_root=runs, device="cpu")
    out = capsys.readouterr().out
    assert sorted(series) == [50, 75]
    for pct, metrics in series.items():
        assert abs(metrics["mIoU"] - _best_pred(os.path.join(exp, f"run_{pct:04d}"))) < 1e-9
    with open(os.path.join(exp, "validation_mIoUs.txt")) as f:
        table = f.read()
    rows = _rows(table)
    assert table.endswith("\n") and table.strip() in out
    # the JAX package's row: each field the metric's repr
    for row in rows:
        m = series[int(row.group(1))]
        assert [row.group(i) for i in range(2, 6)] == [
            str(m[k]) for k in ("Acc", "Acc_class", "mIoU", "FWIoU")]
        assert row.group(6) is None


def test_dual_head_series_on_a_toy_accuracy_predictor_run(tmp_path, capsys):
    root = str(tmp_path / "data")
    write_dataset(root, n_train=8, seed_sets=(("set_0.txt", 4),), family="pascal")
    argv = ["--dataset", "active_pascal_image", "--backbone", "mobilenet",
            "--lr", "0.007", "--use-lr-scheduler", "--lr-scheduler", "step",
            "--workers", "0", "--no-early-stop", "--base-size", str(SIDE),
            "--crop-size", str(SIDE), "--batch-size", "2", "--epochs", "2",
            "--active-batch-size", "2", "--max-iterations", "2", "--seed", "3",
            "--dtype", "float32", "--checkname", "acc"]
    runs = str(tmp_path / "runs")
    pt_acc_cli.main(argv + ["--active-selection-mode", "accuracy"], device="cpu",
                       dataset_root=root, runs_root=runs)
    capsys.readouterr()
    series = eval_series_torch.main(argv + ["--dual-head"], dataset_root=root,
                                    runs_root=runs, device="cpu")
    exp = os.path.join(runs, "active_pascal_image", "acc")
    assert sorted(series) == [50, 75]
    for pct, m in series.items():
        assert abs(m["mIoU"] - _best_pred(os.path.join(exp, f"run_{pct:04d}"))) < 1e-9
        assert 0.0 <= m["UNetAcc"] <= 1.0 and 0.0 <= m["UNetmIoU"] <= 1.0
    rows = _rows(capsys.readouterr().out)
    for row in rows:
        m = series[int(row.group(1))]
        assert (row.group(6), row.group(7)) == (str(m["UNetAcc"]), str(m["UNetmIoU"]))


def test_missing_experiments_raise(loop_run, tmp_path):
    root, runs, _ = loop_run
    with pytest.raises(FileNotFoundError, match="nothing"):
        eval_series_torch.main(ARGV + ["--checkname", "nothing"], dataset_root=root,
                               runs_root=runs, device="cpu")
    (tmp_path / "run_0050").mkdir()   # a run directory without its checkpoint
    with pytest.raises(FileNotFoundError, match="no run_"):
        eval_series_torch.main(ARGV + ["--experiment-dir", str(tmp_path)],
                               dataset_root=root, runs_root=runs, device="cpu")
    with pytest.raises(FileNotFoundError, match="no run_"):
        eval_series_torch.main(ARGV + ["--ckpt-name", "other.ckpt"],
                               dataset_root=root, runs_root=runs, device="cpu")
    assert pt_evaluation.discover_run_checkpoints(str(tmp_path)) == []
