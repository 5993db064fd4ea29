"""The four drivers that run on N ranks since the two-headed trainer does
(accuracy_predictor_train_torch, visualize_torch, eval_series_torch,
unet_train_torch) on two gloo ranks on the CPU, against the same drivers
in one process; and the JAX SEM trainer's fault on more than one device.

Each driver's rank body (its ``_run`` / ``train``, what ``main`` launches
on every rank) runs on the two ranks of one ``launch`` for the module
(``torch_parallel_workers.driver_checks``), with the process group's
timeout and a join timeout; the one-process references run here.
Toy size: a Pascal pool of 12 records (seed set 5, 3 picked per round),
crop 33, MobileNetV2 with 2 rows per rank, 2 rounds of 1 epoch; SEM at
crop 32, batch 2, 5 epochs (so its batch-1 validation runs).

Tolerances: the accuracy predictor's picks, selections.txt bytes equal
(every selection made with one fixed set of weights, as
test_torch_accuracy_driver.py makes the port's and the JAX driver's);
the replays' confusion-derived metrics exactly equal, their losses 1e-6
relative, the PNGs byte-equal; the SEM run's printed losses and
accuracies within 1e-4 relative, in f64 (``chip_smoke.f64_models``): its
f32 runs are chaotic, RMSprop turning the rounding noise of the conv
biases' gradients (0 in exact arithmetic: train-mode BN follows them)
into steps of 10 lr, so one process at 1 and 3 threads already parts by
1.3e-3 at the first epoch's loss and 2.2x at the fifth epoch's
validation loss."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import accuracy_predictor_train_torch as acc_driver
import eval_series_torch
import unet_train_torch
import visualize_torch
from chip_smoke import f64_models
from deep_active_semantic_segmentation_torch import constants
from deep_active_semantic_segmentation_torch.engine import trainer as pt_trainer
from deep_active_semantic_segmentation_torch.models.factory import build_model
from deep_active_semantic_segmentation_torch.models.unet import UNet as PtUNet
from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
from deep_active_semantic_segmentation_torch.utils.checkpoint import save_checkpoint
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    unet_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.models.unet import UNet as JaxUNet
from deep_active_semantic_segmentation_tpu.parallel import steps as jx_steps
from deep_active_semantic_segmentation_tpu.parallel.mesh import make_mesh as jx_make_mesh
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, selections, write_dataset)
import torch_parallel_workers as workers

WORLD = 2
NCLASS = 21    # Pascal VOC
SIDE = 33
JOIN_TIMEOUT_S = 400      # a spawn's limit
GROUP_TIMEOUT_S = 120     # a collective's limit inside the ranks
ACC_ARGV = ["--backbone", "mobilenet", "--lr", "0.007", "--use-lr-scheduler",
            "--lr-scheduler", "step", "--use-balanced-weights", "--workers", "0",
            "--no-early-stop", "--base-size", str(SIDE), "--crop-size", str(SIDE),
            "--batch-size", "4", "--epochs", "1", "--active-batch-size", "3",
            "--max-iterations", "2", "--seed", "3", "--dtype", "float32",
            "--active-region-size", "9"]
ACC_RUNS = {f"{dataset}-{mode}": (dataset, mode) for dataset, mode in (
    ("active_pascal_image", "accuracy"), ("active_pascal_image", "gradient"),
    ("active_pascal_image", "uncertain"), ("active_pascal_image", "uncertain_gradient"),
    ("active_pascal_region", "accuracy"))}
# the replays: 4 val images in a global batch of 6 (visualize; rank 1 holds
# 1 image and 2 pad rows) or 2 (eval_series)
REPLAY_ARGV = ["--dataset", "active_pascal_image", "--backbone", "mobilenet",
               "--base-size", str(SIDE), "--crop-size", str(SIDE), "--workers", "0",
               "--seed", "3"]
UNET_ARGV = ["--epochs", "5", "--crop-size", "32", "--batch-size", "2"]


def _acc_argv(name, world):
    dataset, mode = ACC_RUNS[name]
    return ACC_ARGV + ["--dataset", dataset, "--active-selection-mode", mode,
                       "--checkname", name, "--num-devices", str(world)]


def _write_sem(root):
    """sem/{train,val}: 4 and 3 grayscale PNGs of 40 x 52 with 0/255
    masks (3 val images: the 2-rank batch-1 validation ends on rank 0)."""
    rng = np.random.RandomState(0)
    for split, n in (("train", 4), ("val", 3)):
        for sub in ("images", "masks"):
            os.makedirs(os.path.join(root, "sem", split, sub))
        for i in range(n):
            img = np.kron(rng.randint(0, 256, (10, 13)), np.ones((4, 4), int))
            mask = np.kron(rng.rand(5, 13) > 0.5, np.ones((8, 4), int)) * 255
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(root, "sem", split, "images", f"{i}.png"))
            Image.fromarray(mask.astype(np.uint8)).save(
                os.path.join(root, "sem", split, "masks", f"{i}.png"))


def _model_state(arch, seed):
    gen = torch.Generator().manual_seed(seed)
    model = build_model(arch, NCLASS, backbone="mobilenet", device="cpu",
                        generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    return model


def _replay_copy(name, tmp):
    """``name``'s run dir under ``tmp``: the replays' checkpoint and
    experiment directory are copied there, so that each run writes its own
    files."""
    out = tmp / name
    shutil.copytree(tmp / "replay", out)
    return out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The one-process runs of every driver, then the same on two ranks."""
    tmp = tmp_path_factory.mktemp("drivers")
    root = str(tmp / "data")
    write_dataset(root, n_train=12, family="pascal")
    _write_sem(str(tmp / "sem_root"))
    predictor = _model_state("accuracy_predictor", 11)
    state_dict = {k: v.clone() for k, v in predictor.state_dict().items()}
    one = {"accuracy": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt_trainer.Trainer, "load_best_checkpoint",
                   lambda self: self.model.load_state_dict(state_dict))
        for name in ACC_RUNS:
            one["accuracy"][name] = acc_driver.main(
                _acc_argv(name, 1), device="cpu", dataset_root=root,
                runs_root=str(tmp / "runs_one"))
    # the replays' inputs: a DeepLab checkpoint and the one-process
    # accuracy_predictor run's experiment
    (tmp / "replay").mkdir()
    save_checkpoint(str(tmp / "replay" / "best.ckpt"), _model_state("deeplab", 12),
                    None, 3, 0.5)
    shutil.copytree(tmp / "runs_one" / "active_pascal_image" / "active_pascal_image-accuracy",
                    tmp / "replay" / "experiment")
    replay_one = _replay_copy("replay_one", tmp)
    replay_ranks = _replay_copy("replay_ranks", tmp)

    def replay_argv(where):
        return {"visualize": REPLAY_ARGV + ["--batch-size", "6", "--checkpoint",
                                            str(where / "best.ckpt")],
                "eval_series": REPLAY_ARGV + ["--batch-size", "2", "--dual-head",
                                              "--experiment-dir", str(where / "experiment")]}

    argv = replay_argv(replay_one)
    one["visualize"] = visualize_torch.main(argv["visualize"] + ["--num-devices", "1"],
                                            dataset_root=root, device="cpu")
    one["eval_series"] = eval_series_torch.main(
        argv["eval_series"] + ["--num-devices", "1"], dataset_root=root, device="cpu")
    with f64_models():
        one["unet"] = unet_train_torch.train(
            pt_mesh.make_mesh(device="cpu"), unet_train_torch.parse_args(UNET_ARGV),
            str(tmp / "sem_root"))[2]

    argv = replay_argv(replay_ranks)
    setup = {"root": root, "runs": str(tmp / "runs_ranks"), "state_dict": state_dict,
             "sem_root": str(tmp / "sem_root"),
             "accuracy_runs": {name: _acc_argv(name, WORLD) for name in ACC_RUNS},
             "visualize_argv": argv["visualize"] + ["--num-devices", str(WORLD)],
             "eval_series_argv": argv["eval_series"] + ["--num-devices", str(WORLD)],
             "unet_argv": UNET_ARGV + ["--num-devices", str(WORLD)]}
    torch.save(setup, str(tmp / "setup.pt"))
    pt_mesh.launch(workers.driver_checks, (str(tmp / "setup.pt"), str(tmp)),
                   num_devices=WORLD, device="cpu", timeout=GROUP_TIMEOUT_S,
                   join_timeout=JOIN_TIMEOUT_S)
    ranks = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return tmp, one, ranks


@pytest.mark.parametrize("name", list(ACC_RUNS))
def test_accuracy_predictor_driver_picks_equal_one_process(case, name):
    """Two rounds of the two-headed loop on 2 ranks (training, validation,
    selection sharded by scoring batch): every rank returns the same
    history, rank 0 writes the run, and its selections.txt files are the
    one-process run's byte for byte."""
    tmp, one, ranks = case
    dataset = ACC_RUNS[name][0]
    got = selections(str(tmp / "runs_ranks"), dataset, name)
    assert got == selections(str(tmp / "runs_one"), dataset, name)
    lines = [v.decode().splitlines() for v in got.values()]
    assert len(lines) == 2 and lines[1][:5] == lines[0] and lines[1] != lines[0]
    if dataset.endswith("_image"):
        assert [len(x) for x in lines] == [5, 8]
    history = ranks[0]["accuracy"][name]
    assert history == ranks[1]["accuracy"][name]
    assert sorted(history) == sorted(one["accuracy"][name])
    assert all(np.isfinite(list(m.values())).all() for m in history.values())


def test_visualize_on_two_ranks_equals_one_rank(case):
    """The replayed metrics equal one rank's (confusions summed exactly),
    on both ranks; rank 0 wrote the PNGs of every rank's rows, byte-equal
    to the one-rank replay's, the pad rows left out."""
    tmp, one, ranks = case
    ref = one["visualize"]
    for r in ranks:
        m = r["visualize"]
        assert {k: m[k] for k in m if k != "loss"} == {k: ref[k] for k in ref if k != "loss"}
        assert m["loss"] == pytest.approx(ref["loss"], rel=1e-6)
    folders = [tmp / name / constants.VISUALIZATIONS_FOLDER
               for name in ("replay_one", "replay_ranks")]
    names = sorted(os.listdir(folders[0]))
    assert names == sorted(f"{kind}_0000_{i:02d}.png" for kind in ("img", "tgt", "prd")
                           for i in range(4))
    assert sorted(os.listdir(folders[1])) == names
    for name in names:
        assert (folders[1] / name).read_bytes() == (folders[0] / name).read_bytes()


def test_eval_series_on_two_ranks_equals_one_rank(case):
    """The dual-head series over the accuracy predictor's rounds: every
    rank returns the one-rank series (the error head's confusion summed
    exactly too); rank 0's validation_mIoUs.txt is the one-rank file."""
    tmp, one, ranks = case
    ref = one["eval_series"]
    assert len(ref) == 2
    for r in ranks:
        assert sorted(r["eval_series"]) == sorted(ref)
        for pct, m in r["eval_series"].items():
            assert {k: m[k] for k in m if k != "loss"} == {
                k: ref[pct][k] for k in ref[pct] if k != "loss"}
            assert m["loss"] == pytest.approx(ref[pct]["loss"], rel=1e-6)
            assert "UNetAcc" in m
    files = [(tmp / name / "experiment" / "validation_mIoUs.txt").read_bytes()
             for name in ("replay_one", "replay_ranks")]
    assert files[0] == files[1] and len(files[0].splitlines()) == 2


def test_unet_train_on_two_ranks_equals_one_process(case):
    """5 epochs of the SEM trainer (f64), batch 2 (one row per rank),
    through a batch-1 validation (rank 1 holds a pad row), on two ranks:
    the printed losses and accuracies equal one process's within 1e-4
    relative, on both ranks."""
    _, one, ranks = case
    ref = one["unet"]
    assert len(ref) == 5 and ref[-1][3] is not None and ref[0][3] is None
    for r in ranks:
        got = r["unet"]
        assert [row[0] for row in got] == [row[0] for row in ref]
        for row, ref_row in zip(got, ref):
            for x, y in zip(row[1:], ref_row[1:]):
                assert (x is None) == (y is None)
                if y is not None:
                    assert abs(x - y) <= 1e-4 * abs(y), (row, ref_row)


def test_jax_unet_eval_step_refuses_a_one_row_batch_on_two_devices():
    """The JAX SEM trainer's fault (ROADMAP C): its validation loader has
    batch 1 (unet_train.py:52), and its eval step on make_mesh(2) shards
    the batch over the devices, so ``unet_train.py --num-devices 2`` raises
    ValueError at its first validation (epoch 5). The port's Loader gives
    rank 1 a pad row instead (test_unet_train_on_two_ranks_equals_one_process)."""
    params, stats = unet_state_dict_to_flax(
        {k: v.numpy() for k, v in PtUNet(1, 2).state_dict().items()})
    state = jx_steps.TrainState(params=params, batch_stats=stats, opt_state=None,
                                step=jnp.zeros((), jnp.int32))
    step = jx_steps.make_eval_step(JaxUNet(in_channels=1, num_classes=2), 2,
                                   mesh=jx_make_mesh(WORLD))
    batch = {"image": jnp.zeros((1, 16, 16, 1)), "label": jnp.zeros((1, 16, 16))}
    with pytest.raises(ValueError, match="divisible by 2"):
        step(state, batch, np.float32(1))
    jax.block_until_ready(step(state, {k: jnp.concatenate([v, v]) for k, v in batch.items()},
                               np.float32(2))["loss"])
