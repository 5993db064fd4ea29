"""The port's accuracy-predictor selection against the JAX package's, on
the same numpy inputs and converted weights: the error-head scores
(softmax, argmax, unsure) and maps, the input-gradient norms, and
``accuracy_predictor_train_torch`` against ``accuracy_predictor_train.py``
in every mode, both selecting on one set of weights; the image-only
modes' refusal on regions beside the JAX driver's AttributeError.

Tolerances: scores 1e-5 relative and maps 1e-5 absolute, their rankings
equal (measured: 1.8e-6 softmax, 1.6e-6 unsure, the argmax counts equal,
maps 4.3e-6); input-gradient norms 1e-3 relative (measured: under 5e-7
here; 1.2e-4 on one image of 8 at other drawn weights, where a ReLU whose
input rounds to the other side of 0 in one framework switches a path of
the backward off); selections.txt identical."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accuracy_predictor_train as jx_driver
import accuracy_predictor_train_torch as pt_driver
from deep_active_semantic_segmentation_torch.data.loader import PathsLoader
from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
from deep_active_semantic_segmentation_torch.models.convert import (
    flax_to_accuracy_predictor_state_dict)
from deep_active_semantic_segmentation_torch.selection import kernels as pt_kernels
from deep_active_semantic_segmentation_torch.selection.base import rank_descending
from deep_active_semantic_segmentation_tpu.selection import kernels as jx_kernels
from deep_active_semantic_segmentation_tpu.selection.base import scoring_precision
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    jax_predictor, one_torch_thread, port_predictor, select_with_shared_weights,
    selections, write_dataset)

NCLASS = 21    # Pascal VOC
SIDE = 33
BATCH = 2


@pytest.fixture(scope="module")
def weights():
    """(JAX predictor, params, batch_stats)."""
    return jax_predictor(11, NCLASS)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """The dataset root and train keys of a toy Pascal pool."""
    root = str(tmp_path_factory.mktemp("data"))
    return root, write_dataset(root, n_train=12, family="pascal")


def _mask_batches(root, keys):
    """The selectors' batches: uint8 images and the packed 1-bit mask."""
    loader = PathsLoader(DirectoryStore(os.path.join(root, "pascal", "train")), keys,
                         SIDE, BATCH, include_labels=True, labels_as_mask=NCLASS)
    return [(b["image"], b["label"], b["nvalid"]) for b in loader]


def _score_batches(root, keys, model, jmodel, variables, got, ref):
    """Both packages' scores of ``keys`` into ``got`` / ``ref`` by mode; the
    error maps compared batch by batch."""
    for img, packed, nvalid in _mask_batches(root, keys):
        ti, tl = torch.from_numpy(img), torch.from_numpy(packed)
        ji, jl = jnp.asarray(img), jnp.asarray(packed)
        for mode in ("softmax", "argmax", "unsure"):
            got.setdefault(mode, []).extend(pt_kernels.error_head_scores(
                model, ti, tl, NCLASS, mode, labels_packed=True)[:nvalid].tolist())
            ref.setdefault(mode, []).extend(np.asarray(jx_kernels.error_head_scores(
                jmodel, variables, ji, jl, NCLASS, mode, labels_packed=True))[:nvalid])
        got.setdefault("gradient", []).extend(pt_kernels.input_gradient_norms(
            model, ti, tl, NCLASS, labels_packed=True)[:nvalid].tolist())
        ref.setdefault("gradient", []).extend(np.asarray(jx_kernels.input_gradient_norms(
            jmodel, variables, ji, jl, NCLASS, labels_packed=True))[:nvalid])
        maps = pt_kernels.error_head_maps(model, ti, tl, NCLASS, labels_packed=True)
        jmaps = np.asarray(jx_kernels.error_head_maps(jmodel, variables, ji, jl, NCLASS,
                                                      labels_packed=True))
        assert maps.shape == (BATCH, SIDE, SIDE)
        assert np.abs(maps.numpy() - jmaps).max() <= 1e-5


def test_error_head_scores_maps_and_gradients_match_jax(weights, pool):
    """At the JAX selectors' default precision (the driver's
    --scoring-precision high), so the driver tests below reuse these JAX
    compiles."""
    jmodel, params, stats = weights
    variables = {"params": params, "batch_stats": stats}
    model = port_predictor(params, stats, NCLASS).eval()
    keys = pool[1][:8]
    got, ref = {}, {}
    with scoring_precision("high"):
        _score_batches(pool[0], keys, model, jmodel, variables, got, ref)
    for mode, rtol in (("softmax", 1e-5), ("argmax", 0), ("unsure", 1e-5),
                       ("gradient", 1e-3)):
        np.testing.assert_allclose(got[mode], ref[mode], rtol=rtol, err_msg=mode)
        assert (rank_descending(got[mode], keys, 4) == rank_descending(ref[mode], keys, 4))
    assert min(got["gradient"]) > 0


# ------------------------------------------------------------- the driver

ARGV = ["--backbone", "mobilenet", "--lr", "0.007", "--use-lr-scheduler",
        "--lr-scheduler", "step", "--use-balanced-weights", "--workers", "0",
        "--no-early-stop", "--base-size", str(SIDE), "--crop-size", str(SIDE),
        "--batch-size", str(BATCH), "--epochs", "1", "--active-batch-size", "3",
        "--max-iterations", "2", "--seed", "3", "--dtype", "float32",
        "--num-devices", "1"]


@pytest.mark.parametrize("dataset,mode", [
    ("active_pascal_image", "accuracy"), ("active_pascal_image", "gradient"), ("active_pascal_image", "uncertain"),
    ("active_pascal_image", "uncertain_gradient"), ("active_pascal_region", "accuracy")])
def test_driver_two_rounds_select_as_jax(weights, pool, dataset, mode, tmp_path,
                                        monkeypatch):
    """Two rounds of the port's driver on the CPU (training, validation,
    best-checkpoint reload, selection) and of the JAX driver, both selecting
    on one set of weights: the same selections.txt."""
    root = pool[0]
    _, params, stats = weights
    select_with_shared_weights(monkeypatch, params, stats,
                               flax_to_accuracy_predictor_state_dict(params, stats))
    argv = ARGV + ["--dataset", dataset, "--active-selection-mode", mode,
                   "--checkname", "acc"]
    if dataset.endswith("_region"):
        argv += ["--active-region-size", "9"]
    history = pt_driver.main(argv, device="cpu", dataset_root=root,
                             runs_root=str(tmp_path / "port"))
    assert len(history) == 2
    jx_driver.main(argv, dataset_root=root, runs_root=str(tmp_path / "jax"))
    got = selections(str(tmp_path / "port"), dataset, "acc")
    assert got == selections(str(tmp_path / "jax"), dataset, "acc")
    lines = [v.decode().splitlines() for v in got.values()]
    assert len(lines) == 2 and lines[1][:5] == lines[0]
    if dataset.endswith("_image"):
        assert [len(x) for x in lines] == [5, 8]
    else:   # new boxes, on seed images or others
        assert lines[1] != lines[0]


@pytest.mark.parametrize("mode", ["gradient", "uncertain", "uncertain_gradient"])
def test_image_only_modes_are_refused_on_regions(weights, pool, mode, tmp_path,
                                                 monkeypatch):
    """The JAX driver fails these modes on a region dataset after a whole
    round (the region pool has no remaining_image_paths); the port refuses
    them before training."""
    argv = ARGV + ["--dataset", "active_pascal_region", "--active-selection-mode",
                   mode, "--checkname", "refused"]
    with pytest.raises(NotImplementedError, match="remaining_image_paths"):
        pt_driver.main(argv, device="cpu", dataset_root=pool[0],
                       runs_root=str(tmp_path / "port"))
    assert not (tmp_path / "port").exists()
    if mode == "gradient":   # one JAX run shows the fault
        _, params, stats = weights
        select_with_shared_weights(monkeypatch, params, stats,
                                   flax_to_accuracy_predictor_state_dict(params, stats))
        with pytest.raises(AttributeError, match="remaining_image_paths"):
            jx_driver.main(argv, dataset_root=pool[0], runs_root=str(tmp_path / "jax"))
