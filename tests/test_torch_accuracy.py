"""The port's oracle modes against the JAX package's: the misprediction
counts and the ``accuracy_labels`` ranking on the same weights and numpy
inputs, the ``accuracy_labels`` loop (the same selections.txt as the JAX
loop when both select with one set of weights), and the ``accuracy_eval``
twin of the JAX package's tests/test_end_to_end.py
::test_active_loop_accuracy_eval_twin: a port producer loop, a port
consumer that replays its selections.txt round by round, and a JAX
consumer on the same producer files writing the same bytes.

Tolerances: counts are integers and must be equal; rankings and files
identical."""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch import config as pt_config
from deep_active_semantic_segmentation_torch.data.loader import (
    PathsLoader as PortPathsLoader)
from deep_active_semantic_segmentation_torch.data.store import (
    DirectoryStore as PortDirectoryStore)
from deep_active_semantic_segmentation_torch.engine.active_loop import (
    run_active_loop as pt_run_active_loop)
from deep_active_semantic_segmentation_torch.selection import (
    ModelBundle, get_active_selection_class)
from deep_active_semantic_segmentation_torch.selection import kernels as pt_kernels
from deep_active_semantic_segmentation_tpu import config as jx_config
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JaxDirectoryStore)
from deep_active_semantic_segmentation_tpu.engine.active_loop import (
    run_active_loop as jx_run_active_loop)
from deep_active_semantic_segmentation_tpu.selection import (
    get_active_selection_class as jx_get_active_selection_class)
from deep_active_semantic_segmentation_tpu.selection import kernels as jx_kernels
from deep_active_semantic_segmentation_tpu.selection.base import (
    ModelBundle as JaxModelBundle)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, jax_deeplab, one_torch_thread, port_deeplab,
    select_with_shared_weights, selections, write_dataset)

SIDE = 33
BATCH = 3
# the canonical experiment's flags (test_scripts/cs_experiments_*.sh) at
# toy geometry
ARGV = ["--dataset", "active_cityscapes_image", "--backbone", "mobilenet",
        "--lr", "0.01", "--use-lr-scheduler", "--use-balanced-weights",
        "--workers", "0", "--no-early-stop", "--base-size", str(SIDE),
        "--crop-size", str(SIDE), "--batch-size", "2", "--epochs", "1",
        "--active-batch-size", "3", "--seed", "3", "--dtype", "float32"]


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    keys = write_dataset(root)
    return root, keys


@pytest.fixture(scope="module")
def weights():
    """(flax DeepLab, params, batch_stats)."""
    return jax_deeplab(seed=7)


def test_misprediction_counts_and_ranking_equal_jax(dataset_root, weights):
    root, keys = dataset_root
    train = os.path.join(root, "cityscapes", "train")
    jm, params, stats = weights
    port = port_deeplab(params, stats)
    batch = next(iter(PortPathsLoader(PortDirectoryStore(train), keys, SIDE, 4,
                                      include_labels=True)))
    got = pt_kernels.misprediction_counts(port, torch.from_numpy(batch["image"]),
                                          torch.from_numpy(batch["label"]),
                                          NUM_CLASSES)
    want = np.asarray(jx_kernels.misprediction_counts(
        jm, {"params": params, "batch_stats": stats}, jnp.asarray(batch["image"]),
        jnp.asarray(batch["label"]), NUM_CLASSES))
    assert got.dtype == torch.float32 and got.tolist() == want.tolist()
    # a recount from the argmax of the same forward
    with torch.no_grad():
        pred = port(pt_kernels.normalize_on_device(
            torch.from_numpy(batch["image"]))).argmax(1).numpy()
    label = batch["label"].astype(np.int64)
    assert got.tolist() == ((label < NUM_CLASSES) & (pred != label)).sum((1, 2)).tolist()

    top = get_active_selection_class("accuracy_labels", NUM_CLASSES,
                                     PortDirectoryStore(train), SIDE, BATCH,
                                     device="cpu") \
        .get_least_accurate_sample_using_labels(
            ModelBundle(port, torch.device("cpu")), keys, 7)
    assert top == jx_get_active_selection_class(
        "accuracy_labels", NUM_CLASSES, JaxDirectoryStore(train), SIDE, BATCH) \
        .get_least_accurate_sample_using_labels(JaxModelBundle(jm, params, stats),
                                                keys, 7)


def test_accuracy_labels_loop_writes_the_jax_selections(dataset_root, weights,
                                                       tmp_path, monkeypatch):
    root, _ = dataset_root
    select_with_shared_weights(monkeypatch, *weights[1:])
    argv = ARGV + ["--checkname", "lab", "--active-selection-mode",
                   "accuracy_labels", "--max-iterations", "2"]
    pt_run_active_loop(pt_config.parse_cli(argv).finalize(), dataset_root=root,
                       runs_root=str(tmp_path / "port"), device="cpu")
    jx_run_active_loop(jx_config.parse_cli(argv).finalize(n_devices=1), mesh=None,
                       dataset_root=root, runs_root=str(tmp_path / "jax"))
    got = selections(str(tmp_path / "port"), "active_cityscapes_image", "lab")
    assert got == selections(str(tmp_path / "jax"), "active_cityscapes_image", "lab")
    lines = [v.decode().splitlines() for v in got.values()]
    assert [len(x) for x in lines] == [5, 8] and lines[1][:5] == lines[0]


def test_accuracy_eval_consumer_replays_the_producer(dataset_root, weights,
                                                     tmp_path, monkeypatch):
    """Producer: a 3-round `random` port loop. Consumer: `accuracy_eval`
    watching it, in the port and in the JAX package, on the same files."""
    root, _ = dataset_root
    runs = str(tmp_path / "runs")
    base = ARGV + ["--max-iterations", "3"]
    pt_run_active_loop(pt_config.parse_cli(
        base + ["--checkname", "producer", "--active-selection-mode", "random"]
    ).finalize(), dataset_root=root, runs_root=runs, device="cpu")
    consumer = base + ["--active-selection-mode", "accuracy_eval",
                       "--monitor-directory", "producer"]
    history = pt_run_active_loop(pt_config.parse_cli(
        consumer + ["--checkname", "consumer"]).finalize(),
        dataset_root=root, runs_root=runs, device="cpu")
    assert len(history) == 3
    produced = selections(runs, "active_cityscapes_image", "producer")
    consumed = selections(runs, "active_cityscapes_image", "consumer")
    assert list(produced) == list(consumed) and len(produced) == 3
    for d in produced:    # round by round, the producer's set in its order
        assert consumed[d] == produced[d], d

    select_with_shared_weights(monkeypatch, *weights[1:])
    jx_run_active_loop(jx_config.parse_cli(
        consumer + ["--checkname", "jax_consumer"]).finalize(n_devices=1),
        mesh=None, dataset_root=root, runs_root=runs)
    assert selections(runs, "active_cityscapes_image", "jax_consumer") == consumed


def test_wait_for_selected_samples_polls_and_times_out(tmp_path):
    sel = get_active_selection_class("accuracy_eval", NUM_CLASSES,
                                     PortDirectoryStore(str(tmp_path), readonly=False),
                                     SIDE, BATCH, device="cpu")
    path = str(tmp_path / "run_0050" / "selections.txt")
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        sel.wait_for_selected_samples(path, [b"a"], poll_seconds=0.01, timeout=0.05)
    assert time.perf_counter() - t0 < 5
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        f.write("c\na\n\nb\nz\n")
    assert sel.wait_for_selected_samples(path, [b"a", b"b", b"c"],
                                         poll_seconds=0.01) == [b"c", b"a", b"b"]


def test_accuracy_predictor_scorers_name_their_item(dataset_root):
    """The accuracy-predictor scorers are ported (ROADMAP A13b, done): on a
    two-headed model each ranks the pool by its kernel's scores, and the
    region maps return boxes of the requested size. Their parity with the
    JAX package is held in test_torch_accuracy_driver.py."""
    from deep_active_semantic_segmentation_torch.models.factory import build_model

    root, keys = dataset_root
    keys = keys[:5]
    store = PortDirectoryStore(os.path.join(root, "cityscapes", "train"))
    sel = get_active_selection_class("accuracy_labels", NUM_CLASSES, store, SIDE,
                                     BATCH, device="cpu")
    model = build_model("accuracy_predictor", NUM_CLASSES, backbone="mobilenet",
                        device="cpu")
    bundle = ModelBundle(model, torch.device("cpu"))
    batches = list(sel._paths_loader(keys, include_labels=True,
                                     labels_as_mask=NUM_CLASSES))

    def ranked(score):
        scores = [v for b in batches for v in score(b)[:b["nvalid"]].tolist()]
        return [keys[i] for i in np.argsort(-np.asarray(scores), kind="stable")[:2]]

    kw = dict(num_classes=NUM_CLASSES, labels_packed=True)
    for picks, score in (
            (sel.get_least_accurate_samples(bundle, keys, 2),
             lambda b: pt_kernels.error_head_scores(model, b["image"], b["label"],
                                                    mode="softmax", **kw)),
            (sel.get_least_accurate_samples(bundle, keys, 2, "argmax"),
             lambda b: pt_kernels.error_head_scores(model, b["image"], b["label"],
                                                    mode="argmax", **kw)),
            (sel.get_unsure_samples(bundle, keys, 2),
             lambda b: pt_kernels.error_head_scores(model, b["image"], b["label"],
                                                    mode="unsure", **kw)),
            (sel.get_adversarially_vulnarable_samples(bundle, keys, 2),
             lambda b: pt_kernels.input_gradient_norms(model, b["image"], b["label"],
                                                       **kw))):
        assert picks == ranked(score)
    regions, count = sel.get_least_accurate_region_maps(bundle, keys, [[]] * 5, 9, 1)
    assert 1 <= count == sum(len(v) for v in regions.values())
    assert all(r[2:] == (9, 9) for v in regions.values() for r in v)
    with pytest.raises(NotImplementedError):
        sel.get_least_accurate_samples(bundle, keys, 2, "entropy")
