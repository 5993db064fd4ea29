"""The port's pool-scoring slice against the JAX package's: the loader's
uint8 wire byte for byte, the ranking, and the MC-dropout vote entropy in
the JAX package's own seed-to-seed band with the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.data.loader import (
    PathsLoader as PortPathsLoader)
from deep_active_semantic_segmentation_torch.data.store import (
    DirectoryStore as PortDirectoryStore)
from deep_active_semantic_segmentation_torch.ops.entropy import mean_over_pixels
from deep_active_semantic_segmentation_torch.selection import (
    ModelBundle, get_active_selection_class)
from deep_active_semantic_segmentation_torch.selection import kernels as pt_kernels
from deep_active_semantic_segmentation_torch.selection.base import (
    rank_descending as pt_rank)
from deep_active_semantic_segmentation_tpu.data.loader import (
    PathsLoader as JaxPathsLoader)
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JaxDirectoryStore)
from deep_active_semantic_segmentation_tpu.selection import kernels as jx_kernels
from deep_active_semantic_segmentation_tpu.selection.base import (
    rank_descending as jx_rank)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, jax_deeplab, one_torch_thread, port_deeplab, write_pool)

CROP = 33
BATCH = 4
MC_STEPS = 8


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pool"))
    keys = write_pool(PortDirectoryStore(root, readonly=False), 7, seed=0)
    return root, keys


@pytest.mark.parametrize("crop,include_labels,mask", [
    (CROP, True, NUM_CLASSES), (CROP, True, None), (CROP, False, None),
    (-1, True, NUM_CLASSES)])
def test_paths_loader_batches_equal_jax_byte_for_byte(pool, crop,
                                                      include_labels, mask):
    root, keys = pool
    # 7 paths in batches of 3: the last batch is padded
    port = list(PortPathsLoader(PortDirectoryStore(root), keys, crop, 3,
                                include_labels=include_labels,
                                labels_as_mask=mask))
    ref = list(JaxPathsLoader(JaxDirectoryStore(root), keys, crop, 3,
                              include_labels=include_labels,
                              device_normalize=True, labels_as_mask=mask))
    assert len(port) == len(ref) == 3
    assert [b["nvalid"] for b in port] == [b["nvalid"] for b in ref] == [3, 3, 1]
    for a, b in zip(port, ref):
        assert a["paths"] == b["paths"]
        for k in ("image", "label") if include_labels else ("image",):
            assert a[k].dtype == b[k].dtype == np.uint8
            np.testing.assert_array_equal(a[k], b[k])


def test_selector_loader_puts_batches_on_device_in_order(pool):
    root, keys = pool
    sel = get_active_selection_class("variance", NUM_CLASSES,
                                     PortDirectoryStore(root), CROP, 3,
                                     device="cpu")
    ref = JaxPathsLoader(JaxDirectoryStore(root), keys, CROP, 3,
                         include_labels=True, device_normalize=True,
                         labels_as_mask=NUM_CLASSES)
    got = list(sel._paths_loader(keys, include_labels=True,
                                 labels_as_mask=NUM_CLASSES))
    for a, b in zip(got, ref, strict=True):
        assert isinstance(a["image"], torch.Tensor) and a["nvalid"] == b["nvalid"]
        np.testing.assert_array_equal(a["image"].numpy(), b["image"])
        np.testing.assert_array_equal(a["label"].numpy(), b["label"])


def test_rank_descending_matches_jax_on_ties():
    images = [f"img{i}".encode() for i in range(8)]
    scores = [0.5, 0.9, 0.5, 0.1, 0.9, 0.5, 0.0, 0.9]
    for k in (1, 3, 5, 8):
        assert pt_rank(scores, images, k) == jx_rank(scores, images, k)
    assert pt_rank(scores, images, 4) == [b"img1", b"img4", b"img7", b"img0"]


@pytest.fixture(scope="module")
def scored_pool(tmp_path_factory):
    """One 8-image pool scored by the JAX package over 4 MC seeds and by
    the port, with the same weights: per-image mean vote entropy."""
    root = str(tmp_path_factory.mktemp("mc_pool"))
    keys = write_pool(PortDirectoryStore(root, readonly=False), 8, seed=1)
    jmodel, params, stats = jax_deeplab(seed=1)
    variables = {"params": params, "batch_stats": stats}
    port = port_deeplab(params, stats)

    jax_batches = list(JaxPathsLoader(
        JaxDirectoryStore(root), keys, CROP, BATCH, include_labels=True,
        device_normalize=True, labels_as_mask=NUM_CLASSES))
    jax_scores = []
    for seed in range(4):
        rng = jax.random.PRNGKey(seed)
        s = []
        for i, b in enumerate(jax_batches):
            maps = jx_kernels.mc_vote_entropy_maps(
                jmodel, variables, jnp.asarray(b["image"]),
                jnp.asarray(b["label"]), jax.random.fold_in(rng, i),
                NUM_CLASSES, MC_STEPS, "dropout", fused_upsample=True,
                labels_packed=True)
            s.extend(np.asarray(jnp.mean(maps, axis=(1, 2)))[:b["nvalid"]])
        jax_scores.append(s)

    port_scores = []
    for i, b in enumerate(PortPathsLoader(
            PortDirectoryStore(root), keys, CROP, BATCH, include_labels=True,
            labels_as_mask=NUM_CLASSES)):
        maps = pt_kernels.mc_vote_entropy_maps(
            port, torch.from_numpy(b["image"]), torch.from_numpy(b["label"]),
            pt_kernels.mc_generator(0, i, "cpu"), NUM_CLASSES, MC_STEPS,
            "dropout", fused_upsample=True, labels_packed=True)
        assert maps.shape == (BATCH, CROP, CROP)
        port_scores.extend(mean_over_pixels(maps).numpy()[:b["nvalid"]])
    return root, keys, port, np.asarray(jax_scores), np.asarray(port_scores)


def test_mc_entropy_within_jax_seed_to_seed_band(scored_pool):
    *_, jax_scores, port_scores = scored_pool
    assert np.isfinite(port_scores).all() and (port_scores > 0).all()
    spread = jax_scores.max(axis=0) - jax_scores.min(axis=0)
    gap = np.abs(port_scores - jax_scores.mean(axis=0))
    # BASELINE.md's rule for holding two MC samplers against each other
    assert gap.mean() <= spread.mean(), (gap, spread)


def test_selector_ranks_by_per_batch_seeded_entropy(scored_pool, monkeypatch):
    """The entry point = the per-batch sweep with mc_generator(seed, i),
    nvalid trimming and the stable descending rank."""
    from deep_active_semantic_segmentation_torch import constants

    root, keys, port, _, _ = scored_pool
    monkeypatch.setattr(constants, "MC_STEPS", MC_STEPS)
    sel = get_active_selection_class("variance", NUM_CLASSES,
                                     PortDirectoryStore(root), CROP, 3,
                                     device="cpu")
    bundle = ModelBundle(port, torch.device("cpu"))
    top = sel.get_vote_entropy_for_images(bundle, keys, 5, seed=4)
    scores = []
    for i, b in enumerate(PortPathsLoader(
            PortDirectoryStore(root), keys, CROP, 3, include_labels=True,
            labels_as_mask=NUM_CLASSES)):
        maps = pt_kernels.mc_vote_entropy_maps(
            port, torch.from_numpy(b["image"]), torch.from_numpy(b["label"]),
            pt_kernels.mc_generator(4, i, "cpu"), NUM_CLASSES, MC_STEPS,
            "dropout", fused_upsample=True, labels_packed=True)
        scores.extend(mean_over_pixels(maps).tolist()[:b["nvalid"]])
    assert top == pt_rank(scores, keys, 5) and len(set(top)) == 5


def test_fused_and_unfused_mc_paths_agree(scored_pool):
    """Same generator state -> same dropout masks; votes may differ only
    at near-tie pixels (tests/test_pallas_kernels.py bar)."""
    root, keys, port, _, _ = scored_pool
    b = next(iter(PortPathsLoader(PortDirectoryStore(root), keys, CROP, BATCH,
                                  include_labels=True,
                                  labels_as_mask=NUM_CLASSES)))
    maps = [pt_kernels.mc_vote_entropy_maps(
        port, torch.from_numpy(b["image"]), torch.from_numpy(b["label"]),
        pt_kernels.mc_generator(0, 0, "cpu"), NUM_CLASSES, MC_STEPS,
        "dropout", fused_upsample=fused, labels_packed=True).numpy()
        for fused in (True, False)]
    assert np.mean(np.abs(maps[0] - maps[1])) < 0.02
    assert (maps[0] == maps[1]).mean() > 0.98


def test_bf16_mc_scoring_runs_with_cast_weights(scored_pool):
    """compute_dtype='bfloat16' casts weights and BN statistics (a copy;
    the caller's model is left f32) and still returns f32 entropy maps."""
    root, keys, port, _, _ = scored_pool
    b = next(iter(PortPathsLoader(PortDirectoryStore(root), keys, CROP, BATCH,
                                  include_labels=True,
                                  labels_as_mask=NUM_CLASSES)))
    maps = pt_kernels.mc_vote_entropy_maps(
        port, torch.from_numpy(b["image"]), torch.from_numpy(b["label"]),
        pt_kernels.mc_generator(0, 0, "cpu"), NUM_CLASSES, MC_STEPS,
        "dropout", fused_upsample=True, compute_dtype="bfloat16",
        labels_packed=True)
    assert maps.dtype == torch.float32 and torch.isfinite(maps).all()
    assert next(port.parameters()).dtype == torch.float32
