"""The port's CEAL selection against the JAX package's: the softmax
entropy, confidence and margin maps, the per-image scores and weak labels
of one deterministic forward on converted weights, every ranker's pick,
the fusion from one `random` state, and the weak labels served by the
image pool."""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.data import pools as pt_pools
from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
from deep_active_semantic_segmentation_torch.ops import entropy as pt_ent
from deep_active_semantic_segmentation_torch.selection import (
    ActiveSelectionCEAL, ModelBundle, get_active_selection_class)
from deep_active_semantic_segmentation_torch.selection import kernels as pt_kernels
from deep_active_semantic_segmentation_torch.selection.base import (
    rank_ascending as pt_rank_ascending)
from deep_active_semantic_segmentation_tpu.data import pools as jx_pools
from deep_active_semantic_segmentation_tpu.data.loader import (
    PathsLoader as JxPathsLoader)
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JxDirectoryStore)
from deep_active_semantic_segmentation_tpu.ops import entropy as jx_ent
from deep_active_semantic_segmentation_tpu.selection import kernels as jx_kernels
from deep_active_semantic_segmentation_tpu.selection.base import (
    ModelBundle as JxModelBundle)
from deep_active_semantic_segmentation_tpu.selection.base import (
    rank_ascending as jx_rank_ascending)
from deep_active_semantic_segmentation_tpu.selection.ceal import (
    ActiveSelectionCEAL as JxActiveSelectionCEAL)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, jax_deeplab, one_torch_thread, port_deeplab, write_pool)

CROP = 33
BATCH = 4
POOL = 9
# the maps from identical logits, and the per-image scores from the two
# packages' forwards of the same weights (whose logits agree to ~1e-5)
MAP_ATOL = 1e-5
# weak labels must agree wherever the JAX logits' top-2 gap exceeds this
WEAK_GAP = 1e-3
MODES = ("confidence", "margin", "entropy")


@pytest.mark.parametrize("fn", ["softmax_entropy", "max_confidence", "margin"])
def test_softmax_maps_equal_jax(fn):
    rng = np.random.RandomState(3)
    logits = (3 * rng.randn(2, 11, 13, NUM_CLASSES)).astype(np.float32)
    logits[0, 0, 0, :2] = 5.0                       # a two-way tie
    labels = rng.randint(0, NUM_CLASSES, (2, 11, 13)).astype(np.uint8)
    labels[:, :3] = 255
    got = getattr(pt_ent, fn)(torch.from_numpy(logits).permute(0, 3, 1, 2),
                              torch.from_numpy(labels), NUM_CLASSES).numpy()
    ref = np.asarray(getattr(jx_ent, fn)(jnp.asarray(logits), jnp.asarray(labels),
                                         NUM_CLASSES))
    assert got.dtype == np.float32 and got.shape == ref.shape == (2, 11, 13)
    np.testing.assert_allclose(got, ref, rtol=0, atol=MAP_ATOL)
    ignored = 0.0 if fn == "softmax_entropy" else 1.0
    assert (got[:, :3] == ignored).all()


def test_rank_ascending_matches_jax_on_ties():
    scores = [0.3, 0.1, 0.3, 0.1, 0.2, np.float32(0.1)]
    images = [f"p{i}".encode() for i in range(6)]
    for k in (1, 3, 6):
        assert pt_rank_ascending(scores, images, k) == jx_rank_ascending(
            scores, images, k)


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A 9-image pool, JAX DeepLab weights and the port's model holding
    them, and both packages' CEAL selectors over it."""
    root = str(tmp_path_factory.mktemp("ceal"))
    keys = write_pool(DirectoryStore(root, readonly=False), POOL, seed=6)
    jmodel, params, stats = jax_deeplab(seed=2)
    model = port_deeplab(params, stats)
    port = ActiveSelectionCEAL(NUM_CLASSES, DirectoryStore(root), CROP, BATCH,
                               device="cpu")
    jax_sel = JxActiveSelectionCEAL(NUM_CLASSES, JxDirectoryStore(root), CROP,
                                    BATCH)
    return dict(root=root, keys=keys, port=port, jax=jax_sel,
                bundle=ModelBundle(model, torch.device("cpu")),
                jbundle=JxModelBundle(jmodel, params, stats))


def _batch(scored):
    loader = JxPathsLoader(JxDirectoryStore(scored["root"]), scored["keys"][:BATCH],
                           CROP, BATCH, include_labels=True, device_normalize=True,
                           labels_as_mask=NUM_CLASSES)
    return next(iter(loader))


@pytest.mark.parametrize("mode", MODES)
def test_per_image_scores_equal_jax(scored, mode):
    batch = _batch(scored)
    got = pt_kernels.softmax_score_per_image(
        scored["bundle"].model, torch.from_numpy(batch["image"]),
        torch.from_numpy(batch["label"]), NUM_CLASSES, mode,
        labels_packed=True).numpy()
    jb = scored["jbundle"]
    ref = np.asarray(jx_kernels.softmax_score_per_image(
        jb.model, jb.variables, jnp.asarray(batch["image"]),
        jnp.asarray(batch["label"]), NUM_CLASSES, mode, labels_packed=True))
    assert got.shape == ref.shape == (BATCH,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=MAP_ATOL)


def test_weak_label_predictions_equal_jax(scored):
    batch = _batch(scored)
    got = pt_kernels.weak_label_predictions(
        scored["bundle"].model, torch.from_numpy(batch["image"]),
        torch.from_numpy(batch["label"]), NUM_CLASSES, labels_packed=True).numpy()
    jb = scored["jbundle"]
    ref = np.asarray(jx_kernels.weak_label_predictions(
        jb.model, jb.variables, jnp.asarray(batch["image"]),
        jnp.asarray(batch["label"]), NUM_CLASSES, labels_packed=True))
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    logits = np.asarray(jb.model.apply(
        jb.variables, jx_kernels.normalize_on_device(jnp.asarray(batch["image"])),
        train=False))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > WEAK_GAP
    np.testing.assert_array_equal(got[decided], ref[decided])
    assert decided.mean() > 0.99
    invalid = ~np.unpackbits(batch["label"], axis=-1)[..., :CROP].astype(bool)
    assert (got[invalid] == 255).all() and (got[~invalid] < NUM_CLASSES).all()


def test_every_ranker_picks_what_jax_picks(scored):
    port, jax_sel = scored["port"], scored["jax"]
    b, jb, keys = scored["bundle"], scored["jbundle"], scored["keys"]
    for k in (1, 3, 5):
        assert (port.get_least_confident_samples(b, keys, k)
                == jax_sel.get_least_confident_samples(jb, keys, k))
        assert (port.get_least_margin_samples(b, keys, k)
                == jax_sel.get_least_margin_samples(jb, keys, k))
    got, got_ent = port.get_maximum_entropy_samples(b, keys, 3)
    ref, ref_ent = jax_sel.get_maximum_entropy_samples(jb, keys, 3)
    assert got == ref
    np.testing.assert_allclose(got_ent, ref_ent, rtol=0, atol=MAP_ATOL)


def test_fusion_equals_jax_from_one_random_state(scored):
    """One process, so `set` iterates the same paths in the same order in
    both packages; the port shuffles with the Random it is given, the JAX
    package with the module-level one, both seeded alike."""
    port, jax_sel = scored["port"], scored["jax"]
    b, jb, keys = scored["bundle"], scored["jbundle"], scored["keys"]
    for seed in (0, 1):
        got = port.get_fusion_of_confidence_margin_entropy_samples(
            b, keys, 4, rng=random.Random(seed))
        random.seed(seed)
        ref = jax_sel.get_fusion_of_confidence_margin_entropy_samples(jb, keys, 4)
        assert got == ref and len(set(got)) == 4


def test_weak_labels_equal_jax(scored):
    port, jax_sel = scored["port"], scored["jax"]
    b, jb, keys = scored["bundle"], scored["jbundle"], scored["keys"]
    entropies = port.get_maximum_entropy_samples(b, keys, 1)[1]
    threshold = float(np.median(entropies))     # about half the pool
    got = port.get_weakly_labeled_data(b, keys, threshold, entropies)
    ref = jax_sel.get_weakly_labeled_data(jb, keys, threshold, entropies)
    assert list(got) == list(ref) and 0 < len(got) < POOL
    for path in got:
        assert got[path].dtype == np.uint8 and got[path].shape == (CROP, CROP)
        assert (got[path] == ref[path]).mean() > 0.99
    # without entropies the selector scores the pool itself
    assert list(port.get_weakly_labeled_data(b, keys, threshold)) == list(got)


def test_factory_gives_the_ceal_selector_for_every_ceal_mode(scored):
    for mode in ("ceal_confidence", "ceal_margin", "ceal_entropy", "ceal_fusion",
                 "ceal_entropy_weakly_labeled"):
        sel = get_active_selection_class(mode, NUM_CLASSES,
                                         DirectoryStore(scored["root"]), CROP,
                                         BATCH, device="cpu")
        assert isinstance(sel, ActiveSelectionCEAL)


def test_deterministic_scorers_restore_the_tf32_flags(scored):
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with pt_kernels._deterministic_precision():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    model = scored["bundle"].model.train()
    batch = _batch(scored)
    try:
        with pytest.raises(ValueError, match="eval mode"):
            pt_kernels.softmax_score_per_image(
                model, torch.from_numpy(batch["image"]),
                torch.from_numpy(batch["label"]), NUM_CLASSES, "entropy",
                labels_packed=True)
    finally:
        model.eval()


# ----------------------------------------------------------- weak labels, pool

@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("weak"))
    store_dir = os.path.join(root, "train")
    keys = write_pool(DirectoryStore(store_dir, readonly=False), 8, seed=8)
    seed_dir = os.path.join(root, "seed_sets")
    os.makedirs(seed_dir)
    with open(os.path.join(seed_dir, "set_0.txt"), "w") as f:
        f.writelines(k.decode() + "\n" for k in keys[:4])
    return store_dir, seed_dir


def test_weak_labels_served_past_the_labeled_range_as_in_jax(seeded):
    """JAX tests/test_data_layer.py:81 on both pools, byte for byte."""
    store_dir, seed_dir = seeded
    args = (CROP, CROP, "train", "set_0.txt", seed_dir)
    jp = jx_pools.ActiveImagePool(jx_pools.CITYSCAPES, JxDirectoryStore(store_dir),
                                  *args, device_normalize=True)
    pp = pt_pools.ActiveImagePool(pt_pools.CITYSCAPES, DirectoryStore(store_dir),
                                  *args, rng=random.Random(1))
    rng = np.random.RandomState(0)
    weak = {p: rng.randint(0, 256, (CROP, CROP)).astype(np.uint8)
            for p in pp.remaining_image_paths[:3]}
    for pool in (jp, pp):
        pool.add_weak_labels(dict(weak))
    assert len(pp) == len(jp) == 7
    assert pp.weakly_labeled_image_paths == list(weak)
    for pool in (jp, pp):
        pool.make_dataset_multiple_of_batchsize(3)
    # labeled 4 -> 6, weak 3 -> 3
    assert len(pp) == len(jp) == 9
    assert pp.current_image_paths == jp.current_image_paths
    assert pp.weakly_labeled_image_paths == jp.weakly_labeled_image_paths
    random.seed(1)
    for i in range(len(pp)):
        a, b = pp.get_item(i), jp.get_item(i)
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype == np.uint8
            np.testing.assert_array_equal(a[k], b[k])
        if i >= 6:
            np.testing.assert_array_equal(a["label"], weak[pp.weakly_labeled_image_paths[i - 6]])
    for pool in (jp, pp):
        pool.reset_dataset()
    assert len(pp) == len(jp) == 7
    for pool in (jp, pp):
        pool.clear_weak_labels()
    assert len(pp) == len(jp) == 4 and pp.weakly_labeled_targets == {}
