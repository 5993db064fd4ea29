"""The port's core-set and max-subset slice against the JAX package's: the
feature taps, the two greedy selections and the selectors built on them,
with the same weights and the same numpy inputs.

Tolerances: pooled and raw features element for element, in the JAX
package's NHWC order, to 1e-5 of the largest |feature| (both run f32 on
the CPU and the convolutions sum in other orders; with these random
weights the features reach 19 for DeepLab and 1.6e4 for ENet, where 1e-5
absolute is below f32's own spacing, and the measured gaps are 6.7e-6 and
3e-7 of the largest). The greedy picks are held to the identical order:
on the same f32 features they are the same arithmetic, ties included
(first occurrence, chosen candidates masked with inf), and the selectors'
features differ by far less than any gap between two candidates' scores."""

import contextlib
import os

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
from deep_active_semantic_segmentation_torch.ops import distance as pt_distance
from deep_active_semantic_segmentation_torch.selection import (
    ModelBundle, get_active_selection_class, get_max_subset_active_selector)
from deep_active_semantic_segmentation_torch.selection import kernels as pt_kernels
from deep_active_semantic_segmentation_tpu import config as jx_config
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JaxDirectoryStore)
from deep_active_semantic_segmentation_tpu.engine.active_loop import (
    run_active_loop as jx_run_active_loop)
from deep_active_semantic_segmentation_tpu.ops import distance as jx_distance
from deep_active_semantic_segmentation_tpu.selection import (
    get_active_selection_class as jx_get_active_selection_class)
from deep_active_semantic_segmentation_tpu.selection import (
    get_max_subset_active_selector as jx_get_max_subset_active_selector)
from deep_active_semantic_segmentation_tpu.selection import kernels as jx_kernels
from deep_active_semantic_segmentation_tpu.selection.base import (
    ModelBundle as JaxModelBundle)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, jax_deeplab, jax_enet, one_torch_thread, port_deeplab,
    port_enet, select_with_shared_weights, selections, write_dataset, write_pool)

CROP = {"deeplab": 33, "enet": 32}
BATCH = 3
FEATURE_TOL = 1e-5


def _close(got, want):
    """Element for element within FEATURE_TOL of the largest |feature|."""
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= FEATURE_TOL * scale, (err, scale)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coreset_pool"))
    return root, write_pool(PortDirectoryStore(root, readonly=False), 8, seed=6)


@pytest.fixture(scope="module")
def models():
    out = {}
    jm, params, stats = jax_deeplab(seed=5)
    out["deeplab"] = (JaxModelBundle(jm, params, stats),
                      ModelBundle(port_deeplab(params, stats), torch.device("cpu")))
    jm, params, stats = jax_enet(seed=6, encoder_relu=True, decoder_relu=True)
    out["enet"] = (JaxModelBundle(jm, params, stats),
                   ModelBundle(port_enet(params, stats, encoder_relu=True,
                                         decoder_relu=True), torch.device("cpu")))
    return out


# deeplab at crop 33: a 9 x 9 decoder map; enet at crop 32: a 4 x 4 stage-3
# map. (64, 32) and (32, 16) are the selectors' pools, clamped to the map;
# (4, 2) windows overlap inside it.
@pytest.mark.parametrize("arch,pool_ks", [("deeplab", (64, 32)), ("deeplab", (4, 2)),
                                          ("enet", (32, 16)), ("enet", (3, 1))])
def test_feature_taps_equal_jax(pool, models, arch, pool_ks):
    root, keys = pool
    jb, pb = models[arch]
    batch = next(iter(PortPathsLoader(PortDirectoryStore(root), keys, CROP[arch],
                                      BATCH)))
    image = batch["image"]
    got = pt_kernels.pooled_features(pb.model, torch.from_numpy(image), *pool_ks)
    want = np.asarray(jx_kernels.pooled_features(jb.model, jb.variables,
                                                 jnp.asarray(image), *pool_ks))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want)
    raw = pt_kernels.raw_features(pb.model, torch.from_numpy(image))
    want_raw = np.asarray(jx_kernels.raw_features(jb.model, jb.variables,
                                                  jnp.asarray(image)))
    assert raw.shape == want_raw.shape
    _close(raw.numpy(), want_raw)


def _features(seed, n, d, duplicates=()):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    for dst, src in duplicates:
        x[dst] = x[src]
    return x


@pytest.mark.parametrize("n_seeds,duplicates", [
    (0, ()), (5, ()), (3, ((7, 20), (21, 20), (30, 2))), (0, ((9, 4), (4, 9)))])
def test_kcenter_greedy_pick_order_equals_jax(n_seeds, duplicates):
    x = _features(n_seeds + 11, 40, 16, duplicates)
    mask = np.zeros(40, bool)
    mask[:n_seeds] = True
    got = pt_distance.kcenter_greedy(torch.from_numpy(x), torch.from_numpy(mask), 12)
    want = np.asarray(jx_distance.kcenter_greedy(jnp.asarray(x), jnp.asarray(mask), 12))
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    if n_seeds == 0:
        assert got[0] == 0                     # every distance inf: index 0
    assert not set(got.tolist()) & set(range(n_seeds))
    # an exact duplicate of a center sits at distance 0 and is never picked
    # after it; the first of two equal candidates wins


@pytest.mark.parametrize("duplicates", [(), ((3, 11), (12, 11)), ((0, 5), (5, 0))])
def test_max_representative_pick_order_equals_jax(duplicates):
    pool = _features(1, 60, 8)
    cand = _features(2, 20, 8, duplicates)
    got = pt_distance.max_representative(torch.from_numpy(pool),
                                         torch.from_numpy(cand), 10)
    want = np.asarray(jx_distance.max_representative(jnp.asarray(pool),
                                                     jnp.asarray(cand), 10))
    assert got.tolist() == want.tolist() and len(set(got.tolist())) == 10
    np.testing.assert_allclose(
        pt_distance.pairwise_euclidean(torch.from_numpy(pool),
                                       torch.from_numpy(cand)).numpy(),
        np.asarray(jx_distance.pairwise_euclidean(jnp.asarray(pool),
                                                  jnp.asarray(cand))),
        rtol=0, atol=1e-5)


# ------------------------------------------- the process's float32 precision

def _clustered(rng, n, d, clusters=16):
    """Non-negative clustered rows, as decoder features are (the canonical
    greedy's recipe in chip_smoke.py)."""
    centers = rng.rand(clusters, d) * 2
    rows = centers[rng.randint(0, clusters, n)] + rng.randn(n, d)
    return np.maximum(rows, 0).astype(np.float32)


def _kcenter_f64(x, mask, k):
    x = x.astype(np.float64)
    sq = (x * x).sum(1)
    min_d = np.sqrt(np.maximum(sq[:, None] + sq[None, mask] - 2 * x @ x[mask].T,
                               0)).min(1)
    min_d[mask] = 0
    picks = []
    for _ in range(k):
        picks.append(int(min_d.argmax()))
        min_d = np.minimum(min_d, np.sqrt(np.maximum(
            sq + sq[picks[-1]] - 2 * x @ x[picks[-1]], 0)))
    return picks


def _max_representative_f64(pool, cand, k):
    pool, cand = pool.astype(np.float64), cand.astype(np.float64)
    d = np.sqrt(np.maximum((pool * pool).sum(1)[:, None]
                           + (cand * cand).sum(1)[None] - 2 * pool @ cand.T, 0))
    min_d, chosen, picks = np.full(len(pool), np.inf), np.zeros(len(cand), bool), []
    for _ in range(k):
        scores = np.minimum(min_d[:, None], d).sum(0)
        scores[chosen] = np.inf
        picks.append(int(scores.argmin()))
        chosen[picks[-1]] = True
        min_d = np.minimum(min_d, d[:, picks[-1]])
    return picks


def _precision_settings():
    b = torch.backends
    return (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cuda.matmul.fp32_precision,
            b.mkldnn.matmul.fp32_precision, b.mkldnn.conv.fp32_precision,
            b.fp32_precision, torch.is_autocast_enabled("cpu"))


@contextlib.contextmanager
def _reduced_precision(state):
    """The process left at a reduced float32 precision, as an earlier
    caller may leave it: CPU autocast to bf16 (thread-local), oneDNN's
    float32 matmuls in bf16, or the legacy 'medium' matmul precision
    (oneDNN bf16, cuBLAS TF32). Every setting is put back afterwards."""
    b = torch.backends
    saved = _precision_settings()
    try:
        if state == "cpu_autocast_bf16":
            with torch.autocast("cpu", dtype=torch.bfloat16):
                yield
            return
        if state == "onednn_matmul_bf16":
            b.mkldnn.matmul.fp32_precision = "bf16"
        else:
            torch.set_float32_matmul_precision("medium")
        yield
    finally:
        b.fp32_precision = saved[5]
        b.mkldnn.matmul.fp32_precision, b.mkldnn.conv.fp32_precision = saved[3:5]
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved[:2]
        b.cuda.matmul.fp32_precision = saved[2]
        assert _precision_settings() == saved


@pytest.mark.parametrize("greedy", ["kcenter", "max_representative"])
@pytest.mark.parametrize("state", ["cpu_autocast_bf16", "onednn_matmul_bf16",
                                   "float32_matmul_precision_medium"])
def test_greedy_picks_stay_the_f64_greedys_under_a_reduced_precision(state, greedy):
    """The selectors run both greedy selections under
    ``kernels._deterministic_precision``, which pins full float32 for the
    CPU too: oneDNN's matmuls and convs at IEEE float32 and autocast off.
    Whatever precision an earlier caller left the process at, the picks
    are the f64 greedy's, and the scope puts every setting back. Under
    CPU autocast the same call outside the scope parts from the f64
    greedy within a few picks (a bf16 matmul, ~4e-3 relative; an f32 one
    is ~2e-7), the split ROADMAP C1 records on the card's host: held here
    as the cause the scope repairs."""
    rng = np.random.RandomState(0)
    if greedy == "kcenter":
        x = _clustered(rng, 400, 2736)
        mask = np.zeros(400, bool)
        mask[rng.permutation(400)[:20]] = True
        want = _kcenter_f64(x, mask, 40)
        args = (torch.from_numpy(x), torch.from_numpy(mask), 40)
    else:
        pool, cand = _clustered(rng, 1500, 304), _clustered(rng, 120, 304)
        want = _max_representative_f64(pool, cand, 30)
        args = (torch.from_numpy(pool), torch.from_numpy(cand), 30)
    fn = getattr(pt_distance, f"{greedy}_greedy" if greedy == "kcenter" else greedy)
    assert fn(*args).tolist() == want                    # full f32
    with _reduced_precision(state):
        before = _precision_settings()
        unpinned = fn(*args).tolist()
        with pt_kernels._deterministic_precision():
            pinned = fn(*args).tolist()
        assert _precision_settings() == before
    assert pinned == want
    if state == "cpu_autocast_bf16":
        assert unpinned != want


@pytest.mark.parametrize("arch", ["deeplab", "enet"])
def test_kcenter_selector_picks_equal_jax(pool, models, arch):
    root, keys = pool
    jb, pb = models[arch]
    got = get_active_selection_class("coreset", NUM_CLASSES, PortDirectoryStore(root),
                                     CROP[arch], BATCH, device="cpu") \
        .get_k_center_greedy_selections(3, pb, keys[3:], keys[:3])
    want = jx_get_active_selection_class("coreset", NUM_CLASSES,
                                         JaxDirectoryStore(root), CROP[arch], BATCH) \
        .get_k_center_greedy_selections(3, jb, keys[3:], keys[:3])
    assert got == want and len(set(got)) == 3 and not set(got) & set(keys[:3])


def test_representative_images_and_regions_equal_jax(pool, models):
    root, keys = pool
    jb, pb = models["deeplab"]
    port = get_max_subset_active_selector(PortDirectoryStore(root), CROP["deeplab"],
                                          BATCH, device="cpu")
    ref = jx_get_max_subset_active_selector(JaxDirectoryStore(root), CROP["deeplab"],
                                            BATCH)
    candidates = [keys[i] for i in (6, 1, 4, 7, 2, 5)]
    got = port.get_representative_images(pb, keys, candidates)
    assert got == ref.get_representative_images(jb, keys, candidates)
    assert len(got) == 3 and set(got) <= set(candidates)
    # region 9 at crop 33 on a 9 x 9 map: 2 x 2 tiles (4 x 4 per image);
    # boxes at the border, overlapping, and one smaller than a map cell
    regions = {keys[0]: [(0, 0, 9, 9), (24, 24, 9, 9)],
               keys[5]: [(3, 12, 9, 9), (4, 13, 9, 9), (20, 1, 2, 3)],
               keys[2]: [(10, 10, 9, 9)], keys[7]: [(0, 24, 9, 9)]}
    got, count = port.get_representative_regions(pb, keys, regions, 9)
    want, want_count = ref.get_representative_regions(jb, keys, regions, 9)
    assert (got, count) == (want, want_count) and count == 3
    assert list(got) == list(want)


# variance_representative doubles the request (config.finalize): asked for
# 2, its MC stage ranks 4 candidates and max-subset keeps 2. With 12 of
# the 16 images labeled the MC stage returns all 4 remaining, so the pick
# does not depend on the MC draws and both packages must agree.
LOOP_ARGV = ["--dataset", "active_cityscapes_image", "--backbone", "mobilenet",
             "--lr", "0.01", "--use-lr-scheduler", "--workers", "0",
             "--no-early-stop", "--base-size", "33", "--crop-size", "33",
             "--batch-size", "2", "--epochs", "1", "--max-iterations", "2",
             "--seed", "3", "--dtype", "float32"]


@pytest.mark.parametrize("mode,seed_set,k,grow", [
    ("coreset", "set_0.txt", 3, 3), ("variance_representative", "set_12.txt", 2, 2)])
def test_loop_writes_the_jax_selections(tmp_path, models, monkeypatch, mode,
                                        seed_set, k, grow):
    """One round of each mode through both packages' loops, both
    selecting with one set of weights (the port's loop trains for real):
    the same selections.txt, byte for byte."""
    root = str(tmp_path / "data")
    write_dataset(root, seed_sets=(("set_0.txt", 5), ("set_12.txt", 12)))
    select_with_shared_weights(monkeypatch, models["deeplab"][0].params,
                               models["deeplab"][0].batch_stats)
    argv = LOOP_ARGV + ["--checkname", mode, "--active-selection-mode", mode,
                        "--active-batch-size", str(k), "--seed_set", seed_set]
    pt_run_active_loop(pt_config.parse_cli(argv).finalize(), dataset_root=root,
                       runs_root=str(tmp_path / "port"), device="cpu")
    jx_run_active_loop(jx_config.parse_cli(argv).finalize(n_devices=1), mesh=None,
                       dataset_root=root, runs_root=str(tmp_path / "jax"))
    got = selections(str(tmp_path / "port"), "active_cityscapes_image", mode)
    assert got == selections(str(tmp_path / "jax"), "active_cityscapes_image", mode)
    lines = [v.decode().splitlines() for v in got.values()]
    assert len(lines) == 2 and lines[1][:len(lines[0])] == lines[0]
    assert len(lines[1]) == len(lines[0]) + grow == len(set(lines[1]))
