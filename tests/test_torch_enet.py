"""The port's ENet and its MC-dropout scoring against the JAX package's,
with the weights carried across by flax_to_enet_state_dict.

Tolerances: pool values, pool selectors and unpooled planes are copies of
input values, so they are exact. The dropout-off forward is held to
max |port - jax| <= 1e-4 * max |jax|: both run f32 on the CPU, the
convolutions sum in other orders (oneDNN vs XLA) and BN folds its scale
differently. The MC entropy is held to the JAX package's seed-to-seed
band, since the two samplers cannot share a random stream."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_active_semantic_segmentation_torch.data.loader import (
    PathsLoader as PortPathsLoader)
from deep_active_semantic_segmentation_torch.data.store import (
    DirectoryStore as PortDirectoryStore)
from deep_active_semantic_segmentation_torch.models import enet as pt_enet
from deep_active_semantic_segmentation_torch.models.convert import (
    flax_to_enet_state_dict)
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
from deep_active_semantic_segmentation_tpu.models import enet as jx_enet
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    enet_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.selection import kernels as jx_kernels
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, jax_enet, one_torch_thread, port_enet, write_pool)

REL_TOL = 1e-4
CROP = 64
BATCH = 4
MC_STEPS = 8
FACTORY = dict(encoder_relu=True, decoder_relu=True)   # JAX factory.py:35-37
CONFIGS = {"factory": FACTORY, "prelu": {}}            # {}: class defaults


@pytest.fixture(scope="module")
def pairs():
    """config name -> (flax ENet, params, batch_stats, port ENet)."""
    out = {}
    for seed, (name, relu) in enumerate(CONFIGS.items()):
        model, params, stats = jax_enet(seed, **relu)
        out[name] = (model, params, stats, port_enet(params, stats, **relu))
    return out


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _collisions(selector: np.ndarray) -> int:
    """Unpool target cells written by more than one window (NHWC)."""
    B, h, w, C = selector.shape
    counts = np.zeros((B, 2 * h + 1, 2 * w + 1, C), np.int32)
    for d in range(9):
        dr, dc = divmod(d, 3)
        hit = (selector == d).astype(np.int32)
        counts[:, dr:dr + 2 * h:2, dc:dc + 2 * w:2] += hit
    return int((counts > 1).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_and_unpool_equal_jax_with_ties_and_collisions(seed):
    rng = np.random.RandomState(seed)
    # integer levels: most windows hold tied maxima, and adjacent windows
    # often pick the cell they share
    x = rng.randint(0, 3, (2, 16, 22, 5)).astype(np.float32)
    jp, jk = jx_enet.max_pool_with_indices(jnp.asarray(x))
    pp, pk = pt_enet.max_pool_with_indices(_nchw(x))
    np.testing.assert_array_equal(_nhwc(pp), np.asarray(jp))
    np.testing.assert_array_equal(_nhwc(pk), np.asarray(jk))
    assert _collisions(np.asarray(jk)) > 10

    # unpool distinct values, with the pool's selector and with a random
    # one (collisions everywhere)
    vals = rng.randn(*jp.shape).astype(np.float32)
    rand_sel = rng.randint(0, 9, jp.shape).astype(np.int8)
    for sel in (np.asarray(jk), rand_sel):
        ref = np.asarray(jx_enet.max_unpool2x(jnp.asarray(vals), jnp.asarray(sel)))
        got = pt_enet.max_unpool2x(_nchw(vals), _nchw(sel))
        np.testing.assert_array_equal(_nhwc(got), ref)
    assert _collisions(rand_sel) > 10
    # torch's own unpool of the pool's flat indices agrees wherever at most
    # one window writes (its order at collisions is its own)
    pooled, flat = F.max_pool2d(_nchw(x), 3, 2, 1, return_indices=True)
    torch_up = F.max_unpool2d(_nchw(vals), flat, 2, output_size=x.shape[1:3])
    ours = pt_enet.max_unpool2x(_nchw(vals), pk)
    writers = torch.zeros(flat.shape[:2] + (x.shape[1] * x.shape[2],))
    writers.scatter_add_(2, flat.flatten(2), torch.ones(flat.flatten(2).shape))
    single = writers.reshape(torch_up.shape) <= 1
    assert torch.equal(torch_up[single], ours[single])

    with pytest.raises(ValueError, match="even input sizes"):
        pt_enet.max_pool_with_indices(torch.zeros(1, 2, 6, 7))


def test_parameter_count_and_state_dict_round_trip_exact(pairs):
    _, params, stats, port = pairs["factory"]
    jax_count = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == jax_count
    sd = flax_to_enet_state_dict(params, stats)
    assert set(sd) == set(port.state_dict())
    for key in ("initial_block.main_branch.weight", "regular1_1.ext_conv1.0.weight",
                "regular1_1.ext_conv1.1.running_var",
                "asymmetric2_3.ext_conv2.3.weight", "asymmetric3_6.ext_conv2.4.bias",
                "upsample4_0.main_conv1.1.weight", "upsample4_0.ext_conv2.0.weight",
                "transposed_conv.weight"):
        assert key in sd, key
    assert sd["transposed_conv.weight"].shape == (16, NUM_CLASSES, 3, 3)
    back_p, back_s = enet_state_dict_to_flax(
        {k: v.numpy() for k, v in port.state_dict().items()})
    for a, b in ((params, back_p), (stats, back_s)):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    # the PReLU slopes ride under the port's own keys
    _, params, stats, port = pairs["prelu"]
    sd = flax_to_enet_state_dict(params, stats)
    assert sd["regular1_1.act.weight"].item() == float(
        params["regular1_1"]["act"]["negative_slope"])
    assert "initial_block.out_act.weight" in sd and "regular5_1.act.weight" not in sd


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_dropout_off_forward_matches_jax(pairs, config):
    model, params, stats, port = pairs[config]
    x = np.random.RandomState(7).randn(2, CROP, CROP, 3).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    apply = jax.jit(partial(model.apply, train=False),
                    static_argnames=("upsample_logits", "prefix_only"))
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), apply(variables, x))
        feats = port(_nchw(x), upsample_logits=False)
        assert feats.shape == (2, 16, CROP // 2, CROP // 2)
        _close(_nhwc(feats), apply(variables, x, upsample_logits=False))
        main, sel, ext = port(_nchw(x), prefix_only=True)
        jm, js, je = apply(variables, x, prefix_only=True)
        _close(_nhwc(main), jm)
        np.testing.assert_array_equal(_nhwc(sel), np.asarray(js))
        _close(_nhwc(ext), je)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_hoisted_mc_forward_equals_monolithic(pairs, config):
    *_, port = pairs[config]
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 3, 32, 32)
                         .astype(np.float32))
    with torch.no_grad():
        prefix = port(x, prefix_only=True)
        for upsample in (True, False):
            mono = port(x, use_dropout=True, upsample_logits=upsample,
                        generator=torch.Generator().manual_seed(7))
            hoisted = port(x, use_dropout=True, upsample_logits=upsample,
                           prefix_features=prefix,
                           generator=torch.Generator().manual_seed(7))
            assert torch.equal(mono, hoisted)
        # and dropout really acts: another draw gives other features
        other = port(x, use_dropout=True, upsample_logits=False,
                     prefix_features=prefix,
                     generator=torch.Generator().manual_seed(8))
        assert not torch.equal(mono, other)
        with pytest.raises(ValueError, match="Generator"):
            port(x, use_dropout=True)


@pytest.fixture(scope="module")
def scored_pool(tmp_path_factory, pairs):
    """One 8-image pool scored by the JAX package over 4 MC seeds and by
    the port, with the same ENet weights (factory config): per-image mean
    vote entropy."""
    jmodel, params, stats, port = pairs["factory"]
    root = str(tmp_path_factory.mktemp("enet_pool"))
    keys = write_pool(PortDirectoryStore(root, readonly=False), 8, seed=2)
    variables = {"params": params, "batch_stats": stats}

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
    top = sel.get_vote_entropy_for_images(
        ModelBundle(port, torch.device("cpu")), keys, 5, seed=4)
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


def _first_batch(root, keys):
    return next(iter(PortPathsLoader(PortDirectoryStore(root), keys, CROP, BATCH,
                                     include_labels=True,
                                     labels_as_mask=NUM_CLASSES)))


def test_fused_and_unfused_mc_paths_agree(scored_pool):
    """Same generator state -> same dropout masks; votes may differ only
    at near-tie pixels (the bar of the DeepLab test in test_torch_scoring.py)."""
    root, keys, port, _, _ = scored_pool
    b = _first_batch(root, keys)
    maps = [pt_kernels.mc_vote_entropy_maps(
        port, torch.from_numpy(b["image"]), torch.from_numpy(b["label"]),
        pt_kernels.mc_generator(0, 0, "cpu"), NUM_CLASSES, MC_STEPS,
        "dropout", fused_upsample=fused, labels_packed=True).numpy()
        for fused in (True, False)]
    assert np.mean(np.abs(maps[0] - maps[1])) < 0.02
    assert (maps[0] == maps[1]).mean() > 0.98


def test_bf16_mc_scoring_casts_prelu_too(scored_pool, pairs):
    """compute_dtype='bfloat16' scores on a cast copy, PReLU slopes
    included; the caller's model stays f32 and the maps come back f32."""
    root, keys, _, _, _ = scored_pool
    *_, port = pairs["prelu"]
    b = _first_batch(root, keys)
    maps = pt_kernels.mc_vote_entropy_maps(
        port, torch.from_numpy(b["image"]), torch.from_numpy(b["label"]),
        pt_kernels.mc_generator(0, 0, "cpu"), NUM_CLASSES, 2, "dropout",
        fused_upsample=True, compute_dtype="bfloat16", labels_packed=True)
    assert maps.dtype == torch.float32 and torch.isfinite(maps).all()
    assert port.regular1_1.act.weight.dtype == torch.float32
    assert pt_kernels.cast_for_mc(port, "bfloat16").regular1_1.act.weight.dtype \
        == torch.bfloat16
