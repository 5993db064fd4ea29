"""The port's MC-noise slice against the JAX package's: the feature-noise
hook, the noisy DeepLab and ENet forwards and the three MC-noise scorers
(``noise_image``, ``noise_feature``, ``noise_variance``), with the same
weights and the same numpy inputs.

Tolerances: the noise scale |mean(x)| * factor to 1e-6 relative of the
JAX formula summed in f64 (XLA's f32 mean of the toy batch is itself
1.2e-6 off it, and is held to 1e-5); the noisy output equal to
x + sigma * z exactly for z redrawn from the same generator state. The
noise itself cannot share a random stream across the packages, so the
forwards and the scorers are held in distribution: the port's mean
per-image entropy sits within the JAX package's own seed-to-seed band
(the mean gap to the JAX mean over 4 seeds at most the mean spread of
those 4 seeds, as the MC-dropout parity tests hold it)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch import config as pt_config
from deep_active_semantic_segmentation_torch import constants as pt_constants
from deep_active_semantic_segmentation_torch.data.loader import (
    PathsLoader as PortPathsLoader)
from deep_active_semantic_segmentation_torch.data.store import (
    DirectoryStore as PortDirectoryStore)
from deep_active_semantic_segmentation_torch.engine.active_loop import (
    run_active_loop as pt_run_active_loop)
from deep_active_semantic_segmentation_torch.models.layers import (
    feature_noise, noise_scale)
from deep_active_semantic_segmentation_torch.ops.entropy import (
    mean_over_pixels, softmax_entropy)
from deep_active_semantic_segmentation_torch.selection import (
    ModelBundle, get_active_selection_class)
from deep_active_semantic_segmentation_torch.selection import kernels as pt_kernels
from deep_active_semantic_segmentation_torch.selection.base import (
    collect_scores, rank_descending)
from deep_active_semantic_segmentation_tpu.data.loader import (
    PathsLoader as JaxPathsLoader)
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JaxDirectoryStore)
from deep_active_semantic_segmentation_tpu.selection import kernels as jx_kernels
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, jax_deeplab, jax_enet, one_torch_thread, port_deeplab,
    port_enet, select_with_shared_weights, selections, write_dataset, write_pool)

CROP = {"deeplab": 33, "enet": 32}   # ENet's unpool needs an even size
BATCH = 4
MC_STEPS = 8
JAX_SEEDS = 4
SCALE_RTOL = 1e-6


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """7 images: batches of 4 and 3, the second padded with a duplicate."""
    root = str(tmp_path_factory.mktemp("noise_pool"))
    return root, write_pool(PortDirectoryStore(root, readonly=False), 7, seed=4)


@pytest.fixture(scope="module")
def models():
    """arch -> (flax module, variables, port model), the same weights."""
    out = {}
    jm, params, stats = jax_deeplab(seed=2)
    out["deeplab"] = (jm, {"params": params, "batch_stats": stats},
                      port_deeplab(params, stats))
    jm, params, stats = jax_enet(seed=3, encoder_relu=True, decoder_relu=True)
    out["enet"] = (jm, {"params": params, "batch_stats": stats},
                   port_enet(params, stats, encoder_relu=True, decoder_relu=True))
    return out


def _batches(root, keys, crop, packed=True):
    mask = NUM_CLASSES if packed else None
    port = list(PortPathsLoader(PortDirectoryStore(root), keys, crop, BATCH,
                                include_labels=True, labels_as_mask=mask))
    ref = list(JaxPathsLoader(JaxDirectoryStore(root), keys, crop, BATCH,
                              include_labels=True, device_normalize=True,
                              labels_as_mask=mask))
    return port, ref


def _within_band(jax_scores, port_scores):
    jax_scores, port_scores = np.asarray(jax_scores), np.asarray(port_scores)
    assert np.isfinite(port_scores).all() and (port_scores > 0).all()
    spread = jax_scores.max(axis=0) - jax_scores.min(axis=0)
    gap = np.abs(port_scores - jax_scores.mean(axis=0))
    assert gap.mean() <= spread.mean(), (gap, spread)


def test_feature_noise_scale_equals_jax_on_a_padded_batch(pool):
    root, keys = pool
    port, ref = _batches(root, keys[:3], CROP["deeplab"])
    assert port[0]["nvalid"] == 3                    # one padded duplicate
    x = pt_kernels.normalize_on_device(torch.from_numpy(port[0]["image"]))
    jx = jx_kernels.normalize_on_device(jnp.asarray(ref[0]["image"]))
    for factor in (0.05, 0.5):
        got = noise_scale(x, factor).item()
        # JAX's formula on JAX's input, summed in f64: XLA's own f32 mean
        # of these 13068 values is 1.2e-6 off the exact one, torch's 1.1e-7
        want = abs(np.asarray(jx, np.float64).mean()) * factor
        assert abs(got - want) <= SCALE_RTOL * want, (got, want)
        jax_f32 = float(jnp.abs(jnp.mean(jx)) * factor)
        assert abs(jax_f32 - want) <= 10 * SCALE_RTOL * want, (jax_f32, want)
        # the scale is the whole padded batch's, in both packages
        assert got != noise_scale(x[:3], factor).item()
        assert want != float(jnp.abs(jnp.mean(jx[:3])) * factor)
    out = feature_noise(x, 0.5, torch.Generator().manual_seed(7))
    z = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    assert torch.equal(out, x + noise_scale(x, 0.5) * z)
    # a bf16 forward forms the mean in f32
    xb = x.bfloat16()
    assert noise_scale(xb, 0.5).dtype == torch.float32
    assert noise_scale(xb, 0.5).item() == (xb.float().mean().abs() * 0.5).item()
    assert feature_noise(xb, 0.5, torch.Generator().manual_seed(7)).dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["deeplab", "enet"])
def test_noisy_forward_entropy_within_jax_seed_to_seed_band(pool, models, arch):
    """Mean per-image softmax entropy of one noisy forward (the noise-free
    forward's is another)."""
    root, keys = pool
    jm, variables, port = models[arch]
    port_b, ref_b = _batches(root, keys[:BATCH], CROP[arch], packed=False)
    image = torch.from_numpy(port_b[0]["image"])
    label = torch.from_numpy(port_b[0]["label"])
    x = pt_kernels.normalize_on_device(image)
    jx = jx_kernels.normalize_on_device(jnp.asarray(ref_b[0]["image"]))

    def entropy(logits):
        return mean_over_pixels(softmax_entropy(logits, label, NUM_CLASSES)).numpy()

    apply = jax.jit(lambda v, im, key: jm.apply(
        v, im, train=False, noisy_features=True, rngs={"noise": key}))
    jax_scores = [entropy(torch.from_numpy(np.asarray(
        apply(variables, jx, jax.random.PRNGKey(s))).transpose(0, 3, 1, 2).copy()))
        for s in range(JAX_SEEDS)]
    with torch.no_grad():
        noisy = port(x, noisy_features=True,
                     generator=torch.Generator().manual_seed(0))
        clean = port(x)
    _within_band(jax_scores, entropy(noisy))
    assert not np.array_equal(entropy(noisy), entropy(clean))
    with pytest.raises(ValueError, match="Generator"):
        port(x, noisy_features=True)
    if arch == "deeplab":
        with pytest.raises(ValueError, match="hoist"):
            port(x, noisy_features=True, backbone_only=True,
                 generator=torch.Generator())


def _jax_sweep(jm, variables, batch, key, mode):
    maps = jx_kernels.mc_vote_entropy_maps(
        jm, variables, jnp.asarray(batch["image"]), jnp.asarray(batch["label"]),
        key, NUM_CLASSES, MC_STEPS, mode, fused_upsample=True, labels_packed=True)
    return np.asarray(jnp.mean(maps, axis=(1, 2)))[:batch["nvalid"]]


SCORERS = {
    "noise_image": (("input",),
                    "get_vote_entropy_for_images_with_input_noise"),
    "noise_feature": (("feature",),
                      "get_vote_entropy_for_images_with_feature_noise"),
    "noise_variance": (("feature", "dropout"),
                       "get_vote_entropy_for_batch_with_noise_and_vote_entropy"),
}


@pytest.mark.parametrize("mode", list(SCORERS))
def test_mc_noise_scorer_within_jax_seed_to_seed_band(pool, models, monkeypatch,
                                                      mode):
    """The JAX sweeps as the JAX selector keys them (fold_in(key, i); the
    combined scorer 2i for feature noise and 2i + 1 for dropout) over 4
    seeds, against the port selector's scores; the port's entry point
    ranks its own scores."""
    root, keys = pool
    jm, variables, port = models["deeplab"]
    sweeps, entry = SCORERS[mode]
    _, ref = _batches(root, keys, CROP["deeplab"])
    jax_scores = []
    for seed in range(JAX_SEEDS):
        rng = jax.random.PRNGKey(seed)
        scores = []
        for i, b in enumerate(ref):
            scores.extend(sum(
                _jax_sweep(jm, variables, b,
                           jax.random.fold_in(rng, len(sweeps) * i + j), m)
                for j, m in enumerate(sweeps)))
        jax_scores.append(scores)

    monkeypatch.setattr(pt_constants, "MC_STEPS", MC_STEPS)
    sel = get_active_selection_class(mode, NUM_CLASSES, PortDirectoryStore(root),
                                     CROP["deeplab"], BATCH, device="cpu")
    bundle = ModelBundle(port, torch.device("cpu"))
    scorer = sel._scorer(bundle, 5, sweeps)
    port_scores = collect_scores(
        sel._paths_loader(keys, include_labels=True, labels_as_mask=NUM_CLASSES),
        lambda b: mean_over_pixels(scorer(b)))
    _within_band(jax_scores, port_scores)
    top = getattr(sel, entry)(bundle, keys, 4, seed=5)
    assert top == rank_descending(port_scores, keys, 4) and len(set(top)) == 4


@pytest.mark.parametrize("arch", ["deeplab", "enet"])
@pytest.mark.parametrize("noise_mode", ["input", "feature"])
def test_noise_sweep_fused_and_unfused_share_the_draws(pool, models, arch,
                                                       noise_mode):
    """Same generator state -> the same noise whatever the vote tail: with
    the kernels' plain versions the fused sweep equals the unfused one but
    at near-tie pixels (the MC-dropout bar); the model is left in eval
    mode and f32."""
    root, keys = pool
    port = models[arch][2]
    b, _ = _batches(root, keys[:BATCH], CROP[arch])
    maps = [pt_kernels.mc_vote_entropy_maps(
        port, torch.from_numpy(b[0]["image"]), torch.from_numpy(b[0]["label"]),
        pt_kernels.mc_generator(0, 0, "cpu"), NUM_CLASSES, MC_STEPS, noise_mode,
        fused_upsample=fused, labels_packed=True).numpy() for fused in (True, False)]
    assert maps[0].shape == (BATCH, CROP[arch], CROP[arch])
    assert np.mean(np.abs(maps[0] - maps[1])) < 0.02
    assert (maps[0] == maps[1]).mean() > 0.98
    assert maps[0].max() > 0
    assert not port.training and next(port.parameters()).dtype == torch.float32


LOOP_ARGV = ["--backbone", "mobilenet", "--lr", "0.01", "--use-lr-scheduler",
             "--workers", "0", "--no-early-stop", "--base-size", "33",
             "--crop-size", "33", "--batch-size", "2", "--epochs", "1",
             "--active-batch-size", "3", "--max-iterations", "2", "--seed", "3",
             "--dtype", "float32"]
REGION = 9


@pytest.mark.parametrize("mode,dataset", [
    ("noise_image", "active_cityscapes_image"),
    ("noise_feature", "active_cityscapes_image"),
    ("noise_variance", "active_cityscapes_image"),
    ("noise_variance", "active_cityscapes_region")])
def test_noise_loop_picks_what_its_selector_picks(tmp_path, models, monkeypatch,
                                                  mode, dataset):
    """One round of each mode through the port's loop (trained for real,
    the selection on a fixed set of weights): round 1's new images, or
    boxes, are the selector's own on those weights with the loop's seed."""
    jb_model, variables, _ = models["deeplab"]
    params, stats = variables["params"], variables["batch_stats"]
    root = str(tmp_path / "data")
    write_dataset(root)
    select_with_shared_weights(monkeypatch, params, stats)
    monkeypatch.setattr(pt_constants, "MC_STEPS", MC_STEPS)
    argv = LOOP_ARGV + ["--dataset", dataset, "--active-selection-mode", mode,
                        "--checkname", "n", "--active-region-size", str(REGION)]
    pt_run_active_loop(pt_config.parse_cli(argv).finalize(), dataset_root=root,
                       runs_root=str(tmp_path / "runs"), device="cpu")
    lines = [v.decode().splitlines() for v in
             selections(str(tmp_path / "runs"), dataset, "n").values()]
    assert len(lines) == 2 and lines[1][:5] == lines[0]
    train = PortDirectoryStore(os.path.join(root, "cityscapes", "train"))
    images = list(train.keys())
    sel = get_active_selection_class(mode, NUM_CLASSES, train, 33, 2, device="cpu")
    bundle = ModelBundle(port_deeplab(params, stats), torch.device("cpu"))
    if dataset.endswith("_image"):
        remaining = [p for p in images if p.decode() not in set(lines[0])]
        top = getattr(sel, SCORERS[mode][1])(bundle, remaining, 3, seed=3)
        assert [p.encode() for p in lines[1][5:]] == top
        return
    seeded = [line.split(",")[0].encode() for line in lines[0]]
    assert lines[0] == [f"{p.decode()},0,0,33,33" for p in seeded]
    existing = [[(0, 0, 33, 33)] if p in seeded else [] for p in images]
    regions, count = sel.create_region_maps(bundle, images, existing, REGION, 3,
                                            seed=3)
    assert 1 <= count <= -(-3 * 33 ** 2 // REGION ** 2)
    expected = {p: [(0, 0, 33, 33)] for p in seeded}
    for path, boxes in regions.items():
        expected.setdefault(path, []).extend(boxes)
    assert lines[1] == [",".join([p.decode()] + [str(v) for b in boxes for v in b])
                        for p, boxes in expected.items()]
