"""The port's DeepLab on ResNet-50 and ResNet-101 against the JAX
package's, with the weights carried across by flax_to_deeplab_state_dict:
the forward at output stride 16 and 8, one f32 train step, and the
MC-dropout variance query, whose votes go through B1's plain version on
the CPU.

Tolerances: the forward to max |port - jax| <= 1e-4 * max |jax| (the
DeepLab bar of test_torch_models.py); the train step's loss to 1e-4
relative and its weights to 1e-4 of the largest weight (the first-step
bars of test_torch_train.py); the MC entropies to the JAX package's
seed-to-seed band (BASELINE.md's rule: the two samplers cannot share a
random stream), and the selector's picks equal to the top of a re-score
of the same maps."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.data.loader import (
    PathsLoader as PortPathsLoader)
from deep_active_semantic_segmentation_torch.data.store import (
    DirectoryStore as PortDirectoryStore)
from deep_active_semantic_segmentation_torch.models.convert import (
    flax_to_deeplab_state_dict)
from deep_active_semantic_segmentation_torch.models.deeplab import DeepLab as PortDeepLab
from deep_active_semantic_segmentation_torch.models.factory import param_groups
from deep_active_semantic_segmentation_torch.ops import losses as pt_losses
from deep_active_semantic_segmentation_torch.ops import lr_schedule as pt_sched
from deep_active_semantic_segmentation_torch.ops.entropy import mean_over_pixels
from deep_active_semantic_segmentation_torch.parallel import optim as pt_optim
from deep_active_semantic_segmentation_torch.parallel.steps import make_train_step
from deep_active_semantic_segmentation_torch.selection import (
    ModelBundle, get_active_selection_class)
from deep_active_semantic_segmentation_torch.selection import kernels as pt_kernels
from deep_active_semantic_segmentation_torch.selection.base import (
    rank_descending as pt_rank)
from deep_active_semantic_segmentation_tpu.data.loader import (
    PathsLoader as JaxPathsLoader)
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JaxDirectoryStore)
from deep_active_semantic_segmentation_tpu.models.deeplab import DeepLab as JaxDeepLab
from deep_active_semantic_segmentation_tpu.models.factory import lr_multiplier_tree
from deep_active_semantic_segmentation_tpu.ops import losses as jx_losses
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.selection import kernels as jx_kernels
from deep_active_semantic_segmentation_tpu.selection.kernels import (
    normalize_on_device as jx_normalize)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, draw_like, one_torch_thread, write_pool)

SIDE = 33
REL_TOL = 1e-4
MC_STEPS = 6
BATCH = 3


def jax_resnet_deeplab(backbone: str, output_stride: int, seed: int):
    """(flax DeepLab, params, batch_stats): the tree's shapes from
    ``jax.eval_shape``, every leaf drawn with numpy from ``seed``."""
    model = JaxDeepLab(num_classes=NUM_CLASSES, backbone=backbone,
                       output_stride=output_stride, mc_dropout=True)
    shapes = jax.eval_shape(partial(model.init, train=False),
                            {"params": jax.random.PRNGKey(0)},
                            jax.ShapeDtypeStruct((1, SIDE, SIDE, 3), jnp.float32))
    rng = np.random.RandomState(seed)
    return (model, draw_like(shapes["params"], rng),
            draw_like(shapes["batch_stats"], rng))


def port_resnet_deeplab(params, stats, backbone: str, output_stride: int):
    model = PortDeepLab(num_classes=NUM_CLASSES, backbone=backbone,
                        output_stride=output_stride, mc_dropout=True)
    model.load_state_dict(flax_to_deeplab_state_dict(params, stats, backbone))
    return model.eval()


@pytest.fixture(scope="module")
def resnet50():
    model, params, stats = jax_resnet_deeplab("resnet", 16, seed=0)
    return model, params, stats, port_resnet_deeplab(params, stats, "resnet", 16)


def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    got = got.detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _images(seed: int, n: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, SIDE, SIDE, 3)).astype(np.uint8)


@pytest.mark.parametrize("backbone,output_stride", [
    ("resnet", 16), ("resnet", 8), ("resnet101", 16), ("resnet101", 8)])
def test_forward_matches_jax(backbone, output_stride):
    jmodel, params, stats = jax_resnet_deeplab(backbone, output_stride, seed=1)
    port = port_resnet_deeplab(params, stats, backbone, output_stride)
    blocks = {"resnet": 16, "resnet101": 33}[backbone]
    assert sum(k.endswith(".conv3.weight") for k in port.state_dict()) == blocks
    assert port.backbone.layer4[2].conv2.dilation == (
        (8, 8) if output_stride == 16 else (16, 16))   # multi-grid 4 x stage
    x = jx_normalize(jnp.asarray(_images(2)))
    ref = jmodel.apply({"params": params, "batch_stats": stats}, x, train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2))
    _close(got, ref)
    # the backbone's low-level tap is layer1's output, at 1/4
    with torch.no_grad():
        high, low = port.backbone(torch.zeros(1, 3, SIDE, SIDE), features_only=True)
    assert low.shape == (1, 256, 9, 9)
    assert high.shape[1] == 2048 and high.shape[2] == (3 if output_stride == 16 else 5)


def test_one_f32_train_step_matches_jax(resnet50):
    """SGD at lr 1e-3 with the 1x/10x groups, dropout off, BN at running
    statistics, balanced class weights: the loss and every weight after
    the step."""
    jmodel, params, stats, _ = resnet50
    cw = np.random.RandomState(4).uniform(0.5, 2.0, NUM_CLASSES).astype(np.float32)
    img = _images(5)
    lab = np.random.RandomState(6).randint(0, NUM_CLASSES, img.shape[:3]).astype(np.uint8)
    lab[:, :3] = 255
    loss_fn = jx_losses.build_loss("ce", class_weights=cw)

    def compute(p):
        out = jmodel.apply({"params": p, "batch_stats": stats},
                           jx_normalize(jnp.asarray(img)), train=False)
        return loss_fn(out, jnp.asarray(lab.astype(np.float32)))

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jloss, grads = jax.jit(jax.value_and_grad(compute))(jparams)
    new_params, _ = jx_optim.apply_update(
        "SGD", jparams, grads, jx_optim.init_opt_state(jparams, "SGD"),
        jnp.float32(1e-3), lr_multiplier_tree(params, "deeplab"),
        jx_optim.SGDConfig(0.9, 5e-4, False))

    model = port_resnet_deeplab(params, stats, "resnet", 16).train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    opt = pt_optim.build_optimizer("SGD", param_groups(model, "deeplab"))
    step = make_train_step(model, opt, pt_losses.build_loss(
        "ce", class_weights=torch.from_numpy(cw)), pt_sched.constant_schedule(1e-3))
    out = step({"image": torch.from_numpy(img), "label": torch.from_numpy(lab)}, 0)
    assert abs(float(out["loss"]) - float(jloss)) <= 1e-4 * abs(float(jloss))

    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ref = flax_to_deeplab_state_dict(jax.tree_util.tree_map(np.asarray, new_params),
                                     stats, "resnet")
    scale = max(float(v.abs().max()) for v in ref.values() if v.is_floating_point())
    err = max(float(np.abs(got[k] - v.numpy()).max()) for k, v in ref.items()
              if k in got and v.is_floating_point())
    assert err <= 1e-4 * scale, (err, scale)
    assert set(ref) <= set(got)


@pytest.fixture(scope="module")
def scored_pool(resnet50, tmp_path_factory):
    """One 6-image pool scored by the JAX package over 3 MC seeds and by
    the port, ResNet-50 DeepLab weights shared: per-image mean vote
    entropy."""
    jmodel, params, stats, port = resnet50
    root = str(tmp_path_factory.mktemp("resnet_pool"))
    keys = write_pool(PortDirectoryStore(root, readonly=False), 6, seed=3)
    variables = {"params": params, "batch_stats": stats}
    jax_batches = list(JaxPathsLoader(
        JaxDirectoryStore(root), keys, SIDE, BATCH, include_labels=True,
        device_normalize=True, labels_as_mask=NUM_CLASSES))
    jax_scores = []
    for seed in range(3):
        s = []
        for i, b in enumerate(jax_batches):
            maps = jx_kernels.mc_vote_entropy_maps(
                jmodel, variables, jnp.asarray(b["image"]), jnp.asarray(b["label"]),
                jax.random.fold_in(jax.random.PRNGKey(seed), i), NUM_CLASSES,
                MC_STEPS, "dropout", fused_upsample=True, labels_packed=True)
            s.extend(np.asarray(jnp.mean(maps, axis=(1, 2)))[:b["nvalid"]])
        jax_scores.append(s)
    port_scores = []
    for i, b in enumerate(PortPathsLoader(PortDirectoryStore(root), keys, SIDE,
                                          BATCH, include_labels=True,
                                          labels_as_mask=NUM_CLASSES)):
        maps = pt_kernels.mc_vote_entropy_maps(
            port, torch.from_numpy(b["image"]), torch.from_numpy(b["label"]),
            pt_kernels.mc_generator(0, i, "cpu"), NUM_CLASSES, MC_STEPS,
            "dropout", fused_upsample=True, labels_packed=True)
        port_scores.extend(mean_over_pixels(maps).numpy()[:b["nvalid"]])
    return root, keys, port, np.asarray(jax_scores), np.asarray(port_scores)


def test_variance_entropy_within_jax_seed_to_seed_band(scored_pool):
    *_, jax_scores, port_scores = scored_pool
    assert np.isfinite(port_scores).all() and (port_scores > 0).all()
    spread = jax_scores.max(axis=0) - jax_scores.min(axis=0)
    gap = np.abs(port_scores - jax_scores.mean(axis=0))
    assert gap.mean() <= spread.mean(), (gap, spread)


def test_variance_selector_picks_the_top_of_a_rescore(scored_pool, monkeypatch):
    """The variance selector on ResNet-50: the backbone runs once per batch
    (hoisted; it has no dropout site) and the votes go through B1 (its
    plain version here), the picks are the top of the same maps."""
    from deep_active_semantic_segmentation_torch import constants

    root, keys, port, _, scores = scored_pool
    monkeypatch.setattr(constants, "MC_STEPS", MC_STEPS)
    sel = get_active_selection_class("variance", NUM_CLASSES,
                                     PortDirectoryStore(root), SIDE, BATCH,
                                     device="cpu")
    calls = []
    backbone_forward = port.backbone.forward
    monkeypatch.setattr(port.backbone, "forward",
                        lambda *a, **kw: calls.append(kw.get("precomputed") is None)
                        or backbone_forward(*a, **kw))
    top = sel.get_vote_entropy_for_images(ModelBundle(port, torch.device("cpu")),
                                          keys, 4, seed=0)
    assert top == pt_rank(list(scores), keys, 4) and len(set(top)) == 4
    # one full backbone pass per batch; every MC step reuses it
    assert calls.count(True) == 2 and calls.count(False) == 2 * MC_STEPS
