"""The port's FastSCNN against the JAX package's, with the weights carried
across by flax_to_fastscnn_state_dict: the weight mapping (a reference
``state_dict`` with its never-called ``classifier.sconv2`` loads), the
forward, one f32 train step, and the MC sweep, which votes unfused.

Tolerances: the forward to max |port - jax| <= 1e-4 * max |jax| (the
DeepLab bar of test_torch_models.py); the step's loss to 1e-4 relative
and its weights to 1e-4 of the largest weight (the first-step bars of
test_torch_train.py)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.models import fastscnn as pt_fastscnn
from deep_active_semantic_segmentation_torch.models.convert import (
    flax_to_fastscnn_state_dict)
from deep_active_semantic_segmentation_torch.models.factory import param_groups
from deep_active_semantic_segmentation_torch.ops import losses as pt_losses
from deep_active_semantic_segmentation_torch.ops import lr_schedule as pt_sched
from deep_active_semantic_segmentation_torch.ops import upsample_argmax as ua
from deep_active_semantic_segmentation_torch.parallel import optim as pt_optim
from deep_active_semantic_segmentation_torch.parallel.steps import make_train_step
from deep_active_semantic_segmentation_torch.selection import kernels as pt_kernels
from deep_active_semantic_segmentation_tpu.models.fastscnn import FastSCNN as JaxFastSCNN
from deep_active_semantic_segmentation_tpu.models.factory import lr_multiplier_tree
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    fastscnn_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.ops import losses as jx_losses
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.selection.kernels import (
    normalize_on_device as jx_normalize)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, draw_like, one_torch_thread)

SIDE = 64
REL_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    model = JaxFastSCNN(num_classes=NUM_CLASSES)
    shapes = jax.eval_shape(partial(model.init, train=False),
                            {"params": jax.random.PRNGKey(0)},
                            jax.ShapeDtypeStruct((1, SIDE, SIDE, 3), jnp.float32))
    rng = np.random.RandomState(0)
    params = draw_like(shapes["params"], rng)
    stats = draw_like(shapes["batch_stats"], rng)
    port = pt_fastscnn.FastSCNN(NUM_CLASSES)
    port.load_state_dict(flax_to_fastscnn_state_dict(params, stats))
    return model, params, stats, port.eval()


def _images(seed, n=2):
    return np.random.RandomState(seed).randint(0, 256, (n, SIDE, SIDE, 3)).astype(np.uint8)


def test_weight_mapping_round_trips_and_reference_keys_load(pair):
    _, params, stats, port = pair
    jax_count = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == jax_count
    sd = flax_to_fastscnn_state_dict(params, stats)
    assert set(sd) == set(port.state_dict())
    back_p, back_s = fastscnn_state_dict_to_flax({k: v.numpy() for k, v in sd.items()})
    for ref, got in ((params, back_p), (stats, back_s)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, ref)
    # a reference state_dict carries the unused classifier.sconv2
    ref_sd = dict(sd)
    ref_sd["classifier.sconv2.conv1.weight"] = torch.zeros(128, 1, 3, 3)
    ref_sd["classifier.sconv2.bn.weight"] = torch.ones(128)
    model = pt_fastscnn.FastSCNN(NUM_CLASSES)
    pt_fastscnn.load_reference_state_dict(model, ref_sd)
    with pytest.raises(RuntimeError, match="sconv2"):
        model.load_state_dict(ref_sd)


def test_forward_matches_jax(pair):
    jmodel, params, stats, port = pair
    x = jx_normalize(jnp.asarray(_images(1)))
    ref = np.asarray(jmodel.apply({"params": params, "batch_stats": stats}, x,
                                  train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= REL_TOL * np.abs(ref).max()
    # the adaptive pools' bin edges are torch's
    t = torch.randn(1, 4, 17, 11)
    for size in (1, 2, 3, 6):
        np.testing.assert_allclose(
            pt_fastscnn._AdaptiveAvgPool(size)(t).numpy(),
            torch.nn.functional.adaptive_avg_pool2d(t, size).numpy(),
            rtol=1e-6, atol=1e-6)
    # sizes whose 1/8 and 4x-upsampled 1/32 maps do not meet are refused
    with torch.no_grad(), pytest.raises(ValueError, match="--crop-size 512"):
        port(torch.zeros(1, 3, 65, 64))


def test_one_f32_train_step_matches_jax(pair):
    """SGD at lr 1e-3, every parameter at 1x, BN at running statistics."""
    jmodel, params, stats, _ = pair
    img = _images(2)
    lab = np.random.RandomState(3).randint(0, NUM_CLASSES, img.shape[:3]).astype(np.uint8)
    lab[:, :5] = 255
    loss_fn = jx_losses.build_loss("ce")

    def compute(p):
        out = jmodel.apply({"params": p, "batch_stats": stats},
                           jx_normalize(jnp.asarray(img)), train=False)
        return loss_fn(out, jnp.asarray(lab.astype(np.float32)))

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jloss, grads = jax.jit(jax.value_and_grad(compute))(jp)
    new_params, _ = jx_optim.apply_update(
        "SGD", jp, grads, jx_optim.init_opt_state(jp, "SGD"), jnp.float32(1e-3),
        lr_multiplier_tree(params, "fastscnn"), jx_optim.SGDConfig(0.9, 5e-4, False))

    model = pt_fastscnn.FastSCNN(NUM_CLASSES)
    model.load_state_dict(flax_to_fastscnn_state_dict(params, stats))
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    groups = param_groups(model, "fastscnn")
    assert [g["lr_mult"] for g in groups] == [1.0]
    step = make_train_step(model, pt_optim.build_optimizer("SGD", groups),
                           pt_losses.build_loss("ce"), pt_sched.constant_schedule(1e-3))
    out = step({"image": torch.from_numpy(img), "label": torch.from_numpy(lab)}, 0)
    assert abs(float(out["loss"]) - float(jloss)) <= 1e-4 * abs(float(jloss))
    want = flax_to_fastscnn_state_dict(jax.tree_util.tree_map(np.asarray, new_params),
                                       stats)
    sd = model.state_dict()
    scale = max(float(v.abs().max()) for v in want.values() if v.is_floating_point())
    err = max(float((sd[k] - v).abs().max()) for k, v in want.items()
              if v.is_floating_point())
    assert err <= 1e-4 * scale, (err, scale)


def test_mc_sweep_votes_unfused(pair, monkeypatch):
    """FastSCNN has no dropout or noise site: the dropout and feature
    sweeps vote 20 equal maps (entropy 0), input noise moves the votes;
    B1 is never asked, whatever the geometry."""
    _, _, _, port = pair
    monkeypatch.setattr(ua, "upsample4_argmax",
                        lambda *a, **kw: pytest.fail("FastSCNN voted through B1"))
    img = torch.from_numpy(_images(4))
    lab = torch.zeros(img.shape[:3], dtype=torch.uint8)
    for mode, moves in (("dropout", False), ("feature", False), ("input", True)):
        maps = pt_kernels.mc_vote_entropy_maps(
            port, img, lab, torch.Generator().manual_seed(0), NUM_CLASSES, 5,
            mode, fused_upsample=True)
        assert maps.shape == (2, SIDE, SIDE) and torch.isfinite(maps).all()
        assert bool((maps > 0).any()) == moves, mode
