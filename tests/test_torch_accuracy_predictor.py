"""The port's accuracy predictor against the JAX package's, on the same
numpy inputs and converted weights: the two-headed forward (UNet and
symmetric error heads), the weight mapping, the learning-rate groups, the
dual train step (a deterministic trajectory, one step at w_dl = 0), the
dual eval step, the two-headed panel and the driver's weight schedules.
Its scorers, selectors and driver are in test_torch_accuracy_driver.py.

Tolerances: logits within 1e-4 of the largest |logit| (the DeepLab bar of
test_torch_models.py; measured: segmentation 5.6e-6 and error 1.8e-6,
with the symmetric head 4.2e-6 and 2.7e-5); the train trajectory to the bars of
test_torch_train.py::test_step_trajectory_matches_jax (first step 1e-4,
every step 1e-3 relative; weights 1e-3 of the largest); eval losses 1e-5
relative; confusions, targets and predictions equal; panels to 1e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accuracy_predictor_train as jx_driver
import accuracy_predictor_train_torch as pt_driver
from deep_active_semantic_segmentation_torch.models.factory import (
    build_model, param_groups)
from deep_active_semantic_segmentation_torch.ops import losses as pt_losses
from deep_active_semantic_segmentation_torch.ops import lr_schedule as pt_sched
from deep_active_semantic_segmentation_torch.parallel import optim as pt_optim
from deep_active_semantic_segmentation_torch.parallel.steps import (
    make_dual_eval_step, make_dual_train_step)
from deep_active_semantic_segmentation_torch.selection import kernels as pt_kernels
from deep_active_semantic_segmentation_tpu.models.accuracy_predictor import (
    DeepLabAccuracyPredictor as JaxPredictor)
from deep_active_semantic_segmentation_tpu.models.factory import lr_multiplier_tree
from deep_active_semantic_segmentation_tpu.ops import lr_schedule as jx_sched
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.parallel.steps import (
    TrainState, make_dual_eval_step as jx_make_dual_eval_step,
    make_dual_train_step as jx_make_dual_train_step)
from deep_active_semantic_segmentation_tpu.selection import kernels as jx_kernels
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    jax_predictor, one_torch_thread, port_predictor, predictor_state_dict_to_flax)

NCLASS = 21    # Pascal VOC
SIDE = 33
BATCH = 2
W_WRONG = np.asarray([0.75, 0.25], np.float32)   # --weight-wrong-label-unet
REL = 1e-4
LR = 1e-4


@pytest.fixture(scope="module")
def predictors():
    """{symmetry: (JAX model, params, batch_stats)}."""
    return {symmetry: jax_predictor(11 + symmetry, NCLASS, symmetry)
            for symmetry in (False, True)}


def _images(seed, n=BATCH):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (n, SIDE, SIDE, 3), dtype=np.uint8)
    lab = rng.randint(0, NCLASS, (n, SIDE, SIDE)).astype(np.uint8)
    lab[:, :4] = 255
    return img, lab


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max()


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("symmetry", [False, True])
def test_predictor_forward_matches_jax(predictors, symmetry):
    jmodel, params, stats = predictors[symmetry]
    img, _ = _images(1)
    ref_seg, ref_err = jax.jit(lambda v, x: jmodel.apply(
        v, jx_kernels.normalize_on_device(x), train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(img))
    model = port_predictor(params, stats, NCLASS, symmetry)
    with torch.no_grad():
        seg, err = model(pt_kernels.normalize_on_device(torch.from_numpy(img)))
    assert seg.shape == (BATCH, NCLASS, SIDE, SIDE) and err.shape == (BATCH, 2, SIDE, SIDE)
    assert _rel(seg, _nchw(ref_seg)) <= REL and _rel(err, _nchw(ref_err)) <= REL
    # the error head alone, on the same input it saw inside the forward
    x = pt_kernels.normalize_on_device(torch.from_numpy(img))
    with torch.no_grad():
        alone = model(x, unet_only_input=torch.cat([torch.softmax(seg, 1), x], 1))
    assert torch.equal(alone, err)


@pytest.mark.parametrize("symmetry", [False, True])
def test_predictor_weights_round_trip_and_lr_groups(predictors, symmetry):
    """The state_dict loads strict; the JAX package's mappings take it back
    bit for bit; every parameter's learning-rate group is the JAX
    package's ``lr_multiplier_tree`` leaf."""
    _, params, stats = predictors[symmetry]
    model = port_predictor(params, stats, NCLASS, symmetry)
    back_p, back_s = predictor_state_dict_to_flax(model.state_dict(), symmetry)
    for tree, ref in ((back_p, params), (back_s, stats)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, tree, ref)

    groups = param_groups(model, "accuracy_predictor")
    assert [g["lr_mult"] for g in groups] == [1.0, 10.0]
    mult = {id(p): g["lr_mult"] for g in groups for p in g["params"]}
    assert len(mult) == len(list(model.parameters()))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        sd[name] = torch.full_like(p, mult[id(p)])
    mults, _ = predictor_state_dict_to_flax(sd, symmetry)
    ref = lr_multiplier_tree(params, "accuracy_predictor", symmetry=symmetry)
    jax.tree_util.tree_map(lambda m, r: np.testing.assert_array_equal(
        m, np.full(m.shape, r, np.float32)), mults, ref)


def test_enet_head_forward_runs():
    model = build_model("accuracy_predictor", 5, device="cpu", enet_head=True)
    with torch.no_grad():
        seg, err = model(torch.zeros(1, 3, 32, 32))
    assert seg.shape == (1, 5, 32, 32) and err.shape == (1, 2, 32, 32)


# ------------------------------------------------------------- the steps

class _Frozen(JaxPredictor):
    """The JAX predictor with dropout off and BN at running statistics
    inside the JAX package's own dual train step (which applies
    ``train=True``)."""

    def __call__(self, x, train=False, **kw):
        return super().__call__(x, train=False, use_dropout=False, **kw)


def _blocks(n, seed):
    """Block-colour batches (a learnable task) on the uint8 wire."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lab = np.kron(rng.randint(0, NCLASS, (BATCH, 3, 3)), np.ones((1, 11, 11), int))
        img = np.stack([lab * 11 + 5, 250 - lab * 9, (lab * 97) % 251], axis=-1)
        img = np.clip(img + rng.randint(-8, 9, img.shape), 0, 255).astype(np.uint8)
        lab = lab.astype(np.uint8)
        lab[:, :2] = 255
        out.append((img, lab))
    return out


def test_dual_train_steps_match_jax(predictors):
    """Two SGD steps, dropout off, BN at running statistics, poly lr 1e-4
    (at 1e-3 loss_dl rises from these drawn weights), balanced class
    weights, error classes [0.75, 0.25], the loss weights (0.7, 0.3) then
    (0, 1) (the staged schedule's last third): per-step loss, loss_dl and
    loss_un (measured: 1.1e-6, then 9.1e-5 relative) and the weights after
    both. At
    w_dl = 0 the segmentation head's gradient is zero, not None, so SGD
    still decays it, as the JAX optimizer does.

    Two steps, because the error head's target is the argmax of the
    segmentation logits: once the two frameworks' rounding has grown
    through two updates, a few pixels' targets flip and loss_un moves by
    their share (at a third step: 3 pixels of ~1,800, 1.8e-3 relative)."""
    _, params, stats = predictors[False]
    cw = np.random.RandomState(4).uniform(0.5, 2.0, NCLASS).astype(np.float32)
    batches = _blocks(2, seed=5)
    weights = [(0.7, 0.3), (0.0, 1.0)]
    jsched = jx_sched.make_schedule("poly", LR, 4, len(batches))
    jstep = jx_make_dual_train_step(
        _Frozen(num_classes=NCLASS, backbone="mobilenet"), class_weights=cw,
        unet_class_weights=W_WRONG, schedule=jsched,
        lr_mults=lr_multiplier_tree(params, "accuracy_predictor"),
        opt_cfg=jx_optim.SGDConfig(0.9, 5e-4, False))
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=stats,
                       opt_state=jx_optim.init_opt_state(params, "SGD"),
                       step=jnp.zeros((), jnp.int32))
    jax_metrics = []
    for i, (w_dl, w_un) in enumerate(weights):
        img, lab = batches[i % len(batches)]
        state, m = jstep(state, {"image": jnp.asarray(img), "label": jnp.asarray(lab)},
                         jax.random.PRNGKey(0), np.float32(w_dl), np.float32(w_un))
        jax_metrics.append([float(m[k]) for k in ("loss", "loss_dl", "loss_un")])

    model = port_predictor(params, stats, NCLASS)
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    opt = pt_optim.build_optimizer("SGD", param_groups(model, "accuracy_predictor"))
    step = make_dual_train_step(
        model, opt, pt_losses.build_loss("ce", class_weights=torch.from_numpy(cw)),
        pt_losses.build_loss("ce", class_weights=torch.from_numpy(W_WRONG)),
        pt_sched.make_schedule("poly", LR, 4, len(batches)))
    port_metrics = []
    for i, (w_dl, w_un) in enumerate(weights):
        img, lab = batches[i % len(batches)]
        before = model.deeplab.decoder.last_conv[7].weight.detach().clone()
        out = step({"image": torch.from_numpy(img), "label": torch.from_numpy(lab)},
                   i, w_dl, w_un)
        port_metrics.append([float(out[k]) for k in ("loss", "loss_dl", "loss_un")])
    # the w_dl = 0 step: zero gradients, and the head still moved
    seg_grads = [p.grad for p in model.deeplab.parameters()]
    assert all(g is not None and not g.any() for g in seg_grads)
    assert not torch.equal(model.deeplab.decoder.last_conv[7].weight, before)

    port_metrics, jax_metrics = np.asarray(port_metrics), np.asarray(jax_metrics)
    rel = np.abs(port_metrics - jax_metrics) / np.abs(jax_metrics)
    assert rel[0].max() <= 1e-4 and rel.max() <= 1e-3, (port_metrics, jax_metrics)
    got, _ = predictor_state_dict_to_flax(model.state_dict())
    jp = jax.tree_util.tree_map(np.asarray, state.params)
    scale = max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(jp))
    err = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - b).max()), got, jp)))
    assert err <= 1e-3 * scale, (err, scale)


def test_dual_eval_step_equals_jax(predictors):
    """nvalid 1 of a batch of 2 (the second a padded, all-255 duplicate)."""
    jmodel, params, stats = predictors[False]
    img, lab = _images(2)
    lab[1] = 255
    cw = np.random.RandomState(6).uniform(0.5, 2.0, NCLASS).astype(np.float32)
    ref = jx_make_dual_eval_step(jmodel, NCLASS, class_weights=cw,
                                 unet_class_weights=W_WRONG)(
        TrainState(params=params, batch_stats=stats, opt_state=None, step=0),
        {"image": jnp.asarray(img), "label": jnp.asarray(lab)},
        np.float32(1), np.float32(0.7), np.float32(0.3))
    step = make_dual_eval_step(
        port_predictor(params, stats, NCLASS), NCLASS,
        pt_losses.build_loss("ce", class_weights=torch.from_numpy(cw),
                             batch_average=False),
        pt_losses.build_loss("ce", class_weights=torch.from_numpy(W_WRONG),
                             batch_average=False))
    out = step({"image": torch.from_numpy(img), "label": torch.from_numpy(lab)},
               1, 0.7, 0.3)
    for k in ("loss", "loss_dl", "loss_un"):
        assert abs(float(out[k]) - float(ref[k])) <= 1e-5 * abs(float(ref[k])), k
    for k in ("confusion", "unet_confusion", "pred", "err_pred", "unet_target"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert int(out["unet_confusion"].sum()) == int((lab < NCLASS).sum())


def test_two_headed_panel_equals_jax():
    """``create_single_visualization``'s 2x3 tiles, image by image."""
    from deep_active_semantic_segmentation_torch.utils.summaries import (
        TensorboardSummary)
    from deep_active_semantic_segmentation_tpu.utils.summaries import (
        TensorboardSummary as JaxSummary)

    class Recorder:
        def __init__(self):
            self.images = []

        def add_image(self, tag, img, step):
            self.images.append((tag, np.asarray(img), step))

    img, lab = _images(3, n=4)
    rng = np.random.RandomState(3)
    maps = [lab, rng.randint(0, NCLASS, lab.shape), np.where(lab == 255, 255, lab % 2),
            rng.randint(0, 2, lab.shape)]
    got, ref = Recorder(), Recorder()
    TensorboardSummary("unused").create_single_visualization(
        got, "train/run_0050", "active_pascal_image", torch.from_numpy(img),
        *[torch.from_numpy(m) for m in maps], 7)
    JaxSummary("unused").create_single_visualization(
        ref, "train/run_0050", "active_pascal_image", img, *maps, 7)
    assert len(got.images) == len(ref.images) == 3
    for (tag, a, step), (rtag, b, rstep) in zip(got.images, ref.images):
        assert (tag, step) == (rtag, rstep) and a.shape == (3, 2 * SIDE, 3 * SIDE)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def test_weight_schedules_equal_jax():
    for epochs in (1, 3, 7, 150):
        for staged in (False, True):
            assert (pt_driver.build_weight_schedules(epochs, 0.3, staged)
                    == jx_driver.build_weight_schedules(epochs, 0.3, staged))
