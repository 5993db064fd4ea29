"""The port's two-headed steps (parallel/steps.py ``make_dual_train_step``
/ ``make_dual_eval_step`` with ``mesh``) on two gloo ranks on the CPU,
against the JAX package's dual steps on a 2-device mesh of the conftest's
virtual CPU devices and against the port's own one-rank step.

The accuracy predictor is DeepLab-MobileNetV2 with the UNet error head
(and, once, the ENet-headed one), 21 classes at 33² (ENet 32²), 2 rows
per rank, BN in train mode with cross-replica statistics, the
segmentation CE class-weighted and the error head's CE weighted [0.75,
0.25]. The ranks run once for the module (one ``launch`` of
``torch_parallel_workers.dual_checks``), with the process group's timeout
and a join timeout.

Tolerances: the train step against JAX as test_torch_parallel.py holds
the one-headed one (loss 1e-4 relative, running means 1e-3 relative /
1e-5 absolute), but the updated weights within 5e-4 of the largest
weight, against JAX's step on the mesh and against the exact step (the
one-rank port step in f64) alike: every f32 step here is about 1e-4 of
the largest weight off the exact one, in the stem and the first blocks,
where train-mode BN's backward rounds in f32 (measured: the 2-rank port
step 1.1e-4, JAX's on make_mesh(2) 9.4e-5 and on one device 1.5e-4, the
one-rank port step 2.4e-5; the 2-rank port step is 9.0e-5 off JAX's), so
a 1e-4 bar would sit on the rounding. The 2-rank arithmetic itself is
held in f64: the dropout step and the ENet-headed step against the
one-rank port step with the same masks, within 1e-6 of the largest
weight. The eval confusions exactly, its losses 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.models.factory import build_model
from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
from deep_active_semantic_segmentation_tpu.models.factory import (
    build_model as jx_build_model, lr_multiplier_tree)
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.parallel import steps as jx_steps
from deep_active_semantic_segmentation_tpu.parallel.mesh import make_mesh as jx_make_mesh
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, predictor_state_dict_to_flax)
import torch_parallel_workers as workers

WORLD = 2
NCLASS = 21
SIDE = 33
ENET_SIDE = 32
W_WRONG = np.asarray([0.75, 0.25], np.float32)   # --weight-wrong-label-unet
JOIN_TIMEOUT_S = 240      # a spawn's limit
GROUP_TIMEOUT_S = 120     # a collective's limit inside the ranks


def _batch(rng, side, block):
    """Four block-colour images (a learnable task) on the uint8 wire with
    void bands, rank 0's rows far emptier than rank 1's."""
    n = side // block
    label = np.kron(rng.randint(0, NCLASS, (4, n, n)),
                    np.ones((1, block, block), int)).astype(np.uint8)
    image = np.stack([label * 11 + 5, 250 - label * 9, (label * 97) % 251], -1)
    image = np.clip(image + rng.randint(-8, 9, image.shape), 0, 255).astype(np.uint8)
    label[:, :2] = 255
    label[0, :side // 2] = 255
    return image, label


def _port_state(seed, enet=False):
    """The port's init of the predictor from ``seed``, every BN bias drawn
    ~0.1 N(0, 1) (off the ReLU kinks, ROADMAP C)."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model("accuracy_predictor", NCLASS, device="cpu", generator=gen,
                        enet_head=enet)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(setup, the JAX predictor and its trees, both ranks' results)."""
    rng = np.random.RandomState(0)
    state_dict = _port_state(11)
    params, stats = predictor_state_dict_to_flax(state_dict)
    jmodel = jx_build_model("accuracy_predictor", NCLASS, backbone="mobilenet")
    image, label = _batch(rng, SIDE, 11)
    eval_label = label.copy()
    eval_label[3] = 255                   # a padded partial batch: 3 valid
    enet_image, enet_label = _batch(rng, ENET_SIDE, 8)
    setup = {
        "nclass": NCLASS, "w_wrong": W_WRONG, "dropout_seed": 7,
        "cw": rng.uniform(0.5, 2.0, NCLASS).astype(np.float32),
        "deeplab": {"state_dict": state_dict, "image": image, "label": label,
                    "eval_label": eval_label},
        "enet": {"state_dict": _port_state(5, enet=True), "image": enet_image,
                 "label": enet_label},
    }
    tmp = tmp_path_factory.mktemp("dual")
    torch.save(setup, str(tmp / "setup.pt"))
    pt_mesh.launch(workers.dual_checks, (str(tmp / "setup.pt"), str(tmp)),
                   num_devices=WORLD, device="cpu", timeout=GROUP_TIMEOUT_S,
                   join_timeout=JOIN_TIMEOUT_S)
    ranks = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return setup, (jmodel, params, stats), ranks


class NoDropout:
    """The JAX predictor with dropout off in the JAX package's dual train
    step's train-mode apply."""

    def __init__(self, model):
        self.model = model

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, use_dropout=False, **kwargs)


def _largest_gap(got: dict, ref: dict):
    """(largest |difference| over the floating tensors, largest |ref|)."""
    keys = [k for k, v in ref.items() if v.is_floating_point()]
    return (max(float((got[k] - ref[k]).abs().max()) for k in keys),
            max(float(ref[k].abs().max()) for k in keys))


def test_dual_train_step_matches_jax_on_a_two_device_mesh(case):
    """One train-mode SGD step at (w_dl, w_un) = (0.7, 0.3), dropout off,
    against the JAX package's make_dual_train_step on make_mesh(2) (the
    three losses, the updated weights of both heads, the running means)
    and against the exact step (the one-rank port step in f64); both ranks
    end with the same tensors (BN buffers included)."""
    setup, (jmodel, params, stats), ranks = case
    mesh = jx_make_mesh(WORLD)
    state = jx_steps.place_replicated(jx_steps.TrainState(
        params=params, batch_stats=stats,
        opt_state=jx_optim.init_opt_state(params, "SGD"),
        step=jnp.zeros((), jnp.int32)), mesh)
    step = jx_steps.make_dual_train_step(
        NoDropout(jmodel), class_weights=setup["cw"], unet_class_weights=W_WRONG,
        schedule=lambda i, dyn=None: jnp.float32(0.01),
        lr_mults=lr_multiplier_tree(params, "accuracy_predictor"),
        opt_cfg=jx_optim.SGDConfig(0.9, 5e-4, False), mesh=mesh)
    new, metrics = step(state, {"image": jnp.asarray(setup["deeplab"]["image"]),
                                "label": jnp.asarray(setup["deeplab"]["label"])},
                        jax.random.PRNGKey(0), np.float32(0.7), np.float32(0.3))
    (loss0, sd0), (loss1, sd1) = (r["step"] for r in ranks)
    assert loss0 == loss1
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    for k in ("loss", "loss_dl", "loss_un"):
        assert abs(loss0[k] - float(metrics[k])) <= 1e-4 * abs(float(metrics[k])), k
    got_params, got_stats = predictor_state_dict_to_flax(sd0)
    scale = max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(new.params))
    err = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), got_params, new.params)))
    assert err <= 5e-4 * scale, (err, scale)
    _, exact = workers.dual_train_step(setup, None, dtype=torch.float64)
    err, scale = _largest_gap({k: v.double() for k, v in sd0.items()}, exact)
    assert err <= 5e-4 * scale, (err, scale)
    means = 0
    for path, got in jax.tree_util.tree_flatten_with_path(got_stats)[0]:
        if path[-1].key == "mean":
            ref = new.batch_stats
            for p in path:
                ref = ref[p.key]
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-3, atol=1e-5)
            means += 1
    assert means > 50   # both heads' batch norms


def test_dual_eval_step_confusions_equal_jax_mesh_exactly(case):
    """A padded partial batch (3 valid of 4; the ranks hold 2 and 1): both
    confusions, summed over the ranks, equal the JAX dual eval step's on
    the mesh; the losses divide by the global valid count."""
    setup, (jmodel, params, stats), ranks = case
    ev = jx_steps.make_dual_eval_step(jmodel, NCLASS, class_weights=setup["cw"],
                                      unet_class_weights=W_WRONG,
                                      mesh=jx_make_mesh(WORLD))
    out = ev(jx_steps.TrainState(params=params, batch_stats=stats, opt_state=None,
                                 step=jnp.zeros((), jnp.int32)),
             {"image": jnp.asarray(setup["deeplab"]["image"]),
              "label": jnp.asarray(setup["deeplab"]["eval_label"])},
             np.float32(3), np.float32(0.7), np.float32(0.3))
    assert [r["eval"]["nvalid"] for r in ranks] == [2, 1]
    for r in ranks:
        for k in ("confusion", "unet_confusion"):
            np.testing.assert_array_equal(r["eval"][k], np.asarray(out[k]).astype(np.int64))
        for k in ("loss", "loss_dl", "loss_un"):
            np.testing.assert_allclose(r["eval"][k], float(out[k]), rtol=1e-5)
    assert int(ranks[0]["eval"]["unet_confusion"].sum()) == int(
        (setup["deeplab"]["eval_label"] < NCLASS).sum())


@pytest.mark.parametrize("name", ["dropout_step", "enet_step"])
def test_dual_step_equals_the_one_rank_port_step_in_f64(case, name):
    """Dropout on (each rank keeps its rows of the global batch's masks,
    so two ranks take the one-rank step of the same generator), and the
    ENet-headed predictor at the staged schedule's (w_dl, w_un) = (0, 1):
    in f64 (weights and image; the losses are f32), the 2-rank step equals
    the one-rank port step within 1e-6 of the largest weight."""
    setup, _, ranks = case
    if name == "dropout_step":
        ref_loss, ref = workers.dual_train_step(
            setup, None, torch.Generator().manual_seed(setup["dropout_seed"]),
            torch.float64)
        # dropout acted: the f32 dropout-free step's loss is elsewhere
        assert abs(ranks[0][name][0]["loss"] - ranks[0]["step"][0]["loss"]) > 1e-3
    else:
        ref_loss, ref = workers.dual_train_step(setup, None, dtype=torch.float64,
                                                enet=True, weights=(0.0, 1.0))
        assert ranks[0][name][0]["loss_dl"] > 0 and ref_loss["loss"] == pytest.approx(
            ref_loss["loss_un"])
    (loss0, sd0), (loss1, sd1) = ranks[0][name], ranks[1][name]
    assert loss0 == loss1 and all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    for k, v in ref_loss.items():
        assert abs(loss0[k] - v) <= 1e-6 * abs(v), (k, loss0[k], v)
    err, scale = _largest_gap(sd0, ref)
    assert err <= 1e-6 * scale, (err, scale)


def test_cross_replica_conversion_keeps_each_bn_in_its_dtype():
    """An f64 model's batch norms stay f64 through the conversion, their
    values exact (they came back f32, so an f64 UNet on N ranks raised
    a mixed-dtype error in its first batch norm)."""
    import types

    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        CrossReplicaBatchNorm2d, convert_cross_replica_bn)

    model = build_model("unet", 2, input_channels=1, device="cpu",
                        generator=torch.Generator().manual_seed(0)).double()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.fill_(1 + 1e-12)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    convert_cross_replica_bn(model, types.SimpleNamespace(distributed=True, world=2))
    bns = [m for m in model.modules() if isinstance(m, CrossReplicaBatchNorm2d)]
    assert len(bns) == 14 and all(m.weight.dtype == torch.float64 for m in bns)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
