"""The port's spatial (height-sharded) mesh (parallel/{mesh,spatial}.py,
``make_train_step(spatial=True)``, the losses' normalizers on two axes,
``dryrun_multichip``'s data x spatial layout) on gloo ranks on the CPU,
against whole-tensor ops, the port's one-process step and the JAX
package's ``make_train_step(spatial=True)`` on the conftest's virtual
(1x2) mesh.

Three spawns, once each for the module (``torch_parallel_workers
.spatial_checks``): a (1x2) mesh (primitives at spatial 2, losses,
steps), a (1x4) mesh (primitives at spatial 4) and a (2x2) mesh (losses,
steps). Each has a join timeout and a process-group timeout.

Tolerances: every primitive and its gradients in f64 within 1e-12 of the
whole tensor's largest value; the spatial step in f64 (dropout on)
against one process, loss and every tensor of the state_dict (BN running
statistics included) within 1e-10 of the largest; against JAX in f32,
the loss within 1e-5 relative and the weights within 5e-4 of the largest
(JAX's own spatial step against its unsharded one parts by 2.9e-4 with
BN biases drawn so: a half-height band rounds its convs' sums in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_active_semantic_segmentation_torch.models.factory import build_model
from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
from deep_active_semantic_segmentation_torch.parallel import spatial as pt_spatial
from deep_active_semantic_segmentation_torch.parallel.dryrun import dryrun_multichip
from deep_active_semantic_segmentation_tpu.models.deeplab import DeepLab as JaxDeepLab
from deep_active_semantic_segmentation_tpu.models.factory import lr_multiplier_tree
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    deeplab_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.parallel import steps as jx_steps
from deep_active_semantic_segmentation_tpu.parallel.mesh import make_mesh as jx_make_mesh
from torch_port_helpers import NUM_CLASSES, one_torch_thread  # noqa: F401
import torch_parallel_workers as workers

JOIN_TIMEOUT_S = 300      # a spawn's limit
GROUP_TIMEOUT_S = 120     # a collective's limit inside the ranks
LOSS_CASES = [(kind, ba) for kind in ("ce", "weighted_ce", "focal",
                                      "weighted_focal", "sample_weighted")
              for ba in (True, False)]
MESHES = {"1x2": (2, 2), "1x4": (4, 4), "2x2": (4, 2)}   # (world, spatial)


def _conv_case(rng, name, h, cin, cout, k, stride, pad, dilation, groups=1,
               edge=(0, 0), w=6):
    """A conv over an (h + edge) x (w + 2 edge) input (``edge``: the rows
    and columns of fixed padding it already carries)."""
    x = rng.randn(2, cin, h + sum(edge), w + sum(edge))
    weight = rng.randn(cout, cin // groups, k, k)
    out = F.conv2d(torch.from_numpy(x), torch.from_numpy(weight), None, stride,
                   (pad, pad), dilation, groups)
    return {"name": name, "kind": "conv", "x": x, "weight": weight, "stride": stride,
            "pad": pad, "dilation": dilation, "groups": groups, "edge": edge,
            "dy": rng.randn(*out.shape)}


def primitive_cases(rng):
    """Convs as the model runs them (the stem; the depthwise convs on
    fixed-padded input, stride 1 and 2, dilation 2; ASPP's dilations 6 and
    18, whose halos outgrow a band and, at 18, the image; the decoder's
    3x3), the align-corners resizes 4 -> 16 and 16 -> 64 rows (33 -> 129
    columns: the rows split into equal bands, so an odd ratio is a
    column one) and the global mean."""
    cases = [
        _conv_case(rng, "stem", 16, 3, 4, 3, 2, 1, 1),
        _conv_case(rng, "depthwise", 16, 4, 4, 3, 1, 0, 1, groups=4, edge=(1, 1)),
        _conv_case(rng, "depthwise_stride2", 16, 4, 4, 3, 2, 0, 1, groups=4, edge=(1, 1)),
        _conv_case(rng, "depthwise_dilated", 16, 4, 4, 3, 1, 0, 2, groups=4, edge=(2, 2)),
        _conv_case(rng, "aspp_d6", 8, 3, 2, 3, 1, 6, 6),
        _conv_case(rng, "aspp_d18", 4, 3, 2, 3, 1, 18, 18),
        _conv_case(rng, "decoder", 16, 5, 3, 3, 1, 1, 1),
    ]
    for name, (h, w), (oh, ow) in (("4to16", (4, 6), (16, 21)),
                                   ("16to64", (16, 16), (64, 64)),
                                   ("8to32_33to129", (8, 33), (32, 129))):
        cases.append({"name": name, "kind": "resize", "x": rng.randn(2, 3, h, w),
                      "out": (oh, ow), "dy": rng.randn(2, 3, oh, ow)})
    cases.append({"name": "mean", "kind": "mean", "x": rng.randn(2, 3, 16, 5),
                  "dy": rng.randn(2, 3, 1, 1)})
    return cases


CASE_NAMES = [c["name"] for c in primitive_cases(np.random.RandomState(0))]


def model_setup(rng, gen, images):
    """A DeepLab-MobileNetV2 with BN biases drawn ~0.1 N(0, 1) (off the
    ReLU6 kinks, ROADMAP C) and ``images`` uint8 images at JAX's dry-run
    side of 64 (the os16 map has 4 rows, 2 per band) whose labels are
    ignored in rows 0-19 only: every one in rank 0's band."""
    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device="cpu",
                        generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    blocks = rng.randint(0, NUM_CLASSES, (images, 4, 4))
    label = np.kron(blocks, np.ones((1, 16, 16), int)).astype(np.uint8)
    image = np.stack([label * 13 + 5, 250 - label * 11, (label * 97) % 251], -1)
    image = np.clip(image + rng.randint(-8, 9, image.shape), 0, 255).astype(np.uint8)
    label[:, :20] = 255
    logits = 3 * rng.randn(images, 5, 8, 6)
    target = rng.randint(0, 5, (images, 8, 6))
    target[:, :3] = 255                     # rank 0's band only
    return {"state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "image": image, "label": label,
            "cw": rng.uniform(0.5, 2.0, NUM_CLASSES).astype(np.float32),
            "logits": logits, "target": target, "loss_cases": LOSS_CASES,
            "cw5": rng.uniform(0.2, 3.0, 5), "sw": rng.uniform(0.3, 1.7, images),
            "dropout_seed": 7}


def spawn(name, setup, tmp_path):
    world, spatial = MESHES[name]
    setup_path = str(tmp_path / "setup.pt")
    torch.save(setup, setup_path)
    pt_mesh.launch(workers.spatial_checks, (setup_path, str(tmp_path)),
                   num_devices=world, device="cpu", timeout=GROUP_TIMEOUT_S,
                   join_timeout=JOIN_TIMEOUT_S, spatial=spatial)
    return [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh name: (setup, every rank's results)}."""
    out = {}
    for name, images in (("1x2", 2), ("1x4", 0), ("2x2", 4)):
        rng = np.random.RandomState(len(out))
        setup = {"prims": [] if name == "2x2" else primitive_cases(
            np.random.RandomState(0))}
        if images:
            setup.update(model_setup(rng, torch.Generator().manual_seed(4), images),
                         steps=True)
        out[name] = (setup, spawn(name, setup, tmp_path_factory.mktemp(name)))
    return out


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _every_rank(ranks, name):
    """(loss, state) of a step that every rank ended with the same: the
    same loss and the same tensors (digests) as rank 0, whose state is
    returned."""
    loss, state, digest = ranks[0][name]
    assert workers.state_digest(state) == digest
    assert all(r[name][0] == loss and r[name][2] == digest for r in ranks)
    return loss, state


def _state_gap(got, want):
    floats = [k for k, v in want.items() if v.is_floating_point()]
    scale = max(float(want[k].abs().max()) for k in floats)
    assert all(torch.equal(got[k], v) for k, v in want.items()
               if not v.is_floating_point())
    return max(float((got[k] - want[k]).abs().max()) for k in floats) / scale


# -------------------------------------------------------------- primitives

def _whole(case):
    """The case's whole-tensor forward and gradients (f64)."""
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    dy = torch.from_numpy(case["dy"])
    if case["kind"] == "conv":
        w = torch.from_numpy(case["weight"]).requires_grad_(True)
        pad = case["pad"]
        y = F.conv2d(x, w, None, case["stride"], pad, case["dilation"], case["groups"])
        (y * dy).sum().backward()
        return y.detach().numpy(), x.grad.numpy(), w.grad.numpy()
    if case["kind"] == "resize":
        y = F.interpolate(x, size=case["out"], mode="bilinear", align_corners=True)
    else:
        y = x.mean(dim=(2, 3), keepdim=True)
    (y * dy).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), None


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("mesh_name", ["1x2", "1x4"])
def test_primitive_equals_the_whole_tensor(runs, mesh_name, name):
    """Each rank's band of the forward, and the bands of the input
    gradient, equal the whole tensor's (f64, 1e-12 of the largest); a
    conv's weight gradient is the sum of the ranks'. The global mean is
    every rank's, and its gradient is each rank's band times the world
    (``cross_replica_sum``'s convention; DDP's mean divides it out)."""
    setup, ranks = runs[mesh_name]
    i = CASE_NAMES.index(name)
    case = setup["prims"][i]
    y, dx, dw = _whole(case)
    got = [r["prims"][i] for r in ranks]
    n = len(ranks)
    if case["kind"] == "mean":
        for g in got:
            assert _rel(g["y"], y) <= 1e-12
        assert _rel(np.concatenate([g["dx"] for g in got], 2) / n, dx) <= 1e-12
        return
    assert _rel(np.concatenate([g["y"] for g in got], 2), y) <= 1e-12
    assert _rel(np.concatenate([g["dx"] for g in got], 2), dx) <= 1e-12
    if case["kind"] == "conv":
        assert _rel(sum(g["dw"] for g in got), dw) <= 1e-12


def test_halo_fetch_past_the_neighbour_and_the_image():
    """The spans a rank sends and receives: at ASPP's dilation 18 on a
    4-row map split 2 + 2, each rank wants 18 rows either side; only the
    other band's rows cross, the rest are the image's zero padding."""
    owns = pt_spatial.equal_bands(2, 2)
    wants = [(-18, 20), (-16, 22)]
    assert pt_spatial._slots(owns, wants) == ([(0, (2, 4), 0), (1, (0, 2), 2)], 4)
    owns4 = pt_spatial.equal_bands(1, 4)
    slots, total = pt_spatial._slots(owns4, [(q - 18, q + 19) for q in range(4)])
    assert total == 4 * 3 and [s[1] for s in slots[:2]] == [(1, 4), (0, 1)]


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("kind,batch_average", LOSS_CASES)
@pytest.mark.parametrize("mesh_name", ["1x2", "2x2"])
def test_losses_on_bands_equal_the_whole_batch(runs, mesh_name, kind, batch_average):
    """Every loss on the bands (labels ignored in rank 0's band only) is
    the whole batch's on every rank: the pixel sums cross every rank,
    ``batch_average`` counts the data rows, the sample-weighted mean
    divides by the global height; each rank's logits gradient is the
    world times the whole batch's band. The losses compute in f32: both
    within 1e-6 of the whole batch's."""
    from deep_active_semantic_segmentation_torch.ops import losses

    setup, ranks = runs[mesh_name]
    logits = torch.from_numpy(setup["logits"]).requires_grad_(True)
    target = torch.from_numpy(setup["target"])
    cw = torch.from_numpy(setup["cw5"]) if kind.startswith("weighted") else None
    if kind == "sample_weighted":
        one = losses.sample_weighted_cross_entropy(
            logits, target, torch.from_numpy(setup["sw"]), setup["cw5"],
            batch_average=batch_average)
    else:
        fn = losses.focal_loss if "focal" in kind else losses.cross_entropy
        one = fn(logits, target, class_weights=cw, batch_average=batch_average)
    one.backward()
    world, spatial = MESHES[mesh_name]
    mesh = pt_mesh.Mesh(0, world, spatial=spatial)
    for r, rank in enumerate(ranks):
        value, grad = rank["losses"][(kind, batch_average)]
        assert abs(value - float(one.detach())) <= 1e-6 * abs(float(one.detach()))
        mesh.rank = r
        want = workers._band(mesh, logits.grad).numpy()
        assert _rel(grad / world, want) <= 1e-6


# -------------------------------------------------------------- the steps

@pytest.mark.parametrize("mesh_name", ["1x2", "2x2"])
def test_spatial_step_equals_the_one_process_step(runs, mesh_name):
    """The spatial DeepLab-MobileNetV2 step at side 64 (dropout on, f64)
    equals one process's step on the whole batch: every parameter and the
    BN running statistics (n / (n - 1) of the global padded count) within
    1e-10 of the largest (measured 1.3e-12 on (1x2), 1.1e-13 on (2x2)),
    on every rank; the loss, which every port loss computes in f32,
    within 1e-6 relative (measured 6.5e-8, 7.1e-8)."""
    setup, ranks = runs[mesh_name]
    loss, state = workers.spatial_train_step(None, setup,
                                             dropout_seed=setup["dropout_seed"])
    got_loss, got = _every_rank(ranks, "f64_step")
    assert abs(got_loss - loss) <= 1e-6 * abs(loss)
    assert _state_gap(got, state) <= 1e-10
    assert abs(ranks[0]["f64_step"][0] - ranks[0]["data_only_step"][0]) > 1e-3


@pytest.mark.parametrize("mesh_name", ["1x2", "2x2"])
def test_data_only_step_on_the_2d_mesh_equals_one_process(runs, mesh_name):
    """The uint8-wire step without ``spatial`` on the same mesh (JAX's
    ``P('data')`` step): the ranks of a data row are replicas and the BN
    statistics merge over the data axis only, so the running variance
    (its n / (n - 1)) is one process's (f64: the state within 1e-10 of the
    largest, the f32 loss within 1e-6)."""
    setup, ranks = runs[mesh_name]
    loss, state = workers.spatial_train_step(None, setup, spatial=False)
    got_loss, got = _every_rank(ranks, "data_only_step")
    assert abs(got_loss - loss) <= 1e-6 * abs(loss)
    assert _state_gap(got, state) <= 1e-10


class NoDropout:
    """The JAX model with dropout off in its train-mode apply."""

    def __init__(self, model):
        self.model = model

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, use_dropout=False, **kwargs)


def test_spatial_step_equals_jax_spatial_step(runs):
    """The f32 spatial step (dropout off) on the (1x2) mesh against the
    JAX package's ``make_train_step(spatial=True)`` on a (1x2) mesh of
    the conftest's virtual devices, the port's weights carried over: loss
    within 1e-5 relative, weights within 5e-4 of the largest (measured:
    loss 3.2e-6, weights 2.6e-4, as JAX's own spatial step against its
    unsharded one)."""
    setup, ranks = runs["1x2"]
    params, stats = deeplab_state_dict_to_flax(
        {k: v.numpy().copy() for k, v in setup["state_dict"].items()}, "mobilenet")
    jmodel = JaxDeepLab(num_classes=NUM_CLASSES, backbone="mobilenet",
                        output_stride=16, mc_dropout=True)
    mesh = jx_make_mesh(2, spatial=2)
    state = jx_steps.place_replicated(jx_steps.TrainState(
        params=params, batch_stats=stats,
        opt_state=jx_optim.init_opt_state(params, "SGD"),
        step=jnp.zeros((), jnp.int32)), mesh)
    step = jx_steps.make_train_step(
        NoDropout(jmodel), loss_mode="ce", class_weights=setup["cw"],
        schedule=lambda i, dyn=None: jnp.float32(0.01),
        lr_mults=lr_multiplier_tree(params, "deeplab"), optimizer="SGD",
        opt_cfg=jx_optim.SGDConfig(0.9, 5e-4, False), mesh=mesh, spatial=True)
    new, metrics = step(state, {"image": jnp.asarray(setup["image"]),
                                "label": jnp.asarray(setup["label"])},
                        jax.random.PRNGKey(0))
    ref = float(metrics["loss"])
    got_loss, got = _every_rank(ranks, "f32_step")
    got_params, _ = deeplab_state_dict_to_flax(
        {k: v.numpy().copy() for k, v in got.items()}, "mobilenet")
    scale = max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(new.params))
    err = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), got_params, new.params)))
    assert abs(got_loss - ref) <= 1e-5 * abs(ref)
    assert err <= 5e-4 * scale, (err, scale)


# --------------------------------------------------------------- refusals

def test_a_height_that_does_not_split_is_refused():
    mesh = pt_mesh.Mesh(0, 2, spatial=2)
    with pytest.raises(ValueError, match=r"height % \(spatial \* 16\) == 0"):
        pt_spatial.shard_rows(65, mesh)
    assert pt_spatial.shard_rows(64, mesh) == (0, 32)
    mesh.rank = 1
    assert pt_spatial.shard_rows(1024, mesh) == (512, 1024)


@pytest.mark.parametrize("world,spatial", [(3, 2), (2, 4), (4, 0)])
def test_a_world_the_spatial_axis_does_not_divide_is_refused(world, spatial):
    with pytest.raises(ValueError, match=f"a spatial axis of {spatial} does not "
                                         f"divide a world of {world} ranks"):
        pt_mesh.launch(print, num_devices=world, device="cpu", spatial=spatial)


@pytest.mark.parametrize("arch,backbone,item", [
    ("accuracy_predictor", "mobilenet", "make_dual_train_step shards the batch over "
                                        "'data' only")])
def test_other_models_are_refused_on_the_spatial_axis(arch, backbone, item):
    """The two-headed accuracy predictor has no height-sharded forward (the
    JAX package has no spatial dual step, and its spatial
    ``make_train_step`` cannot take two heads): it raises, naming why,
    before any collective runs."""
    model = build_model(arch, NUM_CLASSES, backbone=backbone, device="cpu")
    axis = pt_mesh.Mesh(0, 2)
    with pytest.raises(NotImplementedError, match=item):
        with pt_spatial.spatial_rows(model, axis):
            pass
    with pt_spatial.spatial_rows(model, pt_mesh.Mesh(0, 1)):   # one rank: no-op
        pass


@pytest.mark.parametrize("mesh", [None, pt_mesh.Mesh(0, 2, group="a group")])
def test_spatial_step_needs_a_spatial_axis(mesh):
    from deep_active_semantic_segmentation_torch.parallel.steps import make_train_step

    model = build_model("deeplab", NUM_CLASSES, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh with a spatial axis"):
        make_train_step(model, None, None, None, mesh=mesh, spatial=True)


def test_dryrun_multichip_on_a_2x2_mesh():
    line = dryrun_multichip(4, device="cpu", join_timeout=JOIN_TIMEOUT_S)
    assert line.startswith("dryrun_multichip: n=4 mesh=(2x2)")
    assert "pool_scores_ok=True" in line and line.endswith("OK")
