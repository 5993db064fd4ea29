"""The port's spatial (height-sharded) train step for every model JAX's
``make_train_step(spatial=True)`` takes beyond DeepLab-MobileNetV2:
DeepLab-ResNet-50/101 (os16 and os8), ENet, FastSCNN and the UNet
(parallel/spatial.py's pool, transposed-conv, row-below, adaptive-pool
and replicated-resize primitives; the models under ``spatial_rows``), on
gloo ranks on the CPU, against whole-tensor ops, the port's one-process
step and the JAX package's spatial step on the conftest's virtual (1x2)
mesh.

Three spawns, once each for the module (``torch_parallel_workers
.spatial_zoo_checks``): a (1x2) mesh (primitives at spatial 2, each
model's step in f64 with dropout and in f32 without), a (1x4) mesh
(primitives at spatial 4) and a (2x2) mesh (each model's f64 step). Each
has a join timeout and a process-group timeout.

Tolerances: every primitive and its gradients in f64 within 1e-12 of the
whole tensor's largest value (the pool's selector exactly); each model's
spatial step in f64 (dropout on) against one process, the loss within
1e-6 relative (every port loss computes in f32) and every state_dict
tensor within 1e-10 of the largest; against JAX in f32 (dropout off,
batch norm at its running statistics), per model, the bars in
``JAX_BARS`` with JAX's own spatial step's gap to its unsharded one
beside each. The JAX comparison holds batch norm at its running
statistics, as tests/test_torch_resnet.py's does: with train-mode BN at
side 64 on two images, flax's f32 batch statistics (E[x^2] - E[x]^2; on
ASPP's pool branch two values per channel) move JAX's own spatial step
from its unsharded one by 1.1e-3 in the loss and 4.7e-2 of the largest
weight (ResNet-50 os16), so train-mode BN on bands is held in f64
against one process instead (and at full frame on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_active_semantic_segmentation_torch.models import enet as pt_enet
from deep_active_semantic_segmentation_torch.models.factory import build_model
from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
from deep_active_semantic_segmentation_torch.parallel import spatial as pt_spatial
from deep_active_semantic_segmentation_tpu.models import factory as jx_factory
from deep_active_semantic_segmentation_tpu.models import pretrained as jx_pretrained
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.parallel import steps as jx_steps
from deep_active_semantic_segmentation_tpu.parallel.mesh import make_mesh as jx_make_mesh
from torch_port_helpers import one_torch_thread  # noqa: F401
import torch_parallel_workers as workers

JOIN_TIMEOUT_S = 300      # a spawn's limit
GROUP_TIMEOUT_S = 120     # a collective's limit inside the ranks
MESHES = {"1x2": (2, 2), "1x4": (4, 4), "2x2": (4, 2)}   # (world, spatial)
SIDE = 64
CLASSES = 5
# name: (architecture, backbone, output stride)
MODELS = {"resnet50_os16": ("deeplab", "resnet", 16),
          "resnet50_os8": ("deeplab", "resnet", 8),
          "resnet101_os16": ("deeplab", "resnet101", 16),
          "enet": ("enet", "mobilenet", 16),
          "fastscnn": ("fastscnn", "mobilenet", 16),
          "unet": ("unet", "mobilenet", 16)}
# the f32 spatial step (BN at running statistics, dropout off) against
# JAX's step on the (1x2) mesh: (JAX step height-sharded?, loss bar
# relative to the loss, weight bar relative to the largest weight), with
# JAX's own (1x2) spatial step's gap to its unsharded step (loss, weights)
# measured on the same setup beside each. ENet's JAX spatial step is
# wrong at the initial pool's first row (test_jax_spatial_step_zero_pads_
# enets_initial_pool): the port is held to JAX's unsharded step at the
# common bar, and to JAX's spatial step at that measured gap.
JAX_BARS = {
    "resnet50_os16": (True, 1e-5, 5e-4),     # JAX's own: 9.5e-8, 4.7e-7
    "resnet50_os8": (True, 1e-5, 5e-4),      # JAX's own: 1.9e-7, 6.7e-7
    "fastscnn": (True, 1e-5, 5e-4),          # JAX's own: 0, 1.2e-7
    "unet": (True, 1e-5, 5e-4),              # JAX's own: 0, 3.0e-8
    "enet": (False, 1e-5, 5e-4),             # JAX's own: 4.3e-4, 2.4e-3
    "enet_jax_spatial": (True, 1e-3, 5e-3),  # (JAX's own gap, rounded up)
}
JAX_MODELS = {case.replace("_jax_spatial", "") for case in JAX_BARS}
# the JAX package's weight converters, by architecture
TO_FLAX = {"deeplab": jx_pretrained.deeplab_state_dict_to_flax,
           "enet": jx_pretrained.enet_state_dict_to_flax,
           "fastscnn": jx_pretrained.fastscnn_state_dict_to_flax,
           "unet": jx_pretrained.unet_state_dict_to_flax}


def _conv_case(rng, name, h, cin, cout, k, stride, pad, dilation, w=6):
    x = rng.randn(2, cin, h, w)
    weight = rng.randn(cout, cin, k, k)
    out = F.conv2d(torch.from_numpy(x), torch.from_numpy(weight), None, stride,
                   (pad, pad), dilation)
    return {"name": name, "kind": "conv", "x": x, "weight": weight, "stride": stride,
            "pad": pad, "dilation": dilation, "groups": 1, "edge": (0, 0),
            "dy": rng.randn(*out.shape)}


def primitive_cases(rng):
    """The stem pool on a negative input (the global top's -inf edge
    decides the first row) and on small integers (ties within and across
    the bands' edges), with its selector; ENet's transposed conv and its
    unpool (a selector from a tie-rich pool, so windows collide); the
    pyramid pool's bins 2, 3 and 6 over 8 rows (bins straddle the bands'
    edges); the resize of a replicated 3x3 and 1x1 map; ResNet's 7x7
    stride-2 stem and ENet's 3x3 at dilation 16 on an 8-row map, whose
    halo reaches past the neighbour and the image."""
    cases = []
    for name, x in (("max_pool_negative", rng.randn(2, 3, 16, 10) - 4.0),
                    ("max_pool_ties", rng.randint(-3, 0, (2, 3, 16, 10)).astype(float))):
        cases.append({"name": name, "kind": "max_pool", "x": x,
                      "dy": rng.randn(2, 3, 8, 5)})
    cases.append({"name": "conv_transpose", "kind": "conv_transpose",
                  "x": rng.randn(2, 4, 8, 6), "weight": rng.randn(4, 3, 3, 3),
                  "dy": rng.randn(2, 3, 16, 12)})
    _, selector = pt_enet.max_pool_with_indices(
        torch.from_numpy(rng.randint(0, 2, (2, 3, 16, 12)).astype(float)))
    cases.append({"name": "unpool", "kind": "unpool", "x": rng.randn(2, 3, 8, 6),
                  "selector": selector.numpy(), "dy": rng.randn(2, 3, 16, 12)})
    for size in (2, 3, 6):
        cases.append({"name": f"adaptive_pool_{size}", "kind": "adaptive_pool",
                      "x": rng.randn(2, 3, 8, 6), "size": size,
                      "dy": rng.randn(2, 3, size, size)})
    for side, (oh, ow) in ((3, (16, 10)), (1, (8, 5))):
        cases.append({"name": f"resize_replicated_{side}", "kind": "resize_replicated",
                      "x": rng.randn(2, 3, side, side), "out": (oh, ow),
                      "dy": rng.randn(2, 3, oh, ow)})
    cases += [_conv_case(rng, "stem7x7", 16, 3, 4, 7, 2, 3, 1),
              _conv_case(rng, "dilated16", 8, 3, 2, 3, 1, 16, 16)]
    return cases


CASE_NAMES = [c["name"] for c in primitive_cases(np.random.RandomState(0))]


def model_setup(rng, name, images):
    """MODELS[name] (its weights ``workers.zoo_state_dict``'s, which every
    rank draws for itself), ``images`` uint8 images of side 64 whose labels are
    ignored in rows 0-19 only (every one in rank 0's band) and class
    weights in [0.5, 2] on a 1/8 grid. The port's loss sums its normalizer
    (the valid pixels' weights) in f32, as the JAX package's does; with
    weights off that grid the sum's order (one process, or the ranks'
    partial sums) moves it by an f32 ulp, which scales every gradient by
    ~6e-8 (3.5e-9 of the largest weight after a ResNet-50 step on (2x2)).
    On the grid the sum is exact, so the f64 comparison sees the sharded
    arithmetic alone."""
    arch, backbone, os_ = MODELS[name]
    blocks = rng.randint(0, CLASSES, (images, 4, 4))
    label = np.kron(blocks, np.ones((1, SIDE // 4, SIDE // 4), int)).astype(np.uint8)
    image = np.stack([label * 13 + 5, 250 - label * 11, (label * 97) % 251], -1)
    image = np.clip(image + rng.randint(-8, 9, image.shape), 0, 255).astype(np.uint8)
    label[:, :20] = 255
    return {"arch": arch, "backbone": backbone, "os": os_, "classes": CLASSES,
            "image": image, "label": label,
            "cw": (rng.randint(4, 17, CLASSES) / 8).astype(np.float32)}


def spawn(name, setup, tmp_path):
    world, spatial = MESHES[name]
    setup_path = str(tmp_path / "setup.pt")
    torch.save(setup, setup_path)
    pt_mesh.launch(workers.spatial_zoo_checks, (setup_path, str(tmp_path)),
                   num_devices=world, device="cpu", timeout=GROUP_TIMEOUT_S,
                   join_timeout=JOIN_TIMEOUT_S, spatial=spatial)
    return [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh name: (setup, every rank's results)}."""
    out = {}
    for k, (name, images) in enumerate((("1x2", 2), ("1x4", 0), ("2x2", 2))):
        setup = {"prims": [] if name == "2x2" else primitive_cases(
            np.random.RandomState(0)), "models": {},
            "f32": [m for m in MODELS if name == "1x2" and m in JAX_MODELS],
            "dropout_seed": 7}
        if images:
            setup["models"] = {m: model_setup(np.random.RandomState(k), m, images)
                               for m in MODELS}
        out[name] = (setup, spawn(name, setup, tmp_path_factory.mktemp(name)))
    return out


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _every_rank(ranks, model, step):
    """The loss of a step that every rank ended with the same: the same
    loss and the same tensors (digests) as rank 0."""
    loss, digest = ranks[0][model][step][:2]
    assert all(r[model][step][:2] == (loss, digest) for r in ranks)
    return loss


# -------------------------------------------------------------- primitives

def _whole(case):
    """The case's whole-tensor forward and gradients (f64): (y, dx, dw or
    selector or None)."""
    from deep_active_semantic_segmentation_torch.models.fastscnn import (
        adaptive_pool_matrix)

    x = torch.from_numpy(case["x"]).requires_grad_(True)
    dy = torch.from_numpy(case["dy"])
    extra = None
    if case["kind"] == "conv":
        w = torch.from_numpy(case["weight"]).requires_grad_(True)
        y = F.conv2d(x, w, None, case["stride"], case["pad"], case["dilation"])
    elif case["kind"] == "conv_transpose":
        w = torch.from_numpy(case["weight"]).requires_grad_(True)
        y = F.conv_transpose2d(x, w, None, 2, 1, 1)
    elif case["kind"] == "max_pool":
        y, extra = pt_enet.max_pool_with_indices(x)
        assert torch.equal(y, F.max_pool2d(x, 3, 2, 1))
    elif case["kind"] == "unpool":
        y = pt_enet.max_unpool2x(x, torch.from_numpy(case["selector"]))
    elif case["kind"] == "adaptive_pool":
        size = case["size"]
        y = torch.einsum("ph,bchw,qw->bcpq",
                         adaptive_pool_matrix(x.shape[2], size, "cpu", x.dtype), x,
                         adaptive_pool_matrix(x.shape[3], size, "cpu", x.dtype))
        assert _rel(y.detach(), F.adaptive_avg_pool2d(x, size).detach()) <= 1e-14
    else:
        y = F.interpolate(x, size=case["out"], mode="bilinear", align_corners=True)
    (y * dy).sum().backward()
    if case["kind"] in ("conv", "conv_transpose"):
        extra = w.grad.numpy()
    return y.detach().numpy(), x.grad.numpy(), extra


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("mesh_name", ["1x2", "1x4"])
def test_primitive_equals_the_whole_tensor(runs, mesh_name, name):
    """Each rank's band of the forward, and the bands of the input
    gradient, equal the whole tensor's (f64, 1e-12 of the largest); a
    conv's weight gradient is the sum of the ranks'; the pool's selector
    is the whole image's, exactly. The pyramid pool is the whole map on
    every rank, its gradient each rank's band times the world
    (``cross_replica_sum``'s convention); the replicated map's resize
    sums its ranks' gradients."""
    setup, ranks = runs[mesh_name]
    i = CASE_NAMES.index(name)
    case = setup["prims"][i]
    y, dx, extra = _whole(case)
    got = [r["prims"][i] for r in ranks]
    n = len(ranks)
    if case["kind"] == "adaptive_pool":
        for g in got:
            assert _rel(g["y"], y) <= 1e-12
        assert _rel(np.concatenate([g["dx"] for g in got], 2) / n, dx) <= 1e-12
        return
    assert _rel(np.concatenate([g["y"] for g in got], 2), y) <= 1e-12
    if case["kind"] == "resize_replicated":
        assert _rel(sum(g["dx"] for g in got), dx) <= 1e-12
        return
    assert _rel(np.concatenate([g["dx"] for g in got], 2), dx) <= 1e-12
    if case["kind"] == "max_pool":
        assert np.array_equal(np.concatenate([g["selector"] for g in got], 2),
                              extra.numpy())
    elif case["kind"] in ("conv", "conv_transpose"):
        assert _rel(sum(g["dw"] for g in got), extra) <= 1e-12


def test_the_pool_edge_is_minus_infinity_at_the_global_top_only(runs):
    """On the negative input the pool's first output row differs from a
    zero-padded pool's (so the -inf edge is tested), and rank 1's first
    row reads rank 0's last row, not the padding."""
    setup, ranks = runs["1x2"]
    case = setup["prims"][CASE_NAMES.index("max_pool_negative")]
    x = torch.from_numpy(case["x"])
    zero_padded = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
    assert (zero_padded[:, :, 0] == 0).all()
    got = ranks[0]["prims"][CASE_NAMES.index("max_pool_negative")]["y"]
    assert (got[:, :, 0] < 0).all()
    band1 = ranks[1]["prims"][CASE_NAMES.index("max_pool_negative")]["y"]
    assert np.array_equal(band1[:, :, 0], F.max_pool2d(x, 3, 2, 1)[:, :, 4].numpy())


# -------------------------------------------------------------- the steps

@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("mesh_name", ["1x2", "2x2"])
def test_spatial_step_equals_the_one_process_step(runs, mesh_name, model):
    """Each model's spatial step at side 64 (dropout on, f64) equals one
    process's step on the whole batch: every parameter and the BN running
    statistics within 1e-10 of the largest, on every rank; the loss,
    which every port loss computes in f32, within 1e-6 relative. Rank 0
    runs the one-process step too and compares the states itself."""
    _, ranks = runs[mesh_name]
    got_loss = _every_rank(ranks, model, "f64")
    loss, gap = ranks[0][model]["one_process"]
    assert abs(got_loss - loss) <= 1e-6 * abs(loss)
    assert gap <= 1e-10, gap


class FrozenNoDropout:
    """The JAX model in the train step with dropout off and batch norm at
    its running statistics."""

    def __init__(self, model):
        self.model = model

    def apply(self, *args, **kwargs):
        kwargs["train"] = False
        return self.model.apply(*args, use_dropout=False, **kwargs)


def jax_spatial_step(spec, spatial: bool = True):
    """The JAX package's step (dropout off, BN at running statistics, SGD
    lr 0.01, momentum 0.9, weight decay 5e-4) with the setup's weights on
    a (1x2) mesh of the conftest's virtual devices, height-sharded
    (``spatial``) or on one device: (loss, new params)."""
    arch = spec["arch"]
    sd = {k: v.numpy().copy() for k, v in workers.zoo_state_dict(spec).items()}
    params, stats = (TO_FLAX[arch](sd, spec["backbone"]) if arch == "deeplab"
                     else TO_FLAX[arch](sd))
    jmodel = jx_factory.build_model(arch, spec["classes"], backbone=spec["backbone"],
                                    output_stride=spec["os"], mc_dropout=True)
    mesh = jx_make_mesh(2, spatial=2) if spatial else None
    state = jx_steps.TrainState(
        params=params, batch_stats=stats, opt_state=jx_optim.init_opt_state(params, "SGD"),
        step=jnp.zeros((), jnp.int32))
    if mesh is not None:
        state = jx_steps.place_replicated(state, mesh)
    step = jx_steps.make_train_step(
        FrozenNoDropout(jmodel), loss_mode="ce", class_weights=spec["cw"],
        schedule=lambda i, dyn=None: jnp.float32(0.01),
        lr_mults=jx_factory.lr_multiplier_tree(params, arch), optimizer="SGD",
        opt_cfg=jx_optim.SGDConfig(0.9, 5e-4, False), mesh=mesh, spatial=spatial)
    new, metrics = step(state, {"image": jnp.asarray(spec["image"]),
                                "label": jnp.asarray(spec["label"])},
                        jax.random.PRNGKey(0))
    return float(metrics["loss"]), jax.tree_util.tree_map(np.asarray, new.params)


def _param_gap(spec, got_state, params):
    """The largest difference of the port's updated weights from
    ``params`` (JAX's), over the largest JAX weight."""
    arch = spec["arch"]
    sd = {k: v.numpy().copy() for k, v in got_state.items()}
    got, _ = (TO_FLAX[arch](sd, spec["backbone"]) if arch == "deeplab"
              else TO_FLAX[arch](sd))
    scale = max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(params))
    err = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - b).max()), got, params)))
    return err / scale


@pytest.mark.parametrize("case", list(JAX_BARS))
def test_spatial_step_equals_jax_spatial_step(runs, case):
    """The f32 spatial step (dropout off, BN at running statistics) on the
    (1x2) mesh against the JAX package's ``make_train_step(spatial=True)``
    on a (1x2) mesh of the conftest's virtual devices (ENet: and its
    unsharded step), the port's weights carried over: the loss and the
    weights within ``JAX_BARS[case]`` (one process's f32 step measured
    2.2e-6 and 8.6e-5 for ResNet-50 os16, 2.3e-6 and 1.9e-6 at os8,
    1.4e-6 and 1.9e-6 for FastSCNN, 5.5e-7 and 6.0e-8 for the UNet; ENet
    1.5e-6 and 2.1e-6 against the unsharded step, 4.3e-4 and 2.4e-3
    against the spatial one)."""
    model = case.replace("_jax_spatial", "")
    spatial, loss_bar, weight_bar = JAX_BARS[case]
    setup, ranks = runs["1x2"]
    spec = setup["models"][model]
    ref, params = jax_spatial_step(spec, spatial)
    got_loss = _every_rank(ranks, model, "f32")
    got = ranks[0][model]["f32"][2]
    assert workers.state_digest(got) == ranks[0][model]["f32"][1]
    gap = _param_gap(spec, got, params)
    assert abs(got_loss - ref) <= loss_bar * abs(ref), (got_loss, ref)
    assert gap <= weight_bar, gap


def test_jax_spatial_step_zero_pads_enets_initial_pool():
    """A fault on the JAX side (ROADMAP C): ENet's initial block (JAX
    models/enet.py:167-175: a 3x3 / stride 2 conv beside a 3x3 / stride 2
    ``reduce_window`` max with -inf padding, concatenated) jitted with the
    spatial step's ``P('data', 'spatial')`` input sharding pools its first
    output row over zero padding, not -inf: where every pixel of a window
    in rows 0-1 of the normalized image is negative it returns 0 there.
    Every other row, and the whole-image pool, is torch's ``max_pool2d``
    (the port's, whose -inf edge the primitive tests hold on bands)."""
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deep_active_semantic_segmentation_tpu.selection.kernels import (
        normalize_on_device)

    spec = model_setup(np.random.RandomState(0), "enet", 2)
    sd = {k: v.numpy().copy() for k, v in workers.zoo_state_dict(spec).items()}
    kernel = jx_pretrained.enet_state_dict_to_flax(sd)[0]["initial_block"][
        "main_branch"]["kernel"]

    def block(image):
        x = normalize_on_device(image)
        main = lax.conv_general_dilated(x, kernel, (2, 2), [(1, 1), (1, 1)],
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
        pool = lax.reduce_window(x, -jnp.inf, lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                 [(0, 0), (1, 1), (1, 1), (0, 0)])
        return jnp.concatenate([main, pool], -1)

    sharding = NamedSharding(jx_make_mesh(2, spatial=2), P("data", "spatial"))
    whole = np.asarray(jax.jit(block)(spec["image"]))
    sharded = np.asarray(jax.jit(block, in_shardings=(sharding,))(
        jax.device_put(spec["image"], sharding)))
    assert np.array_equal(sharded[..., :13], whole[..., :13])     # the conv
    whole, sharded = whole[..., 13:], sharded[..., 13:]
    x = np.array(jax.jit(normalize_on_device)(spec["image"]))
    torch_pool = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1)
    assert np.array_equal(whole, torch_pool.permute(0, 2, 3, 1).numpy())
    assert np.array_equal(sharded[:, 1:], whole[:, 1:])
    assert (whole[:, 0] < 0).any()
    assert np.array_equal(sharded[:, 0], np.maximum(whole[:, 0], 0))


class _ContiguousOnly:
    """A one-rank stand-in for a mesh whose all-reduce, as NCCL's, refuses
    a tensor that is not contiguous."""

    distributed = True

    def all_reduce(self, tensor):
        assert tensor.is_contiguous(), tensor.stride()
        return tensor


def test_cross_replica_sum_hands_the_collective_contiguous_tensors():
    """The pyramid pool's sum over the ranks gets an einsum's output (here
    a transposed view) and, backward, whatever strides the gradient has:
    both cross as contiguous copies (NCCL refused the pool's einsum
    output on two cards)."""
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        cross_replica_sum)

    x = torch.randn(2, 3, 4, 5, dtype=torch.float64).transpose(2, 3).requires_grad_(True)
    assert not x.is_contiguous()
    y = cross_replica_sum(x, _ContiguousOnly())
    y.backward(torch.randn(2, 3, 4, 5, dtype=torch.float64).transpose(2, 3))
    assert torch.equal(y, x) and x.grad.shape == x.shape


# --------------------------------------------------------------- refusals

@pytest.mark.parametrize("model", list(MODELS))
def test_a_height_that_does_not_split_is_refused(model):
    """Each model's row multiple (its largest stride) splits the height:
    ``shard_rows`` refuses a height that does not split over the spatial
    ranks at that multiple, and the model's forward refuses such a band
    before any collective runs (a two-rank axis with no process group)."""
    arch, backbone, os_ = MODELS[model]
    net = build_model(arch, CLASSES, backbone=backbone, output_stride=os_, device="cpu")
    multiple = pt_spatial.row_multiple(net)
    assert multiple == {"deeplab": os_, "enet": 8, "fastscnn": 32, "unet": 8}[arch]
    mesh = pt_mesh.Mesh(0, 2, spatial=2)
    assert pt_spatial.shard_rows(2 * multiple, mesh, multiple) == (0, multiple)
    with pytest.raises(ValueError, match=rf"height % \(spatial \* {multiple}\) == 0"):
        pt_spatial.shard_rows(2 * multiple + 2, mesh, multiple)
    band = torch.zeros(1, 3, multiple + 2, 2 * multiple)
    with pytest.raises(ValueError, match=rf"height % \(spatial \* {multiple}\) == 0"):
        with pt_spatial.spatial_rows(net, pt_mesh.Mesh(0, 2)):
            net(band)
