"""The port's data-parallel runtime (parallel/{mesh,crossreplica}.py, the
global loss normalizers, the data-parallel train and eval steps) on two
gloo ranks on the CPU, against the JAX package on a 2-device mesh of the
conftest's virtual CPU devices and against the port's own one-rank run.

The two ranks run once for the whole module (one ``launch`` of
``torch_parallel_workers.parallel_checks``); the tests read what they
saved. Every spawn has its own limit: the process group's timeout and a
join timeout, so a stuck rank fails the test instead of hanging it.

Tolerances: BN statistics 1e-6 relative (f32 sums against the ranks' f64
ones); BN gradients and the losses' gradients 1e-5 of the largest (f32
sums in another order); the train step against JAX as
test_torch_train.py holds one train-mode step (loss 1e-4 relative,
running means 1e-3 relative / 1e-5 absolute), its updated weights within
1e-4 of the largest weight (measured 2.1e-5: one SGD step at lr 0.01
moves a weight by 1e-2 of its gradient's error); the dropout step against
the one-rank port step with the same masks, both in f64, within 1e-6 of
the largest weight; the eval confusion exactly."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.models.factory import (
    build_model, param_groups)
from deep_active_semantic_segmentation_torch.models.layers import (
    ChannelDropout, dropout_rows)
from deep_active_semantic_segmentation_torch.ops import losses as pt_losses
from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
    constant_schedule)
from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
from deep_active_semantic_segmentation_torch.parallel.steps import make_train_step
from deep_active_semantic_segmentation_tpu.models.deeplab import DeepLab as JaxDeepLab
from deep_active_semantic_segmentation_tpu.models.factory import lr_multiplier_tree
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    deeplab_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.ops import losses as jx_losses
from deep_active_semantic_segmentation_tpu.parallel import crossreplica as jx_crossreplica
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.parallel import steps as jx_steps
from deep_active_semantic_segmentation_tpu.parallel.mesh import make_mesh as jx_make_mesh
from torch_port_helpers import NUM_CLASSES, one_torch_thread  # noqa: F401
import torch_parallel_workers as workers

WORLD = 2
SIDE = 33
JOIN_TIMEOUT_S = 240      # a spawn's limit (the ranks take ~15 s here)
GROUP_TIMEOUT_S = 120     # a collective's limit inside the ranks
LOSS_CASES = [(kind, ba) for kind in ("ce", "weighted_ce", "focal",
                                      "weighted_focal", "sample_weighted")
              for ba in (True, False)]


def spawn(fn, setup, tmp_path):
    """Run ``fn`` on WORLD gloo ranks on the CPU with ``setup``; each
    rank's saved results."""
    setup_path = str(tmp_path / "setup.pt")
    torch.save(setup, setup_path)
    pt_mesh.launch(fn, (setup_path, str(tmp_path)), num_devices=WORLD,
                   device="cpu", timeout=GROUP_TIMEOUT_S,
                   join_timeout=JOIN_TIMEOUT_S)
    return [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


class NoDropout:
    """The JAX model with dropout off in its train-mode apply (the JAX
    package's make_train_step applies the model with its default)."""

    def __init__(self, model):
        self.model = model

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, use_dropout=False, **kwargs)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the port model's init carried to JAX, and both ranks'
    results."""
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(4)
    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device="cpu",
                        generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    blocks = rng.randint(0, NUM_CLASSES, (4, 3, 3))
    label = np.kron(blocks, np.ones((1, 11, 11), int)).astype(np.uint8)
    image = np.stack([label * 13 + 5, 250 - label * 11, (label * 97) % 251], -1)
    image = np.clip(image + rng.randint(-8, 9, image.shape), 0, 255).astype(np.uint8)
    label[:, :2] = 255
    label[0, :20] = 255                    # the ranks' valid counts differ
    eval_label = label.copy()
    eval_label[3] = 255                    # a padded partial batch: 3 valid
    logits = (3 * rng.randn(4, 5, 9, 11)).astype(np.float32)
    target = rng.randint(0, 5, (4, 9, 11))
    void = rng.rand(*target.shape) < np.array([0.7, 0.7, 0.05, 0.05])[:, None, None]
    target[void] = 255
    setup = {
        "bn_x": (2 + 3 * rng.randn(4, 3, 5, 6)).astype(np.float32),
        "bn_dy": rng.randn(4, 3, 5, 6).astype(np.float32),
        "bn_w": rng.uniform(0.5, 1.5, 3).astype(np.float32),
        "bn_b": rng.randn(3).astype(np.float32),
        "loss_cases": LOSS_CASES, "logits": logits, "target": target,
        "cw5": rng.uniform(0.2, 3.0, 5).astype(np.float32),
        "sw": np.asarray([0.3, 1.7, 0.9, 1.2], np.float32),
        "state_dict": state_dict, "image": image, "label": label,
        "eval_label": eval_label,
        "cw": rng.uniform(0.5, 2.0, NUM_CLASSES).astype(np.float32),
        "dropout_seed": 7,
    }
    ranks = spawn(workers.parallel_checks, setup, tmp_path_factory.mktemp("par"))
    return setup, ranks


def _jax_params(state_dict):
    return deeplab_state_dict_to_flax(
        {k: v.numpy().copy() for k, v in state_dict.items()}, "mobilenet")


def _close(got, want, tol):
    err, scale = np.abs(np.asarray(got) - np.asarray(want)).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


# ------------------------------------------------------- cross-replica BN

def test_batch_norm_stats_equal_jax_and_whole_batch(case):
    setup, ranks = case
    x = setup["bn_x"]
    nhwc = np.transpose(x, (0, 2, 3, 1))
    mesh = jx_make_mesh(WORLD)
    jmean, jvar = jax.shard_map(
        lambda xs: jx_crossreplica.batch_norm_stats(xs, axis_name="data"),
        mesh=mesh, in_specs=jax.sharding.PartitionSpec("data"),
        out_specs=jax.sharding.PartitionSpec(), check_vma=False)(nhwc)
    whole = x.astype(np.float64)
    for mean, var, n in (r["bn_stats"] for r in ranks):
        assert n == x.size // x.shape[1]
        for got, ref in ((mean, jmean), (var, jvar),
                         (mean, whole.mean((0, 2, 3))), (var, whole.var((0, 2, 3)))):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6)


def test_cross_replica_bn_equals_one_rank_bn_on_the_whole_batch(case):
    setup, ranks = case
    bn = torch.nn.BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(setup["bn_w"]))
        bn.bias.copy_(torch.from_numpy(setup["bn_b"]))
    x = torch.from_numpy(setup["bn_x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(setup["bn_dy"])).sum().backward()
    got = {k: np.concatenate([r["bn"][k] for r in ranks]) for k in ("y", "dx")}
    _close(got["y"], y.detach().numpy(), 1e-5)
    _close(got["dx"], x.grad.numpy(), 1e-5)
    # the parameters' gradients: the ranks' sum (what DDP's mean over a
    # world-scaled loss gives) is the whole batch's
    _close(sum(r["bn"]["dw"] for r in ranks), bn.weight.grad.numpy(), 1e-5)
    _close(sum(r["bn"]["db"] for r in ranks), bn.bias.grad.numpy(), 1e-5)
    # running statistics with the GLOBAL count's unbiased variance
    for r in ranks:
        np.testing.assert_allclose(r["bn"]["running_mean"], bn.running_mean.numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["bn"]["running_var"], bn.running_var.numpy(),
                                   rtol=1e-6)


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("kind,batch_average", LOSS_CASES)
def test_global_loss_normalizers(case, kind, batch_average):
    """The 2-rank loss is the whole batch's (JAX's value, as
    test_torch_train.py::test_losses_equal_jax holds the one-rank loss),
    on every rank, although rank 0 holds far fewer valid pixels; each
    rank's logits gradient is world times the whole batch's rows (DDP's
    mean then gives the whole batch's gradient)."""
    setup, ranks = case
    logits, target = setup["logits"], setup["target"]
    cw = setup["cw5"] if kind.startswith("weighted") else None
    jl = jnp.asarray(np.transpose(logits, (0, 2, 3, 1)))
    jt = jnp.asarray(target.astype(np.float32))
    pl = torch.from_numpy(logits).requires_grad_(True)
    pt = torch.from_numpy(target)
    if kind == "sample_weighted":
        ref = jx_losses.sample_weighted_cross_entropy(
            jl, jt, jnp.asarray(setup["sw"]), setup["cw5"], batch_average=batch_average)
        one = pt_losses.sample_weighted_cross_entropy(
            pl, pt, torch.from_numpy(setup["sw"]), setup["cw5"],
            batch_average=batch_average)
    elif "focal" in kind:
        ref = jx_losses.focal_loss(jl, jt, class_weights=cw, batch_average=batch_average)
        one = pt_losses.focal_loss(pl, pt, class_weights=cw, batch_average=batch_average)
    else:
        ref = jx_losses.cross_entropy(jl, jt, class_weights=cw,
                                      batch_average=batch_average)
        one = pt_losses.cross_entropy(pl, pt, class_weights=cw,
                                      batch_average=batch_average)
    one.backward()
    valid = [(setup["target"][2 * r:2 * r + 2] != 255).sum() for r in range(WORLD)]
    assert valid[0] < valid[1] / 2
    for r, rank in enumerate(ranks):
        value, grad = rank["losses"][(kind, batch_average)]
        # JAX within 5e-6 (the one-rank port's own gap to it, on these
        # ~400 weighted pixels, is 2.5e-6), the one-rank port within 1e-6
        np.testing.assert_allclose(value, float(ref), rtol=5e-6, atol=1e-7)
        np.testing.assert_allclose(value, float(one), rtol=1e-6, atol=1e-7)
        _close(grad / WORLD, pl.grad.numpy()[2 * r:2 * r + 2], 1e-5)


# -------------------------------------------------------------- train step

def test_train_step_matches_jax_on_a_two_device_mesh(case):
    """One train-mode SGD step, dropout off, against the JAX package's
    make_train_step on make_mesh(2): the loss, the updated weights, the
    running means; and both ranks end with the same tensors (BN buffers
    included: DDP does not broadcast them)."""
    setup, ranks = case
    params, stats = _jax_params(setup["state_dict"])
    jmodel = JaxDeepLab(num_classes=NUM_CLASSES, backbone="mobilenet",
                        output_stride=16, mc_dropout=True)
    mesh = jx_make_mesh(WORLD)
    state = jx_steps.place_replicated(jx_steps.TrainState(
        params=params, batch_stats=stats,
        opt_state=jx_optim.init_opt_state(params, "SGD"),
        step=jnp.zeros((), jnp.int32)), mesh)
    step = jx_steps.make_train_step(
        NoDropout(jmodel), loss_mode="ce", class_weights=setup["cw"],
        schedule=lambda i, dyn=None: jnp.float32(0.01),
        lr_mults=lr_multiplier_tree(params, "deeplab"), optimizer="SGD",
        opt_cfg=jx_optim.SGDConfig(0.9, 5e-4, False), mesh=mesh)
    new, metrics = step(state, {"image": jnp.asarray(setup["image"]),
                                "label": jnp.asarray(setup["label"])},
                        jax.random.PRNGKey(0))
    (loss0, sd0), (loss1, sd1) = (r["step"] for r in ranks)
    assert loss0 == loss1
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert abs(loss0 - float(metrics["loss"])) <= 1e-4 * abs(float(metrics["loss"]))
    got_params, got_stats = _jax_params(sd0)
    scale = max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(new.params))
    err = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), got_params, new.params)))
    assert err <= 1e-4 * scale, (err, scale)
    for path, got in jax.tree_util.tree_flatten_with_path(got_stats)[0]:
        if path[-1].key == "mean":
            ref = new.batch_stats
            for p in path:
                ref = ref[p.key]
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-3, atol=1e-5)


def test_dropout_step_equals_the_one_rank_port_step(case):
    """Dropout on: each rank keeps its rows of the global batch's masks,
    so two ranks take the one-rank step of the same generator. In f64
    (weights and image; the loss is f32), as f32 rounding in this
    train-mode BN step moves early BN biases by 1e-3 of the largest
    weight on either side (measured against an f64 step: 1.2e-3 one
    rank, 1.3e-3 two ranks)."""
    setup, ranks = case
    model = workers._deeplab(setup["state_dict"], None).double()
    step = make_train_step(
        model, build_optimizer("SGD", param_groups(model, "deeplab")),
        pt_losses.build_loss("ce", class_weights=torch.from_numpy(setup["cw"])),
        constant_schedule(0.01),
        generator=torch.Generator().manual_seed(setup["dropout_seed"]))
    loss = float(step({"image": torch.from_numpy(workers.f64_image(setup["image"])),
                       "label": torch.from_numpy(setup["label"])}, 0)["loss"])
    got_loss, got = ranks[0]["dropout_step"]
    assert abs(got_loss - loss) <= 1e-6 * loss
    scale = max(float(v.abs().max()) for v in model.state_dict().values()
                if v.is_floating_point())
    err = max(float((got[k] - v).abs().max()) for k, v in model.state_dict().items()
              if v.is_floating_point())
    assert err <= 1e-6 * scale, (err, scale)
    assert abs(ranks[0]["dropout_step"][0] - ranks[0]["step"][0]) > 1e-3  # dropout acted


def test_dropout_rows_are_the_global_batch_masks():
    drop = ChannelDropout(0.5)
    x = torch.ones(4, 6, 2, 2)
    whole = drop(x, torch.Generator().manual_seed(3))
    model = torch.nn.Sequential(drop)
    for rank in range(WORLD):
        with dropout_rows(model, rank, WORLD):
            got = drop(x[:2], torch.Generator().manual_seed(3))
        assert torch.equal(got, whole[2 * rank:2 * rank + 2])
    assert drop.rows == (0, 1)


# --------------------------------------------------------------- eval step

def test_eval_confusion_equals_jax_mesh_exactly(case):
    """A padded partial batch (3 valid of 4; the ranks hold 2 and 1): the
    confusion all-reduced over the ranks equals the JAX eval step's on
    the mesh, and the loss divides by the global valid count."""
    setup, ranks = case
    params, stats = _jax_params(setup["state_dict"])
    jmodel = JaxDeepLab(num_classes=NUM_CLASSES, backbone="mobilenet",
                        output_stride=16, mc_dropout=True)
    mesh = jx_make_mesh(WORLD)
    ev = jx_steps.make_eval_step(jmodel, NUM_CLASSES, mesh=mesh)
    out = ev(jx_steps.TrainState(params=params, batch_stats=stats, opt_state=None,
                                 step=jnp.zeros((), jnp.int32)),
             {"image": jnp.asarray(setup["image"]),
              "label": jnp.asarray(setup["eval_label"])}, 3)
    assert [r["eval"]["nvalid"] for r in ranks] == [2, 1]
    for r in ranks:
        np.testing.assert_array_equal(r["eval"]["confusion"],
                                      np.asarray(out["confusion"]).astype(np.int64))
        np.testing.assert_allclose(r["eval"]["loss"], float(out["loss"]), rtol=1e-5)


# -------------------------------------------------------------------- mesh

def test_one_rank_mesh_is_the_plain_path():
    mesh = pt_mesh.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.main) == (0, 1, None, True)
    x = torch.arange(3.0)
    assert mesh.all_reduce(x) is x and mesh.broadcast_object(5) == 5
    assert torch.equal(mesh.gather_rows({1: x[2:], 0: x[:2]}), x)
    mesh.barrier()
    mesh.assert_same([1], "anything")


def test_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        pt_mesh.process_batch_slice(5, 0, 2)
    assert pt_mesh.process_batch_slice(8, 1, 2) == (4, 4)
    with pytest.raises(ValueError, match="launch or torchrun"):
        pt_mesh.make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_mesh.launch(print, num_devices=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA cards; 1 visible"):
        pt_mesh.launch(print, num_devices=2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="NCCL runs one rank on each card"):
        pt_mesh.make_mesh(device="cuda:0", backend="nccl")


def test_a_failing_rank_ends_the_run(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the run ends with
    the rank's error, rank 0 terminated, well inside the limit."""
    import time

    from torch.multiprocessing.spawn import ProcessRaisedException

    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException):
        spawn(workers.failing_rank, {}, tmp_path)
    assert time.monotonic() - t0 < JOIN_TIMEOUT_S


# ------------------------------------------------------------- cuda_build

_BUILD_TWICE = r"""
import sys
from pathlib import Path
from deep_active_semantic_segmentation_torch import cuda_build
cuda_build.BUILD_DIR = Path(sys.argv[1])
cuda_build.build(["fake"], csrc=Path(sys.argv[2]))
"""


def test_ranks_that_build_together_run_the_compiler_once(tmp_path):
    """Two processes build the same source at once with a stub nvcc that
    logs each run and takes a second: the file lock lets one compile and
    the other load its library."""
    csrc, build_dir, home = tmp_path / "csrc", tmp_path / "build", tmp_path / "cuda"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// no kernel\n")
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "runs.log"
    stub = home / "bin" / "nvcc"
    stub.write_text("#!/bin/sh\n"
                    f"echo run >> {log}\n"
                    "sleep 1\n"
                    "while [ \"$1\" != \"-o\" ]; do shift; done\n"
                    "echo lib > \"$2\"\n")
    stub.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(home))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_TWICE, str(build_dir),
                               str(csrc)], env=env) for _ in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    assert log.read_text().splitlines() == ["run"]
    assert len(list(build_dir.glob("libfake-*.so"))) == 1
