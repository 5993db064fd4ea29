"""The SEM dataset and the standalone UNet trainer of the port
(``data/sem.py``, ``unet_train_torch.py``) against the JAX package's
(``data/sem.py``, ``unet_train.py``) on the same grayscale PNG folders.

The port ships SEM samples on its uint8 wire and normalizes on the
device with SEM's mean and std; the JAX package ships f32 samples
normalized on the host. Tolerances: the normalized images within 1 ulp
(measured: equal), masks and labels exact; one RMSprop step of
``UNet(1, 2)`` from the same weights: the loss within 1e-5 relative, every
parameter within 1e-4 of the largest weight wherever the first RMSprop
step is not steep in its gradient, and the gradients within 1e-5 of the
largest (see the step tests for why, and for the BN-on-batch-statistics
step of the two scripts themselves); ``get_loss_and_accuracy``: the loss
within 1e-5 relative, the accuracy exact."""

import os
import random
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import unet_train as jx_cli
import unet_train_torch as pt_cli
from deep_active_semantic_segmentation_torch.data import sem as pt_sem
from deep_active_semantic_segmentation_torch.data.loader import Loader as PtLoader
from deep_active_semantic_segmentation_torch.models.convert import (
    flax_to_unet_state_dict)
from deep_active_semantic_segmentation_torch.parallel.steps import ingest
from deep_active_semantic_segmentation_tpu.data import sem as jx_sem
from deep_active_semantic_segmentation_tpu.data.loader import Loader as JxLoader
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    unet_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.models.unet import UNet as JaxUNet
from deep_active_semantic_segmentation_tpu.ops import losses as jx_losses
from deep_active_semantic_segmentation_tpu.ops.lr_schedule import constant_schedule
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.parallel.steps import (
    TrainState, make_eval_step as jx_make_eval_step,
    make_train_step as jx_make_train_step)
from torch_port_helpers import draw_like, one_torch_thread  # noqa: F401

CROP = 32
LR = 0.001
NORM = (pt_sem.MEAN, pt_sem.STD)


@pytest.fixture(scope="module")
def sem_root(tmp_path_factory):
    """sem/{train,val}/{images,masks}: 3 and 2 grayscale PNGs of 40 x 52
    (short side above the crop, so FixScaleCrop resizes) with 0/255
    masks."""
    root = str(tmp_path_factory.mktemp("sem"))
    rng = np.random.RandomState(0)
    for split, n in (("train", 3), ("val", 2)):
        for sub in ("images", "masks"):
            os.makedirs(os.path.join(root, "sem", split, sub))
        for i in range(n):
            img = rng.randint(0, 256, (40, 52), dtype=np.uint8)
            mask = (rng.rand(40, 52) > 0.5).astype(np.uint8) * 255
            Image.fromarray(img).save(os.path.join(root, "sem", split, "images", f"{i}.png"))
            Image.fromarray(mask).save(os.path.join(root, "sem", split, "masks", f"{i}.png"))
    return root


def _as_network_input(image_u8):
    """A port sample's uint8 (H, W, 1) image as the UNet receives it."""
    batch = {"image": torch.from_numpy(image_u8[None]),
             "label": torch.zeros(1, 1, 1, dtype=torch.uint8)}
    return ingest(batch, NORM)[0][0].permute(1, 2, 0).numpy()


def _assert_item_equal(got, ref):
    assert got["image"].dtype == np.uint8 and got["image"].shape == (CROP, CROP, 1)
    assert ref["image"].shape == (CROP, CROP, 1)
    np.testing.assert_array_max_ulp(_as_network_input(got["image"]), ref["image"],
                                    maxulp=1)
    assert set(np.unique(ref["label"])) <= {0.0, 1.0}
    np.testing.assert_array_equal(got["label"], ref["label"].astype(np.uint8))


def test_sem_val_items_equal_jax(sem_root):
    jx = jx_sem.SEMData(CROP, "val", dataset_root=sem_root)
    pt = pt_sem.SEMData(CROP, "val", dataset_root=sem_root)
    assert len(jx) == len(pt) == 2
    for i in range(2):
        _assert_item_equal(pt.get_item(i), jx.get_item(i))


def test_sem_train_items_equal_jax_from_one_seed(sem_root):
    """The flip and the blur draw in the JAX package's order: the module
    ``random`` seeded as the port's ``rng`` gives the same samples, over
    two passes (so both branches of each draw are taken)."""
    jx = jx_sem.SEMData(CROP, "train", dataset_root=sem_root)
    pt = pt_sem.SEMData(CROP, "train", dataset_root=sem_root, rng=random.Random(5))
    random.seed(5)
    ref = [jx.get_item(i) for _ in range(2) for i in range(3)]
    got = [pt.get_item(i) for _ in range(2) for i in range(3)]
    for g, r in zip(got, ref, strict=True):
        _assert_item_equal(g, r)
    # the draws did something: not every pass gives the val geometry
    val_like = pt_sem.SEMData(CROP, "val", dataset_root=sem_root)
    assert any(not np.array_equal(g["image"], val_like.get_item(0)["image"])
               for g in got[0::3])


def _loaders(sem_root, seed=7):
    """(JAX loader, port loader) over the train split, batch 2, shuffled
    from seed 0, the transforms' draws from ``seed``."""
    random.seed(seed)
    jx = JxLoader(jx_sem.SEMData(CROP, "train", dataset_root=sem_root), 2,
                  shuffle=True, seed=0)
    pt = PtLoader(pt_sem.SEMData(CROP, "train", dataset_root=sem_root,
                                 rng=random.Random(seed)), 2, shuffle=True, seed=0)
    return jx, pt


def test_sem_loader_batches_reach_the_model_equal_to_jax(sem_root):
    """Two epochs of 3 samples at batch 2: the second batch's padded row
    keeps label 255 on both wires."""
    jx, pt = _loaders(sem_root)
    ref = [b for _ in range(2) for b in jx]
    got = [b for _ in range(2) for b in pt.device_batches()]
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref, strict=True):
        image, label = ingest(g, NORM)
        assert g["image"].dtype == torch.uint8 and tuple(image.shape) == (2, 1, CROP, CROP)
        np.testing.assert_array_max_ulp(image.permute(0, 2, 3, 1).numpy(), r["image"],
                                        maxulp=1)
        np.testing.assert_array_equal(label.numpy(), r["label"].astype(np.int64))
        assert g["nvalid"] == r["nvalid"]
    assert (got[1]["label"][1] == 255).all() and got[1]["nvalid"] == 1


@pytest.fixture(scope="module")
def unet_weights():
    """A JAX UNet(1, 2)'s (params, batch_stats) drawn with numpy, and the
    same weights as the port's state_dict."""
    shapes = jax.eval_shape(partial(JaxUNet(in_channels=1, num_classes=2).init,
                                    train=False),
                            {"params": jax.random.PRNGKey(0)},
                            jax.ShapeDtypeStruct((1, CROP, CROP, 1), jnp.float32))
    rng = np.random.RandomState(4)
    params, stats = draw_like(shapes["params"], rng), draw_like(shapes["batch_stats"], rng)
    return params, stats, flax_to_unet_state_dict(params, stats)


def _port_training(state_dict):
    model, optimizer, train_step, eval_step = pt_cli.build_unet_training(LR, "cpu")
    model.load_state_dict(state_dict)
    return model, optimizer, train_step, eval_step


def _jax_state(params, stats):
    return TrainState(params=params, batch_stats=stats,
                      opt_state=jx_optim.init_opt_state(params, "RMSprop"),
                      step=jnp.zeros((), jnp.int32))


def test_unet_mapping_holds_at_one_input_channel(unet_weights):
    params, stats, sd = unet_weights
    assert tuple(sd["dconv_down1.0.weight"].shape) == (32, 1, 3, 3)
    back_p, back_s = unet_state_dict_to_flax({k: v.numpy() for k, v in sd.items()})
    for ref, got in ((params, back_p), (stats, back_s)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, ref, got)


def _first_batches(sem_root):
    jx_loader, pt_loader = _loaders(sem_root)
    jx_batch = next(iter(jx_loader))
    pt_batch = next(iter(pt_loader.device_batches()))
    np.testing.assert_array_equal(pt_batch["label"].numpy(),
                                  jx_batch["label"].astype(np.uint8))
    return jx_batch, pt_batch


def _after(params, stats):
    return flax_to_unet_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                   jax.tree_util.tree_map(np.asarray, stats))


def _worst(got, ref, names):
    scale = max(ref[k].abs().max().item() for k in names)
    return max((got[k] - ref[k]).abs().max().item() for k in names) / scale


def test_one_rmsprop_step_with_bn_at_running_statistics_equals_jax(
        sem_root, unet_weights):
    """The SEM trainer's optimizer and loss, BN held at its running statistics
    in both packages (the repo's way of comparing steps: torch updates
    running_var with the unbiased batch variance, flax with the biased
    one; tests/test_torch_train.py holds that difference).

    RMSprop's first step is lr * g / (0.1 |g| + 1e-8): about 10 lr *
    sign(g) wherever |g| is well above 1e-7, and steep in g below, where
    the two frameworks' gradient rounding (measured: at most 1.6e-6
    absolute, 3e-6 of the largest gradient) moves it by up to 20 lr. So
    the step is held in its parts: the gradients within 1e-5 of the
    largest, the optimizer on the JAX gradients within 1e-6 of the largest
    weight, and the updated parameters within 1e-4 of the largest weight
    wherever |g| > 1e-5, where 0.1 |g| is 100 times eps and the step's
    slope in g at most 10 (the others, many of them dead ReLU inputs of
    the 4 x 4 bottom stage, within the optimizer's largest move of 10
    lr)."""
    params, stats, sd = unet_weights
    jx_batch, pt_batch = _first_batches(sem_root)
    model = JaxUNet(in_channels=1, num_classes=2)
    loss_fn = jx_losses.build_loss("ce", batch_average=False)
    lr_mults = jax.tree_util.tree_map(lambda _: 1.0, params)

    @jax.jit
    def jstep(p, opt_state, image, label):
        def compute(q):
            out = model.apply({"params": q, "batch_stats": stats}, image, train=False)
            return loss_fn(out, label)

        loss, grads = jax.value_and_grad(compute)(p)
        new_p, _ = jx_optim.apply_update("RMSprop", p, grads, opt_state, LR,
                                         lr_mults, jx_optim.RMSpropConfig())
        return new_p, grads, loss

    new_params, jgrads, jloss = jstep(
        params, jx_optim.init_opt_state(params, "RMSprop"),
        jnp.asarray(jx_batch["image"]), jnp.asarray(jx_batch["label"]))
    after, ref_grads = _after(new_params, stats), _after(jgrads, stats)

    def frozen(state_dict):
        net, optimizer, train_step, _ = _port_training(state_dict)
        net.train()
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.eval()
        return net, optimizer, train_step

    net, _, train_step = frozen(sd)
    out = train_step(pt_batch, 0)
    assert abs(float(out["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = {k: p.grad for k, p in net.named_parameters()}
    got = net.state_dict()
    assert _worst(grads, ref_grads, list(grads)) <= 1e-5
    scale = max(after[k].abs().max().item() for k in grads)
    steep = 0
    for k, g in grads.items():
        diff = (got[k] - after[k]).abs()
        flat = g.abs() > 1e-5
        if flat.any():
            assert diff[flat].max().item() <= 1e-4 * scale, k
        if not flat.all():
            steep += int((~flat).sum())
            assert diff[~flat].max().item() <= 10 * LR, k
    assert steep < sum(g.numel() for g in grads.values())
    moved = max((got[k] - sd[k]).abs().max().item() for k in grads)
    assert 5 * LR < moved <= 10 * LR * (1 + 1e-5)

    # the port's optimizer alone, on the JAX gradients
    from deep_active_semantic_segmentation_torch.parallel.optim import set_lr

    net, optimizer, _ = frozen(sd)
    for k, p in net.named_parameters():
        p.grad = ref_grads[k].clone()
    set_lr(optimizer, LR)
    optimizer.step()
    assert _worst(net.state_dict(), after, list(grads)) <= 1e-6


def test_the_scripts_rmsprop_step_equals_jax(sem_root, unet_weights):
    """The two scripts' own train steps (BN on batch statistics): the
    loss, the running means, and every parameter whose gradient is above
    1e-5 of the largest. RMSprop's first step is lr * g / (0.1 |g| +
    1e-8), about 10 lr * sign(g), so where the exact gradient is 0 (the
    bias of every conv that feeds a train-mode BN, which subtracts the
    batch mean) both packages move by their rounding noise, amplified:
    those are counted and bounded by the optimizer's largest move."""
    params, stats, sd = unet_weights
    jx_batch, pt_batch = _first_batches(sem_root)
    step = jx_make_train_step(
        JaxUNet(in_channels=1, num_classes=2), schedule=constant_schedule(LR),
        lr_mults=jax.tree_util.tree_map(lambda _: 1.0, params), optimizer="RMSprop",
        opt_cfg=jx_optim.RMSpropConfig(), mesh=None, batch_average=False)
    state, metrics = step(_jax_state(params, stats),
                          {"image": jx_batch["image"], "label": jx_batch["label"]},
                          jax.random.PRNGKey(1))
    model, _, train_step, _ = _port_training(sd)
    model.train()
    out = train_step(pt_batch, 0)
    ref_loss = float(metrics["loss"])
    assert abs(float(out["loss"]) - ref_loss) <= 1e-5 * abs(ref_loss)

    after, got = _after(state.params, state.batch_stats), model.state_dict()
    means = [k for k in after if k.endswith("running_mean")]
    for k in means:
        np.testing.assert_allclose(got[k].numpy(), after[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    grads = {k: p.grad for k, p in model.named_parameters()}
    g_max = max(g.abs().max().item() for g in grads.values())
    scale = max(after[k].abs().max().item() for k in grads)
    noise = 0
    for k, g in grads.items():
        diff = (got[k] - after[k]).abs()
        real = g.abs() > 1e-5 * g_max
        assert diff[real].max().item() <= 1e-4 * scale if real.any() else True, k
        noise += int((~real).sum())
        assert diff[~real].max().item() <= 20 * LR if (~real).any() else True, k
        if k.endswith(".0.bias") or k.endswith(".3.bias"):
            assert not real.any(), k   # before a BN: no real gradient
    assert 0 < noise < 0.01 * sum(g.numel() for g in grads.values())


@pytest.mark.parametrize("split", ["val", "train"])
def test_get_loss_and_accuracy_equals_jax(sem_root, unet_weights, split):
    params, stats, sd = unet_weights
    if split == "val":
        jx_loader = JxLoader(jx_sem.SEMData(CROP, "val", dataset_root=sem_root), 1)
        pt_loader = PtLoader(pt_sem.SEMData(CROP, "val", dataset_root=sem_root), 1)
    else:
        jx_loader, pt_loader = _loaders(sem_root)
    eval_step = jx_make_eval_step(JaxUNet(in_channels=1, num_classes=2), 2)
    ref_acc, ref_loss = jx_cli.get_loss_and_accuracy(
        eval_step, _jax_state(params, stats), jx_loader)
    _, _, _, pt_eval = _port_training(sd)
    acc, loss = pt_cli.get_loss_and_accuracy(pt_eval, pt_loader)
    assert 0.0 < ref_acc < 1.0
    assert acc == ref_acc
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)


def _masked(text):
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", text)


def test_unet_train_torch_prints_the_jax_scripts_lines(sem_root, unet_weights,
                                                      monkeypatch, capsys):
    """2 epochs at crop 32 (batch 2) through both scripts: the same lines
    with every number masked (the two start from different random
    weights), finite numbers, and the port returns (model, optimizer).
    The JAX script starts from the numpy-drawn weights instead of its
    flax init, which runs op by op here and takes 20 s."""
    params, stats, _ = unet_weights
    monkeypatch.setattr(jx_cli, "init_train_state",
                        lambda *args, **kwargs: _jax_state(params, stats))
    jx_cli.main(["--epochs", "2", "--crop-size", "32", "--batch-size", "2",
                    "--num-devices", "1"], dataset_root=sem_root)
    ref = capsys.readouterr().out
    model, optimizer = pt_cli.main(["--epochs", "2", "--crop-size", "32",
                                       "--batch-size", "2"],
                                      dataset_root=sem_root, device="cpu")
    got = capsys.readouterr().out
    assert _masked(got) == _masked(ref)
    assert got.splitlines()[0] == "Initializing Training!" and len(got.splitlines()) == 3
    numbers = [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", got)]
    assert len(numbers) == 4 and all(np.isfinite(numbers))
    assert isinstance(optimizer, torch.optim.RMSprop)
    assert next(model.parameters()).device.type == "cpu"
    # N ranks: test_torch_parallel_drivers.py; a batch they do not divide
    # is refused before any rank starts
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        pt_cli.main(["--num-devices", "2", "--batch-size", "3"],
                    dataset_root=sem_root, device="cpu")
