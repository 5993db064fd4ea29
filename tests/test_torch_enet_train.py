"""ENet training against the JAX package's, with the weights carried
across by flax_to_enet_state_dict: input and parameter gradients (PReLU
slopes included) on an input with tied maxima and on one whose pools'
windows collide at the unpool, three Adam steps, and the ENet-headed
accuracy predictor's dual step.

Where the gradients can part. The 3x3/s2 pools send a window's cotangent
to its FIRST maximum in row-major order (torch's strict '>' scan, the JAX
package's tournament); ties are everywhere after ReLU (all-zero windows)
and in flat image regions. At an unpool write collision the cotangent
goes only to the winning window, the last in row-major order (the JAX
package's masked where-chain; the port's parity-plane unpool is the same
where-chain under autograd), where ``F.max_unpool2d``'s gather backward
would feed every colliding window. Either rule broken moves whole
gradient entries, far past the bars below.

Tolerances: gradients to max |port - jax| <= 1e-5 * max |jax| per tensor
(f32 on the CPU, the convolutions summing in other orders); the Adam and
dual trajectories to test_torch_train.py's bars (the first step's loss
1e-4 relative, every step's 1e-3; the weights 1e-3 of the largest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.models import enet as pt_enet
from deep_active_semantic_segmentation_torch.models.convert import (
    flax_to_enet_state_dict, flax_to_unet_state_dict)
from deep_active_semantic_segmentation_torch.models.factory import (
    build_model, param_groups)
from deep_active_semantic_segmentation_torch.ops import losses as pt_losses
from deep_active_semantic_segmentation_torch.ops import lr_schedule as pt_sched
from deep_active_semantic_segmentation_torch.parallel import optim as pt_optim
from deep_active_semantic_segmentation_torch.parallel.steps import (
    make_dual_train_step, make_train_step)
from deep_active_semantic_segmentation_tpu.models.accuracy_predictor import (
    DeepLabAccuracyPredictor as JaxPredictor)
from deep_active_semantic_segmentation_tpu.models.factory import lr_multiplier_tree
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    enet_state_dict_to_flax, unet_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.ops import losses as jx_losses
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.parallel.steps import (
    TrainState, make_dual_train_step as jx_make_dual_train_step)
from deep_active_semantic_segmentation_tpu.selection.kernels import (
    normalize_on_device as jx_normalize)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, jax_enet, one_torch_thread, port_enet)

SIDE = 32
BATCH = 2
FACTORY = dict(encoder_relu=True, decoder_relu=True)   # JAX factory.py:35-37
CONFIGS = {"factory": FACTORY, "prelu": {}}            # {}: class defaults


def _tied_image(seed):
    """Flat blocks: every 3x3 window inside a block holds a tied maximum,
    and after the ReLUs whole windows are 0."""
    rng = np.random.RandomState(seed)
    blocks = rng.randint(0, 256, (BATCH, 4, 4, 3))
    return np.kron(blocks, np.ones((1, 8, 8, 1), int)).astype(np.uint8)


def _noise_image(seed):
    """Pixel noise: local maxima on cells that neighbouring pool windows
    share, so unpool writes collide."""
    return np.random.RandomState(seed).randint(0, 256, (BATCH, SIDE, SIDE, 3)).astype(np.uint8)


def _collisions(selector: torch.Tensor) -> int:
    """Unpool target cells written by more than one window (NCHW selector
    of a 3x3/s2/p1 pool)."""
    B, C, h, w = selector.shape
    counts = torch.zeros(B, C, 2 * h + 1, 2 * w + 1, dtype=torch.int32)
    for d in range(9):
        dr, dc = divmod(d, 3)
        counts[:, :, dr:dr + 2 * h:2, dc:dc + 2 * w:2] += (selector == d).int()
    return int((counts > 1).sum())


def _ties(x: torch.Tensor) -> int:
    """3x3/s2/p1 windows whose maximum occurs more than once."""
    pooled = torch.nn.functional.max_pool2d(x, 3, 2, 1)
    patches = torch.nn.functional.unfold(
        torch.nn.functional.pad(x, (1, 1, 1, 1), value=-float("inf")), 3,
        stride=2).reshape(x.shape[0], x.shape[1], 9, *pooled.shape[2:])
    return int(((patches == pooled[:, :, None]).sum(2) > 1).sum())


@pytest.fixture(scope="module")
def pairs():
    """config -> (flax ENet, params, batch_stats, port ENet, jitted JAX
    gradient of <logits, cotangent> w.r.t. (params, input))."""
    out = {}
    for seed, (name, relu) in enumerate(CONFIGS.items()):
        model, params, stats = jax_enet(seed + 10, **relu)

        def objective(p, x, ct, model=model, stats=stats):
            out = model.apply({"params": p, "batch_stats": stats}, x, train=False)
            return jnp.sum(out * ct)

        out[name] = (model, params, stats, port_enet(params, stats, **relu),
                     jax.jit(jax.grad(objective, argnums=(0, 1))))
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("kind", ["ties", "collisions"])
def test_input_and_parameter_gradients_match_jax(pairs, config, kind, monkeypatch):
    _, params, stats, port, jgrad = pairs[config]
    img = _tied_image(1) if kind == "ties" else _noise_image(2)
    x = np.asarray(jx_normalize(jnp.asarray(img)))
    ct = np.random.RandomState(3).randn(BATCH, SIDE, SIDE, NUM_CLASSES).astype(np.float32)
    gp, gx = jgrad(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
                   jnp.asarray(ct))

    pools = []
    pool = pt_enet.max_pool_with_indices
    monkeypatch.setattr(pt_enet, "max_pool_with_indices",
                        lambda t: pools.append(t.detach()) or pool(t))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    port.zero_grad(set_to_none=True)
    out = port(xt, use_dropout=False)
    (out * torch.from_numpy(ct.transpose(0, 3, 1, 2).copy())).sum().backward()

    # what the input exercises, at the two downsampling pools
    selectors = [pool(t)[1] for t in pools]
    if kind == "ties":
        assert sum(_ties(t) for t in pools) > 100
    else:
        assert sum(_collisions(s) for s in selectors) > 10

    def close(got, ref, what):
        ref = np.asarray(ref)
        err = np.abs(got - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (what, err, np.abs(ref).max())

    close(xt.grad.numpy().transpose(0, 2, 3, 1), gx, "input")
    grads = flax_to_enet_state_dict(
        jax.tree_util.tree_map(np.asarray, gp), stats)
    port_grads = {k: p.grad for k, p in port.named_parameters()}
    assert set(port_grads) <= set(grads)
    slopes = [k for k in port_grads if k.endswith("act.weight")]
    assert len(slopes) == (0 if config == "factory" else 23)   # the encoder's
    for k, g in port_grads.items():
        close(g.numpy(), grads[k].numpy(), k)
    if slopes:   # PReLU slopes train
        assert all(port_grads[k].abs().item() > 0 for k in slopes)


def _block_batches(n, seed, num_classes=NUM_CLASSES):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lab = np.kron(rng.randint(0, num_classes, (BATCH, 4, 4)), np.ones((1, 8, 8), int))
        img = np.stack([lab * 13 + 5, 250 - lab * 11, (lab * 97) % 251], axis=-1)
        img = np.clip(img + rng.randint(-8, 9, img.shape), 0, 255).astype(np.uint8)
        lab = lab.astype(np.uint8)
        lab[:, :2] = 255
        out.append((img, lab))
    return out


def _freeze_bn(model):
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    return model


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    return np.abs(port - ref) / np.abs(ref)


def test_three_adam_steps_match_jax(pairs):
    """Adam (lr 1e-3, weight decay 5e-4 in the gradient) at 1x over every
    ENet parameter, dropout off, BN at running statistics."""
    jmodel, params, stats, _, _ = pairs["factory"]
    batches = _block_batches(3, seed=4)
    loss_fn = jx_losses.build_loss("ce")

    def compute(p, image, label):
        out = jmodel.apply({"params": p, "batch_stats": stats},
                           jx_normalize(image), train=False)
        return loss_fn(out, label)

    mults = lr_multiplier_tree(params, "enet")

    @jax.jit
    def jstep(p, opt_state, image, label):
        loss, g = jax.value_and_grad(compute)(p, image, label)
        p, opt_state = jx_optim.apply_update(
            "Adam", p, g, opt_state, jnp.float32(1e-3), mults,
            jx_optim.AdamConfig(weight_decay=5e-4))
        return p, opt_state, loss

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = jx_optim.init_opt_state(jp, "Adam")
    jax_losses = []
    for img, lab in batches:
        jp, opt_state, loss = jstep(jp, opt_state, jnp.asarray(img),
                                    jnp.asarray(lab.astype(np.float32)))
        jax_losses.append(float(loss))

    model = _freeze_bn(port_enet(params, stats, **FACTORY))
    groups = param_groups(model, "enet")
    assert [g["lr_mult"] for g in groups] == [1.0]
    cfg = type("Cfg", (), dict(momentum=0.9, weight_decay=5e-4, nesterov=False))
    step = make_train_step(model, pt_optim.build_optimizer("Adam", groups, cfg),
                           pt_losses.build_loss("ce"), pt_sched.constant_schedule(1e-3))
    port_losses = [float(step({"image": torch.from_numpy(img),
                               "label": torch.from_numpy(lab)}, i)["loss"])
                   for i, (img, lab) in enumerate(batches)]
    rel = _rel(port_losses, jax_losses)
    assert rel[0] <= 1e-4 and rel.max() <= 1e-3, (port_losses, jax_losses)
    got = flax_to_enet_state_dict(jax.tree_util.tree_map(np.asarray, jp), stats)
    sd = model.state_dict()
    scale = max(float(v.abs().max()) for k, v in got.items() if "running" not in k)
    err = max(float((sd[k] - v).abs().max()) for k, v in got.items()
              if v.is_floating_point())
    assert err <= 1e-3 * scale, (err, scale)


class _Frozen(JaxPredictor):
    """The JAX predictor with dropout off and BN at running statistics
    inside the JAX package's own dual train step."""

    def __call__(self, x, train=False, **kw):
        return super().__call__(x, train=False, use_dropout=False, **kw)


def test_enet_headed_dual_step_matches_jax():
    """The ENet-headed accuracy predictor (the JAX trainer's dual head with
    --architecture enet): one SGD step at lr 1e-4, loss weights (0.7, 0.3),
    error classes [0.75, 0.25], every parameter at 1x."""
    nclass = 21
    gen = torch.Generator().manual_seed(6)
    model = build_model("accuracy_predictor", nclass, device="cpu",
                        generator=gen, enet_head=True)
    assert isinstance(model.deeplab, pt_enet.ENet)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    heads = {"deeplab": enet_state_dict_to_flax(sd, prefix="deeplab."),
             "unet": unet_state_dict_to_flax(sd, prefix="unet.")}
    params = {h: t[0] for h, t in heads.items()}
    stats = {h: t[1] for h, t in heads.items()}
    w_wrong = np.asarray([0.75, 0.25], np.float32)
    img, lab = _block_batches(1, seed=7, num_classes=nclass)[0]

    jstep = jx_make_dual_train_step(
        _Frozen(num_classes=nclass, enet=True), unet_class_weights=w_wrong,
        schedule=lambda step, dyn=None: jnp.float32(1e-4),
        lr_mults=lr_multiplier_tree(params, "accuracy_predictor", enet_head=True),
        opt_cfg=jx_optim.SGDConfig(0.9, 5e-4, False))
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=stats,
                       opt_state=jx_optim.init_opt_state(params, "SGD"),
                       step=jnp.zeros((), jnp.int32))
    state, m = jstep(state, {"image": jnp.asarray(img), "label": jnp.asarray(lab)},
                     jax.random.PRNGKey(0), np.float32(0.7), np.float32(0.3))
    ref = [float(m[k]) for k in ("loss", "loss_dl", "loss_un")]

    _freeze_bn(model)
    groups = param_groups(model, "accuracy_predictor")
    assert [g["lr_mult"] for g in groups] == [1.0, 10.0] and not groups[1]["params"]
    step = make_dual_train_step(
        model, pt_optim.build_optimizer("SGD", groups), pt_losses.build_loss("ce"),
        pt_losses.build_loss("ce", class_weights=torch.from_numpy(w_wrong)),
        pt_sched.constant_schedule(1e-4))
    out = step({"image": torch.from_numpy(img), "label": torch.from_numpy(lab)},
               0, 0.7, 0.3)
    got = [float(out[k]) for k in ("loss", "loss_dl", "loss_un")]
    assert _rel(got, ref).max() <= 1e-4, (got, ref)
    new = jax.tree_util.tree_map(np.asarray, state.params)
    want = {f"deeplab.{k}": v for k, v in flax_to_enet_state_dict(
        new["deeplab"], stats["deeplab"]).items()}
    want.update(flax_to_unet_state_dict(new["unet"], stats["unet"], prefix="unet."))
    sd = model.state_dict()
    assert set(want) == set(sd)
    scale = max(float(v.abs().max()) for k, v in want.items() if "running" not in k)
    err = max(float((sd[k] - v).abs().max()) for k, v in want.items()
              if v.is_floating_point())
    assert err <= 1e-4 * scale, (err, scale)
