"""The port's training path against the JAX package's, on the same numpy
inputs and weights: losses, the confusion matrix and metrics, the
learning-rate schedules, the optimizers over 1x/10x groups, the train step
(a deterministic trajectory, one train-mode BN step, bf16) and the train
loader's uint8 batches byte for byte."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.data import pools as pt_pools
from deep_active_semantic_segmentation_torch.data.loader import Loader as PtLoader
from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
from deep_active_semantic_segmentation_torch.models.factory import param_groups
from deep_active_semantic_segmentation_torch.ops import losses as pt_losses
from deep_active_semantic_segmentation_torch.ops import lr_schedule as pt_sched
from deep_active_semantic_segmentation_torch.ops import metrics as pt_metrics
from deep_active_semantic_segmentation_torch.parallel import optim as pt_optim
from deep_active_semantic_segmentation_torch.parallel.steps import (
    make_eval_step, make_train_step)
from deep_active_semantic_segmentation_tpu.data import pools as jx_pools
from deep_active_semantic_segmentation_tpu.data.loader import Loader as JxLoader
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JxDirectoryStore)
from deep_active_semantic_segmentation_tpu.models.factory import (
    lr_multiplier_tree)
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    deeplab_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.ops import losses as jx_losses
from deep_active_semantic_segmentation_tpu.ops import lr_schedule as jx_sched
from deep_active_semantic_segmentation_tpu.ops import metrics as jx_metrics
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.selection.kernels import (
    normalize_on_device as jx_normalize)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, one_torch_thread, port_deeplab, write_pool)

SIDE = 33
BATCH = 2


def _logits_and_target(seed, shape=(2, 5, 9, 11), void_share=0.2):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(*shape)).astype(np.float32)        # NCHW
    target = rng.randint(0, shape[1], (shape[0],) + shape[2:])
    target[rng.rand(*target.shape) < void_share] = 255
    return logits, target


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


# ------------------------------------------------------------------- losses

@pytest.mark.parametrize("batch_average", [True, False])
@pytest.mark.parametrize("kind", ["ce", "weighted_ce", "focal",
                                  "weighted_focal", "all_void", "sample_weighted"])
def test_losses_equal_jax(kind, batch_average):
    logits, target = _logits_and_target(0, void_share=1.0 if kind == "all_void" else 0.2)
    weights = np.random.RandomState(1).uniform(0.2, 3.0, 5).astype(np.float32)
    cw = weights if kind.startswith("weighted") else None
    args = dict(class_weights=cw, batch_average=batch_average)
    jl, jt = _nhwc(logits), jnp.asarray(target.astype(np.float32))
    pl, ptg = torch.from_numpy(logits), torch.from_numpy(target)
    if kind in ("focal", "weighted_focal"):
        ref = jx_losses.focal_loss(jl, jt, **args)
        got = pt_losses.focal_loss(pl, ptg, **args)
    elif kind == "sample_weighted":
        sw = np.asarray([0.3, 1.7], np.float32)
        ref = jx_losses.sample_weighted_cross_entropy(jl, jt, jnp.asarray(sw), weights,
                                                      batch_average=batch_average)
        got = pt_losses.sample_weighted_cross_entropy(pl, ptg, torch.from_numpy(sw),
                                                      weights,
                                                      batch_average=batch_average)
    else:
        ref = jx_losses.build_loss("ce", **args)(jl, jt)
        got = pt_losses.build_loss("ce", **args)(pl, ptg)
    # f32 sums over ~200 pixels in another order
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-7)
    if kind == "all_void":
        assert float(got) == 0.0   # torch's 'mean' would give NaN here


# ------------------------------------------------------------------ metrics

def test_confusion_matrix_and_metrics_equal_jax_exactly():
    rng = np.random.RandomState(2)
    n = 6
    gt = rng.randint(0, n, (3, 17, 19))
    gt[rng.rand(*gt.shape) < 0.15] = 255      # ignored
    gt[0, 0, :4] = n                          # out of range: ignored too
    gt[2] = 255                               # a padded duplicate
    logits = rng.randint(0, 3, (3, n, 17, 19)).astype(np.float32)  # many ties
    pred = torch.from_numpy(logits).argmax(dim=1)
    assert torch.equal(pred, torch.from_numpy(np.argmax(logits, axis=1)))
    ref = np.asarray(jx_metrics.confusion_matrix(jnp.asarray(gt), jnp.asarray(
        pred.numpy()), n))
    got = pt_metrics.confusion_matrix(torch.from_numpy(gt), pred, n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    valid = (gt >= 0) & (gt < n)
    np.testing.assert_array_equal(got.numpy(), np.bincount(
        n * gt[valid] + pred.numpy()[valid], minlength=n * n).reshape(n, n))

    jev, pev = jx_metrics.Evaluator(n), pt_metrics.Evaluator(n)
    for b in range(3):
        jev.add_batch(gt[b], pred.numpy()[b])
        pev.add_batch(torch.from_numpy(gt[b]), pred[b])
    pev.add_matrix(got)
    jev.add_matrix(ref)
    np.testing.assert_array_equal(pev.confusion, jev.confusion)
    for name in ("Pixel_Accuracy", "Pixel_Accuracy_Class",
                 "Mean_Intersection_over_Union",
                 "Frequency_Weighted_Intersection_over_Union"):
        assert getattr(pev, name)() == getattr(jev, name)(), name


# ----------------------------------------------------------------- schedule

@pytest.mark.parametrize("mode,lr_step,warmup", [
    ("poly", 0, 0), ("cos", 0, 0), ("step", 2, 0), ("poly", 0, 1), ("step", 0, 2)])
def test_schedules_equal_jax(mode, lr_step, warmup):
    args = (mode, 0.01, 5, 3)
    ref = jx_sched.make_schedule(*args, lr_step=lr_step, warmup_epochs=warmup)
    got = pt_sched.make_schedule(*args, lr_step=lr_step, warmup_epochs=warmup)
    # JAX evaluates in f32: within 1e-6 of the value, or of the base lr
    # where the value nears 0
    for step in range(0, 17):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-8)
        # the round's geometry passed per call (the JAX `dyn` operand)
        np.testing.assert_allclose(got(step, 20, 4),
                                   float(ref(step, jnp.asarray([20.0, 4.0]))),
                                   rtol=1e-6, atol=1e-8)
    assert pt_sched.constant_schedule(0.02)(7, 9, 3) == 0.02


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("name,nesterov", [("SGD", False), ("SGD", True),
                                           ("Adam", False), ("RMSprop", False)])
def test_optimizers_with_lr_groups_equal_jax(name, nesterov):
    rng = np.random.RandomState(3)
    shapes = {"backbone": (4, 3), "head": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lrs = [1e-3, 7e-4, 3e-4]
    mults = {"backbone": 1.0, "head": 10.0}
    cfg = {"SGD": jx_optim.SGDConfig(0.9, 5e-4, nesterov),
           "Adam": jx_optim.AdamConfig(weight_decay=5e-4),
           "RMSprop": jx_optim.RMSpropConfig()}[name]

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jx_optim.init_opt_state(jp, name)
    for g, lr in zip(grads, lrs):
        jp, state = jx_optim.apply_update(
            name, jp, {k: jnp.asarray(v) for k, v in g.items()}, state,
            jnp.float32(lr), mults, cfg)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    groups = [{"params": [tp[k]], "lr_mult": mults[k]} for k in shapes]
    hp = type("Cfg", (), dict(momentum=0.9, weight_decay=5e-4, nesterov=nesterov))
    opt = pt_optim.build_optimizer(name, groups, hp)
    for g, lr in zip(grads, lrs):
        for k in shapes:
            tp[k].grad = torch.from_numpy(g[k])
        pt_optim.set_lr(opt, lr)
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


def test_deeplab_param_groups_are_the_lr_multiplier_tree(twins):
    _, params, stats, _ = twins
    model = port_deeplab(params, stats)
    groups = param_groups(model, "deeplab")
    assert [g["lr_mult"] for g in groups] == [1.0, 10.0]
    ids = [{id(p) for p in g["params"]} for g in groups]
    assert not ids[0] & ids[1]
    assert sum(map(len, ids)) == len(list(model.parameters()))
    # put each group's multiplier in its tensors; the JAX mapping gives the
    # JAX package's multiplier tree back
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    for g in groups:
        for name, p in model.named_parameters():
            if id(p) in {id(q) for q in g["params"]}:
                sd[name] = np.full(p.shape, g["lr_mult"], np.float32)
    mults, _ = deeplab_state_dict_to_flax(sd, "mobilenet")
    ref = lr_multiplier_tree(params, "deeplab")
    jax.tree_util.tree_map(lambda m, r: np.testing.assert_array_equal(
        m, np.full(m.shape, r, np.float32)), mults, ref)


# --------------------------------------------------------------- train step

def _uint8_batches(n, seed):
    """Block-colour batches (a learnable task) on the uint8 wire."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        blocks = rng.randint(0, NUM_CLASSES, (BATCH, 3, 3))
        lab = np.kron(blocks, np.ones((1, 11, 11), int))
        img = np.stack([lab * 13 + 5, 250 - lab * 11, (lab * 97) % 251], axis=-1)
        img = np.clip(img + rng.randint(-8, 9, img.shape), 0, 255).astype(np.uint8)
        lab = lab.astype(np.uint8)
        lab[:, :2] = 255
        out.append((img, lab))
    return out


def _jax_step(model, loss_fn, lr_mults, train_bn: bool):
    """The JAX package's train step with dropout off, from its own parts
    (the deterministic twin of tests/test_convergence_parity.py)."""
    cfg = jx_optim.SGDConfig(0.9, 5e-4, False)

    def step(params, stats, opt_state, lr, image, label):
        x = jx_normalize(image)

        def compute(p):
            if train_bn:
                out, upd = model.apply({"params": p, "batch_stats": stats}, x,
                                       train=True, use_dropout=False,
                                       mutable=["batch_stats"])
                return loss_fn(out, label), upd["batch_stats"]
            out = model.apply({"params": p, "batch_stats": stats}, x, train=False)
            return loss_fn(out, label), stats

        (loss, new_stats), grads = jax.value_and_grad(compute, has_aux=True)(params)
        new_params, new_opt = jx_optim.apply_update("SGD", params, grads, opt_state,
                                                    lr, lr_mults, cfg)
        return new_params, new_stats, new_opt, loss

    return jax.jit(step)


def _port_step(model, cw, schedule, compute_dtype="float32"):
    opt = pt_optim.build_optimizer("SGD", param_groups(model, "deeplab"))
    return make_train_step(model, opt, pt_losses.build_loss("ce", class_weights=cw),
                           schedule, compute_dtype=compute_dtype)


def _freeze_bn(model):
    """Train mode with every BN layer at its running statistics."""
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    return model


def _to_flax(model):
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return deeplab_state_dict_to_flax(sd, "mobilenet")


@pytest.fixture(scope="module")
def twins():
    """The port's DeepLab init (seed 4; BN biases drawn ~0.1 N(0, 1), so no
    activation sits exactly on a ReLU6 corner, where JAX's min/max gradient
    splits ties and torch's does not), carried into the JAX model by the
    JAX package's own mapping; and balanced class weights."""
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_tpu.models.deeplab import DeepLab

    gen = torch.Generator().manual_seed(4)
    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device="cpu",
                        generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    params, stats = _to_flax(model)
    jmodel = DeepLab(num_classes=NUM_CLASSES, backbone="mobilenet",
                     output_stride=16, mc_dropout=True)
    cw = np.random.RandomState(4).uniform(0.5, 2.0, NUM_CLASSES).astype(np.float32)
    return jmodel, params, stats, cw


def test_step_trajectory_matches_jax(twins):
    """Four SGD steps, dropout off, BN at running statistics, lr 1e-3 poly,
    balanced class weights: per-step losses and the final weights. The
    two frameworks' convs round differently and each step amplifies it:
    measured 1.6e-6, 1.0e-5, 3.2e-4, 1.3e-4 relative (1.6e-3 at a fifth
    step)."""
    jmodel, params, stats, cw = twins
    batches = _uint8_batches(3, seed=5)
    n_steps, epochs, ipe = 4, 4, len(batches)
    jsched = jx_sched.make_schedule("poly", 1e-3, epochs, ipe)
    jstep = _jax_step(jmodel, jx_losses.build_loss("ce", class_weights=cw),
                      lr_multiplier_tree(params, "deeplab"), train_bn=False)
    jp, js = params, stats
    jopt = jx_optim.init_opt_state(params, "SGD")
    jax_losses = []
    for i in range(n_steps):
        img, lab = batches[i % ipe]
        jp, js, jopt, loss = jstep(jp, js, jopt, jsched(i), jnp.asarray(img),
                                   jnp.asarray(lab.astype(np.float32)))
        jax_losses.append(float(loss))

    model = _freeze_bn(port_deeplab(params, stats))
    step = _port_step(model, torch.from_numpy(cw),
                      pt_sched.make_schedule("poly", 1e-3, epochs, ipe))
    port_losses = []
    for i in range(n_steps):
        img, lab = batches[i % ipe]
        out = step({"image": torch.from_numpy(img), "label": torch.from_numpy(lab)}, i)
        port_losses.append(float(out["loss"]))
        assert out["lr"] == pytest.approx(float(jsched(i)), rel=1e-6)

    rel = np.abs(np.subtract(port_losses, jax_losses)) / np.abs(jax_losses)
    assert rel[0] <= 1e-4 and rel.max() <= 1e-3, (port_losses, jax_losses)
    # the weights after six steps, through the JAX package's own mapping
    got, _ = _to_flax(model)
    scale = max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(jp))
    err = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), got, jp)))
    # the same drift as the losses' (measured 2.3e-4 of the largest weight)
    assert err <= 1e-3 * scale, (err, scale)


def _bn_sizes(model, image):
    """Values per channel that each BN layer normalizes over (B*H*W of its
    input), keyed by module name."""
    sizes, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: sizes.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1])))
    training = model.training
    with torch.no_grad():   # in eval mode: the running statistics stay
        model.eval()(image, use_dropout=False)
    model.train(training)
    for h in hooks:
        h.remove()
    return sizes


def test_train_mode_bn_step_matches_jax_up_to_the_unbiased_variance(twins):
    """One step in train mode, dropout off. torch's BatchNorm2d updates
    running_var with the UNBIASED batch variance, flax's BatchNorm with the
    biased one: the batch parts of the two updates differ by exactly
    n/(n-1), n the values per channel the layer normalizes over. ASPP's
    image-pooling branch is no exception: its BN follows the upsample, so
    it sees B*h*w values (here 2*3*3 = 18, ratio 18/17), not B.

    Train-mode BN amplifies the two frameworks' conv rounding layer by
    layer (normalizing by the batch std), so deep layers agree to ~1e-3
    only; the relation is held tight where the input is the same to f32
    rounding (the stem) and where n is small (the pooling branch). The
    running means agree to 1e-5 absolute, 1e-3 relative in the deep
    layers (measured: 1.8e-5 absolute on means of 0.06)."""
    jmodel, params, stats, cw = twins
    img, lab = _uint8_batches(1, seed=6)[0]
    jstep = _jax_step(jmodel, jx_losses.build_loss("ce", class_weights=cw),
                      lr_multiplier_tree(params, "deeplab"), train_bn=True)
    _, jstats, _, jloss = jstep(params, stats, jx_optim.init_opt_state(params, "SGD"),
                                jnp.float32(0.01), jnp.asarray(img),
                                jnp.asarray(lab.astype(np.float32)))

    from deep_active_semantic_segmentation_torch.selection.kernels import (
        normalize_on_device)
    model = port_deeplab(params, stats).train()
    x = torch.from_numpy(img)
    sizes = _bn_sizes(model, normalize_on_device(x))
    step = _port_step(model, torch.from_numpy(cw), pt_sched.constant_schedule(0.01))
    out = step({"image": x, "label": torch.from_numpy(lab)}, 0)
    assert abs(float(out["loss"]) - float(jloss)) <= 1e-4 * abs(float(jloss))

    _, pstats = _to_flax(model)
    sd_n = {k: (np.full(v.shape, sizes[k.rsplit(".", 1)[0]], np.float64)
                if k.endswith("running_var") and k.rsplit(".", 1)[0] in sizes
                else v.detach().numpy()) for k, v in model.state_dict().items()}
    _, n_tree = deeplab_state_dict_to_flax(sd_n, "mobilenet")
    ratios = {}
    for path, got in jax.tree_util.tree_flatten_with_path(pstats)[0]:
        keys = tuple(p.key for p in path)
        ref = np.asarray(_get(jstats, keys), np.float64)
        old = np.asarray(_get(stats, keys), np.float64)
        if keys[-1] == "mean":
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5, err_msg=str(keys))
            continue
        n = float(_get(n_tree, keys)[0])
        # the batch parts of the updates: 0.1 * unbiased vs 0.1 * biased
        port_part = got.astype(np.float64) - 0.9 * old
        jax_part = ref - 0.9 * old
        np.testing.assert_allclose(port_part * (n - 1) / n, jax_part, rtol=3e-3,
                                   atol=1e-6, err_msg=str(keys))
        ratios[keys[:-1]] = (n, float(np.median(port_part / jax_part)))
    n, ratio = ratios[("backbone", "stem_bn")]
    assert n == BATCH * 17 * 17 and abs(ratio - n / (n - 1)) <= 1e-5, ratio
    n, ratio = ratios[("aspp", "gap_bn")]
    assert n == BATCH * 3 * 3 and abs(ratio - n / (n - 1)) <= 3e-3, ratio
    assert abs(ratio - 1.0) > 0.05   # the biased update is NOT what torch does


def test_train_mode_step_at_batch_1_runs():
    """torch's BN refuses one value per channel in train mode; the pooling
    branch's BN sees h*w > 1 values even at batch 1, so a batch-1 step at
    33 px runs (it would raise only below 17 px, where h = w = 1)."""
    from deep_active_semantic_segmentation_torch.models.factory import build_model

    model = build_model("deeplab", NUM_CLASSES, device="cpu").train()
    img, lab = _uint8_batches(1, seed=9)[0]
    step = _port_step(model, None, pt_sched.constant_schedule(0.01))
    out = step({"image": torch.from_numpy(img[:1]), "label": torch.from_numpy(lab[:1])}, 0)
    assert np.isfinite(float(out["loss"]))
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        model(torch.zeros(1, 3, 16, 16), use_dropout=False)


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_bf16_step_runs_and_tracks_the_f32_step(twins):
    jmodel, params, stats, cw = twins
    img, lab = _uint8_batches(1, seed=7)[0]
    batch = {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)}
    losses = {}
    for dtype in ("float32", "bfloat16"):
        model = port_deeplab(params, stats).train()
        gen = torch.Generator().manual_seed(0)   # same dropout masks
        opt = pt_optim.build_optimizer("SGD", param_groups(model, "deeplab"))
        step = make_train_step(model, opt, pt_losses.build_loss("ce", class_weights=cw),
                               pt_sched.constant_schedule(0.01), compute_dtype=dtype,
                               generator=gen)
        losses[dtype] = float(step(batch, 0)["loss"])
        # f32 master weights and BN statistics either way
        assert all(t.dtype in (torch.float32, torch.int64)
                   for t in model.state_dict().values())
        assert all(p.grad is None or p.grad.dtype == torch.float32
                   for p in model.parameters())
    assert np.isfinite(list(losses.values())).all()
    assert abs(losses["bfloat16"] - losses["float32"]) <= 2e-2 * losses["float32"]


def test_eval_step_divides_by_nvalid_and_counts_pixels(twins):
    jmodel, params, stats, cw = twins
    img, lab = _uint8_batches(1, seed=8)[0]
    lab[1] = 255                                   # a padded duplicate
    model = port_deeplab(params, stats)
    step = make_eval_step(model, NUM_CLASSES,
                          pt_losses.build_loss("ce", batch_average=False))
    out = step({"image": torch.from_numpy(img), "label": torch.from_numpy(lab)}, 1)
    ref = jax.jit(lambda x: jmodel.apply({"params": params, "batch_stats": stats},
                                         jx_normalize(x), train=False))(jnp.asarray(img))
    ref_loss = jx_losses.cross_entropy(ref, jnp.asarray(lab.astype(np.float32)),
                                       batch_average=False) / 1
    assert abs(float(out["loss"]) - float(ref_loss)) <= 1e-4 * float(ref_loss)
    assert int(out["confusion"].sum()) == int((lab < NUM_CLASSES).sum())
    assert not model.training


def test_remat_is_refused():
    with pytest.raises(NotImplementedError, match="remat"):
        make_train_step(None, None, None, None, remat=True)


# ------------------------------------------------------------------- loader

@pytest.mark.parametrize("crop", [SIDE, -1])
def test_train_loader_batches_equal_jax_byte_for_byte(tmp_path, crop):
    """Two epochs of the shuffled train loader (5 images, batch 2: the last
    batch padded with a 255-labelled duplicate) with the JAX package's
    module-level `random` seeded as the port's `random.Random`: the same
    order, flips and blur sigmas."""
    write_pool(DirectoryStore(str(tmp_path), readonly=False), 5, seed=3)
    jpool = jx_pools.ActiveImagePool(jx_pools.CITYSCAPES, JxDirectoryStore(str(tmp_path)),
                                     40, crop, "train", device_normalize=True)
    prng = random.Random(11)
    ppool = pt_pools.ActiveImagePool(pt_pools.CITYSCAPES, DirectoryStore(str(tmp_path)),
                                     40, crop, "train", rng=prng)
    jl = JxLoader(jpool, BATCH, shuffle=True, seed=9)
    pl = PtLoader(ppool, BATCH, shuffle=True, seed=9)
    assert len(jl) == len(pl) == 3
    random.seed(11)
    ref = [b for _ in range(2) for b in jl]
    got = [b for _ in range(2) for b in pl]
    assert [b["nvalid"] for b in got] == [b["nvalid"] for b in ref] == [2, 2, 1] * 2
    for a, b in zip(got, ref, strict=True):
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype == np.uint8
            np.testing.assert_array_equal(a[k], b[k])
    assert (got[2]["label"][1] == 255).all()
    # device_batches (one producer thread): the same batches as tensors on
    # the loader's device
    prng.seed(5)
    random.seed(5)
    on_dev = list(PtLoader(ppool, BATCH, shuffle=True, seed=9).device_batches())
    ref = list(JxLoader(jpool, BATCH, shuffle=True, seed=9))
    for a, b in zip(on_dev, ref, strict=True):
        assert isinstance(a["image"], torch.Tensor)
        np.testing.assert_array_equal(a["image"].numpy(), b["image"])
