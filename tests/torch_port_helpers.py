"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py):
a JAX DeepLab-MobileNetV2 or ENet with random weights and non-trivial BN
statistics (and PReLU slopes), and the same weights carried into the
port's model."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

NUM_CLASSES = 19


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's torch CPU ops, and the native resampler's OpenMP
    loops, on one thread. Its forwards are many small ops; under
    pytest-xdist every worker's intra-op pool competes for the same cores,
    and the pools' barriers (and OpenMP's spinning workers) then cost far
    more than the ops themselves. Import this fixture into the module to
    use it."""
    from deep_active_semantic_segmentation_torch.data import native

    saved = torch.get_num_threads(), native.get_num_threads()
    torch.set_num_threads(1)
    native.set_num_threads(1)
    yield
    torch.set_num_threads(saved[0])
    native.set_num_threads(saved[1])


def jax_deeplab(seed: int = 0, num_classes: int = NUM_CLASSES):
    """(flax module, params, batch_stats) as numpy trees. BN scale, bias,
    mean and var are redrawn from ``seed`` so that every BN layer does
    real work in the parity checks (init leaves them at 1/0/0/1)."""
    from deep_active_semantic_segmentation_tpu.models.deeplab import DeepLab

    model = DeepLab(num_classes=num_classes, backbone="mobilenet",
                    output_stride=16, mc_dropout=True)
    variables = jax.jit(partial(model.init, train=False))(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 33, 33, 3), jnp.float32))
    rng = np.random.RandomState(seed)

    def redraw(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        return np.asarray(x)

    params = jax.tree_util.tree_map_with_path(redraw, variables["params"])
    stats = jax.tree_util.tree_map_with_path(redraw, variables["batch_stats"])
    return model, params, stats


def port_deeplab(params, stats, num_classes: int = NUM_CLASSES):
    """The port's DeepLab (CPU, eval mode) holding the JAX weights."""
    from deep_active_semantic_segmentation_torch.models.convert import (
        flax_to_deeplab_state_dict)
    from deep_active_semantic_segmentation_torch.models.deeplab import DeepLab

    model = DeepLab(num_classes=num_classes, backbone="mobilenet",
                    output_stride=16, mc_dropout=True)
    model.load_state_dict(flax_to_deeplab_state_dict(params, stats))
    return model.eval()


def draw_like(shapes, rng: np.random.RandomState):
    """A numpy tree shaped as ``shapes`` (a ``jax.eval_shape`` tree of
    params or batch_stats), every leaf drawn from ``rng``: kernels
    kaiming-normal (fan_in), BN scale and var in [0.5, 1.5), conv and BN
    bias and mean ~0.1 N(0, 1), PReLU slopes in [0.05, 0.3)."""

    def draw(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "negative_slope":
            return rng.uniform(0.05, 0.3, x.shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_enet(seed: int = 0, num_classes: int = NUM_CLASSES, **relu):
    """(flax ENet, params, batch_stats) as numpy trees; ``relu`` takes
    encoder_relu / decoder_relu (the JAX factory's config sets both True,
    the class defaults are False / True). The tree's shapes come from
    ``jax.eval_shape`` (an ENet init, even jitted, takes seconds) and every
    leaf is drawn with numpy from ``seed``: kernels kaiming-normal (fan_in),
    BN scale and var in [0.5, 1.5), bias and mean ~0.1 N(0, 1), PReLU
    slopes in [0.05, 0.3)."""
    from deep_active_semantic_segmentation_tpu.models.enet import ENet

    model = ENet(num_classes=num_classes, **relu)
    shapes = jax.eval_shape(partial(model.init, train=False),
                            {"params": jax.random.PRNGKey(0)},
                            jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    rng = np.random.RandomState(seed)
    return model, draw_like(shapes["params"], rng), draw_like(shapes["batch_stats"], rng)


def predictor_state_dict_to_flax(state_dict, symmetry: bool = False):
    """An accuracy predictor's state_dict -> (params, batch_stats) trees
    through the JAX package's own mappings, head by head."""
    from deep_active_semantic_segmentation_tpu.models.pretrained import (
        deeplab_state_dict_to_flax, unet_state_dict_to_flax)

    sd = {k: v.detach().numpy() for k, v in state_dict.items()}
    heads = {}
    for head in ("deeplab", "unet"):
        if head == "unet" and not symmetry:
            heads[head] = unet_state_dict_to_flax(sd, prefix="unet.")
        else:
            n = len(head) + 1
            heads[head] = deeplab_state_dict_to_flax(
                {k[n:]: v for k, v in sd.items() if k.startswith(head + ".")})
    return ({h: t[0] for h, t in heads.items()}, {h: t[1] for h, t in heads.items()})


def jax_predictor(seed: int, num_classes: int, symmetry: bool = False):
    """(the JAX factory's accuracy predictor, params, batch_stats): the
    port's init from ``seed`` (kaiming-normal kernels) with every BN's
    scale and var redrawn in [0.5, 1.5) and its bias and mean ~0.1 N(0, 1),
    carried into the JAX trees by the JAX package's own mappings (no JAX
    init to trace)."""
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_tpu.models.factory import (
        build_model as jx_build_model)

    gen = torch.Generator().manual_seed(seed)
    model = build_model("accuracy_predictor", num_classes, device="cpu",
                        generator=gen, symmetry=symmetry)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
    params, stats = predictor_state_dict_to_flax(model.state_dict(), symmetry)
    return (jx_build_model("accuracy_predictor", num_classes, backbone="mobilenet",
                           symmetry=symmetry), params, stats)


def port_predictor(params, stats, num_classes: int, symmetry: bool = False):
    """The port's accuracy predictor (CPU, eval mode) holding the JAX
    weights."""
    from deep_active_semantic_segmentation_torch.models.convert import (
        flax_to_accuracy_predictor_state_dict)
    from deep_active_semantic_segmentation_torch.models.factory import build_model

    model = build_model("accuracy_predictor", num_classes, device="cpu",
                        symmetry=symmetry)
    model.load_state_dict(flax_to_accuracy_predictor_state_dict(
        params, stats, symmetry=symmetry))
    return model


def port_enet(params, stats, num_classes: int = NUM_CLASSES, **relu):
    """The port's ENet (CPU, eval mode) holding the JAX weights."""
    from deep_active_semantic_segmentation_torch.models.convert import (
        flax_to_enet_state_dict)
    from deep_active_semantic_segmentation_torch.models.enet import ENet

    model = ENet(num_classes=num_classes, **relu)
    model.load_state_dict(flax_to_enet_state_dict(params, stats))
    return model.eval()


def write_pool(store, n: int, seed: int, hw=(40, 90)):
    """``n`` RGB+label records of size ``hw`` into ``store``: random pixels,
    blocky labels with a void (255) band. Returns the keys."""
    rng = np.random.RandomState(seed)
    keys = []
    for i in range(n):
        img = rng.randint(0, 256, hw + (3,), dtype=np.uint8)
        lab = rng.randint(0, NUM_CLASSES, hw).astype(np.uint8)
        lab[: rng.randint(1, hw[0] // 3)] = 255
        key = f"/leftImg8bit/train/city/img_{i:03d}.png".encode()
        store.put(key, np.dstack((img, lab)))
        keys.append(key)
    store.finalize(keys)
    return keys


def write_dataset(root: str, n_train: int = 16, seed_sets=(("set_0.txt", 5),),
                  family: str = "cityscapes"):
    """The loops' dataset layout under ``root``: an ``n_train``-image train
    split of ``family`` (``cityscapes`` or ``pascal``; labels in [0, 19)
    either way), a 4-image val split and seed sets (name, the first ``k``
    train images). Returns the train keys."""
    import os

    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore

    city = os.path.join(root, family)
    keys = write_pool(DirectoryStore(os.path.join(city, "train"), readonly=False),
                      n_train, seed=0)
    write_pool(DirectoryStore(os.path.join(city, "val"), readonly=False), 4, seed=1)
    os.makedirs(os.path.join(city, "seed_sets"))
    for name, k in seed_sets:
        with open(os.path.join(city, "seed_sets", name), "w") as f:
            f.writelines(key.decode() + "\n" for key in keys[:k])
    return keys


def select_with_shared_weights(monkeypatch, params, stats, state_dict=None):
    """Make both packages' AL loops select with one set of weights: the
    port trainer's best-checkpoint reload loads (params, stats) as the
    converted ``state_dict`` (a DeepLab's by default; pass the accuracy
    predictor's for the two-headed driver), and the JAX trainer starts
    every round on them, so a deterministic mode must write the same
    selections.txt in both. The JAX loop's own initialization, training
    and validation are skipped (its selection is the reference here); the
    port's run."""
    import types

    from deep_active_semantic_segmentation_torch.engine import trainer as pt_trainer
    from deep_active_semantic_segmentation_torch.models.convert import (
        flax_to_deeplab_state_dict)
    from deep_active_semantic_segmentation_tpu.engine import trainer as jx_trainer
    from deep_active_semantic_segmentation_tpu.models.factory import (
        build_model as jx_build_model)

    if state_dict is None:
        state_dict = flax_to_deeplab_state_dict(params, stats)

    def jax_initialize(self):
        args = self.args
        self.model = jx_build_model(
            "accuracy_predictor" if self.dual_head else args.architecture,
            self.nclass, backbone=args.backbone, output_stride=args.out_stride,
            mc_dropout=args.mc_dropout, symmetry=getattr(args, "symmetry", False))
        self.state = types.SimpleNamespace(params=params, batch_stats=stats)

    monkeypatch.setattr(pt_trainer.Trainer, "load_best_checkpoint",
                        lambda self: self.model.load_state_dict(state_dict))
    monkeypatch.setattr(jx_trainer.Trainer, "initialize", jax_initialize)
    monkeypatch.setattr(jx_trainer.Trainer, "training",
                        lambda self, epoch, *weights: 0.0)
    monkeypatch.setattr(jx_trainer.Trainer, "validation",
                        lambda self, epoch, *weights: (0.0, 0.0, 0.0, 0.0, 0.0, None))
    monkeypatch.setattr(jx_trainer.Trainer, "load_best_checkpoint",
                        lambda self: None)


def selections(runs: str, dataset: str, checkname: str) -> dict:
    """{run dir: selections.txt bytes} of one loop's experiment."""
    import os

    exp = os.path.join(runs, dataset, checkname)
    return {d: open(os.path.join(exp, d, "selections.txt"), "rb").read()
            for d in sorted(os.listdir(exp)) if d.startswith("run_")}
