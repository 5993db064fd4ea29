"""The PyTorch port stands alone: no module of it imports JAX or the JAX
package, and its entry points never fall back to the CPU on their own."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import deep_active_semantic_segmentation_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import active_train_torch
import accuracy_predictor_train_torch
import train_torch
import visualize_torch
import eval_series_torch
import unet_train_torch
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax",
                                             "deep_active_semantic_segmentation_tpu")))
missing = {"ops.region", "selection.region_pipeline", "selection.ceal",
           "ops.distance", "selection.mc_noise", "selection.core_set",
           "selection.max_subset", "selection.accuracy", "models.unet",
           "models.accuracy_predictor", "data.native", "models.fastscnn",
           "models.pretrained", "models.backbone.resnet", "engine.evaluation",
           "data.sem", "data.convert", "utils.seed_tools",
           "utils.compare_selections", "utils.profiling", "parallel.mesh",
           "parallel.crossreplica", "parallel.dryrun"} - {
    n.split(".", 1)[1] for n in names}
print(len(names), "modules;", "leaked:", bad, "missing:", missing)
sys.exit(1 if bad or missing or len(names) < 67 else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    # a fresh interpreter: this test process has JAX loaded by conftest
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from deep_active_semantic_segmentation_torch import resolve_device
    from deep_active_semantic_segmentation_torch.data.store import MemoryStore
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection import (
        get_active_selection_class)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("deeplab", 19, mc_dropout=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_active_selection_class("variance", 19, MemoryStore(), 33, 2)
    # asked for explicitly, the CPU is fine
    assert resolve_device("cpu") == torch.device("cpu")
    model = build_model("deeplab", 5, mc_dropout=True, device="cpu")
    assert next(model.parameters()).device.type == "cpu" and not model.training


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    import accuracy_predictor_train_torch
    import active_train_torch
    import eval_series_torch
    import train_torch
    import unet_train_torch
    import visualize_torch
    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.data.loader import Loader
    from deep_active_semantic_segmentation_torch.engine.active_loop import (
        run_active_loop)
    from deep_active_semantic_segmentation_torch.engine.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--backbone", "mobilenet", "--seed", "1", "--epochs", "1"]
    cfg = parse_cli(argv).finalize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dataloader("active_cityscapes_image", 33, 33, 2,
                        dataset_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_active_loop(cfg, dataset_root=str(tmp_path), runs_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        active_train_torch.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy_predictor_train_torch.main(argv, dataset_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_torch.main(argv + ["--dataset", "cityscapes"],
                         dataset_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visualize_torch.main(argv + ["--checkpoint", str(tmp_path / "best.ckpt")],
                             dataset_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_series_torch.main(argv + ["--experiment-dir", str(tmp_path)],
                               dataset_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        unet_train_torch.main(["--epochs", "1"], dataset_root=str(tmp_path))
    loaders = (Loader([], 2), Loader([], 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, *loaders, 19)
    # asked for explicitly, the CPU is fine; a loader on another device is not
    trainer = Trainer(cfg, *loaders, 19, device="cpu")
    assert trainer.device == torch.device("cpu")
    with pytest.raises(ValueError, match="the trainer runs on"):
        Trainer(cfg, Loader([], 2, device="meta"), loaders[1], 19, device="cpu")


def test_unported_parts_name_their_roadmap_item():
    from deep_active_semantic_segmentation_torch.config import SELECTION_MODES
    from deep_active_semantic_segmentation_torch.data.store import MemoryStore
    from deep_active_semantic_segmentation_torch.engine import active_loop
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection import (
        get_active_selection_class)

    # the whole zoo is ported: FastSCNN, the ResNet backbones, the UNet and
    # the two-headed predictor, whose segmentation head may be an ENet
    fastscnn = build_model("fastscnn", 19, device="cpu")
    assert fastscnn.model_name == "fastscnn" and not fastscnn.training
    unet = build_model("unet", 2, input_channels=22, device="cpu")
    predictor = build_model("accuracy_predictor", 19, backbone="mobilenet",
                            device="cpu")
    assert (unet.model_name, predictor.model_name) == ("unet", "accuracy_predictor")
    assert isinstance(predictor.unet, type(unet)) and not predictor.training
    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data.loader import Loader
    from deep_active_semantic_segmentation_torch.engine.trainer import Trainer
    enet_cfg = parse_cli(["--architecture", "enet", "--seed", "1"]).finalize()
    trainer = Trainer(enet_cfg, Loader([], 2), Loader([], 2), 19, device="cpu",
                      dual_head=True)
    trainer.initialize()
    assert trainer.model.deeplab.model_name == "enet"
    # ENet is ported: the JAX factory's config, on the CPU when asked
    enet = build_model("enet", 19, device="cpu")
    assert enet.model_name == "enet" and not enet.training
    assert isinstance(enet.initial_block.out_act, torch.nn.ReLU)
    for backbone in ("resnet", "resnet101"):
        model = build_model("deeplab", 19, backbone=backbone, device="cpu")
        assert model.aspp.aspp1.atrous_conv.in_channels == 2048
        assert model.decoder.conv1.in_channels == 256
    with pytest.raises(NotImplementedError, match="xception"):
        build_model("deeplab", 19, backbone="xception", device="cpu")
    # every selection mode of active_train.py has its selector; the
    # accuracy-predictor driver's scorers are the oracle selector's methods
    # (as in the JAX package, whose factory has no 'accuracy' mode)
    assert sorted(SELECTION_MODES) == sorted(active_loop._MODES)
    for mode in SELECTION_MODES:
        get_active_selection_class(mode, 19, MemoryStore(), 33, 2, device="cpu")
    oracle = get_active_selection_class("accuracy_labels", 19, MemoryStore(), 33,
                                        2, device="cpu")
    for name in ("get_least_accurate_samples", "get_adversarially_vulnarable_samples",
                 "get_unsure_samples", "get_least_accurate_region_maps"):
        assert callable(getattr(oracle, name))
    with pytest.raises(NotImplementedError):
        get_active_selection_class("accuracy", 19, MemoryStore(), 33, 2,
                                   device="cpu")
    # MC-noise is ported: the noisy forwards run, from an explicit generator
    model = build_model("deeplab", 5, mc_dropout=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for net, side in ((model, 33), (enet, 32)):
            out = net(torch.zeros(1, 3, side, side), noisy_features=True,
                      generator=gen)
            assert torch.isfinite(out).all()


def test_random_mode_is_a_stable_rank_of_python_random():
    import random

    from deep_active_semantic_segmentation_torch.data.store import MemoryStore
    from deep_active_semantic_segmentation_torch.selection import (
        get_active_selection_class)

    sel = get_active_selection_class("random", 19, MemoryStore(), 33, 2,
                                     device="cpu")
    images = [f"p{i}".encode() for i in range(9)]
    random.seed(3)
    scores = [random.random() for _ in images]
    random.seed(3)
    picked = sel.get_random_uncertainity(images, 4)
    assert picked == [images[i] for i in np.argsort(-np.asarray(scores),
                                                    kind="stable")[:4]]
