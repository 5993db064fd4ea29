"""The pretrained-backbone transplant against the JAX package's
``load_backbone_state_dict`` / ``backbone_weights_from_state_dict``: the
same checkpoint files (``.pth``, ``.pth.tar`` with a ``state_dict``,
``.npz``; bare torchvision-style keys and a ``backbone.``-prefixed full
model), the same tensors in the backbone after the transplant (exactly:
they are copies), the classifier and MobileNetV2's ``features.18`` dropped,
and what the JAX mapping refuses refused here too. Then the trainer: the
transplant at every ``initialize()``, into DeepLab heads only, the rest of
the model untouched."""

import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.config import parse_cli
from deep_active_semantic_segmentation_torch.data.loader import Loader
from deep_active_semantic_segmentation_torch.engine.trainer import Trainer
from deep_active_semantic_segmentation_torch.models import pretrained as pt_pretrained
from deep_active_semantic_segmentation_torch.models.backbone import build_backbone
from deep_active_semantic_segmentation_torch.models.factory import build_model
from deep_active_semantic_segmentation_tpu.models import pretrained as jx_pretrained
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

ALIASES = ("low_level_features.", "high_level_features.")


def checkpoint_state_dict(backbone: str, seed: int):
    """A backbone checkpoint as torchvision / the reference write it:
    every backbone tensor drawn from ``seed`` (BN statistics positive),
    plus the ImageNet classifier and, for MobileNetV2, its trailing 1x1
    conv ``features.18``."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in build_backbone(backbone, 16).state_dict().items():
        if k.startswith(ALIASES):
            continue
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=gen) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=gen)
    if backbone == "mobilenet":
        sd["features.18.0.weight"] = torch.randn(1280, 320, 1, 1, generator=gen)
        sd["features.18.1.weight"] = torch.ones(1280)
        sd["classifier.1.weight"] = torch.randn(1000, 1280, generator=gen)
    else:
        sd["fc.weight"] = torch.randn(1000, 2048, generator=gen)
        sd["fc.bias"] = torch.zeros(1000)
    return sd


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(backbone, layout) -> checkpoint path, and the bare state_dicts."""
    root = tmp_path_factory.mktemp("ckpt")
    sds = {b: checkpoint_state_dict(b, seed) for seed, b in
           enumerate(("resnet", "mobilenet"))}
    out = {}
    for backbone, sd in sds.items():
        bare = root / f"{backbone}.pth"
        torch.save(sd, bare)
        full = {f"backbone.{k}": v for k, v in sd.items()}
        full["decoder.last_conv.7.weight"] = torch.zeros(19, 256, 1, 1)
        tar = root / f"{backbone}_full.pth.tar"
        torch.save({"epoch": 3, "state_dict": full}, tar)
        npz = root / f"{backbone}.npz"
        np.savez(npz, **{k: v.numpy() for k, v in sd.items()})
        out[backbone] = {"pth": str(bare), "pth.tar": str(tar), "npz": str(npz)}
    return out, sds


@pytest.mark.parametrize("backbone", ["resnet", "mobilenet"])
@pytest.mark.parametrize("layout", ["pth", "pth.tar", "npz"])
def test_transplant_equals_jax_mapping(files, backbone, layout):
    paths, _ = files
    path = paths[backbone][layout]
    model = build_model("deeplab", 19, backbone=backbone, device="cpu")
    head_before = {k: v.clone() for k, v in model.state_dict().items()
                   if not k.startswith("backbone.")}
    weights = pt_pretrained.backbone_state_dict(
        pt_pretrained.load_backbone_state_dict(path), backbone)
    assert not any(k.startswith(("fc.", "classifier.", "features.18."))
                   for k in weights)
    pt_pretrained.transplant_backbone(model.backbone, weights)

    bp, bs = jx_pretrained.backbone_weights_from_state_dict(
        jx_pretrained.load_backbone_state_dict(path), backbone)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    got_p, got_s = jx_pretrained.deeplab_state_dict_to_flax(sd, backbone)
    for ref, got in ((bp, got_p["backbone"]), (bs, got_s["backbone"])):
        ref, got = dict(jax_leaves(ref)), dict(jax_leaves(got))
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    for k, v in head_before.items():
        assert torch.equal(model.state_dict()[k], v), k


def jax_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from jax_leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def test_wrong_shape_unknown_key_and_wrong_depth_raise(files):
    _, sds = files
    sd = dict(sds["resnet"])
    model = build_backbone("resnet", 16)
    bad = dict(sd, **{"layer1.0.conv1.weight": torch.zeros(64, 64, 3, 3)})
    with pytest.raises(ValueError, match="layer1.0.conv1.weight"):
        pt_pretrained.transplant_backbone(
            model, pt_pretrained.backbone_state_dict(bad, "resnet"))
    extra = dict(sd, **{"layer1.0.conv4.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="conv4"):
        pt_pretrained.transplant_backbone(
            model, pt_pretrained.backbone_state_dict(extra, "resnet"))
    missing = {k: v for k, v in sd.items() if not k.startswith("layer4.2.")}
    with pytest.raises(KeyError, match="missing keys"):
        pt_pretrained.transplant_backbone(
            model, pt_pretrained.backbone_state_dict(missing, "resnet"))
    # ResNet-50's file on ResNet-101 (the JAX merge would leave layer3.6+
    # random), a MobileNetV2 file on a ResNet, and no ResNet at all
    with pytest.raises(ValueError, match="6 layer3 blocks"):
        pt_pretrained.backbone_state_dict(sd, "resnet101")
    with pytest.raises(ValueError, match="not a bottleneck-ResNet"):
        pt_pretrained.backbone_state_dict(sds["mobilenet"], "resnet")
    with pytest.raises(KeyError):
        pt_pretrained.transplant_backbone(
            build_backbone("mobilenet", 16),
            pt_pretrained.backbone_state_dict(sd, "mobilenet"))
    # the JAX mapping refuses a file without a ResNet too
    with pytest.raises(ValueError, match="no layer3"):
        jx_pretrained.backbone_weights_from_state_dict(
            {k: v.numpy() for k, v in sds["mobilenet"].items()}, "resnet")


@pytest.mark.parametrize("dual_head", [False, True])
def test_trainer_transplants_at_every_initialize(files, monkeypatch, dual_head):
    paths, sds = files
    argv = ["--backbone", "mobilenet", "--seed", "5", "--epochs", "1",
            "--pretrained-weights", paths["mobilenet"]["npz"]]
    loaders = (Loader([], 2), Loader([], 2))
    reads = []
    load = pt_pretrained.load_backbone_state_dict
    monkeypatch.setattr(pt_pretrained, "load_backbone_state_dict",
                        lambda path: reads.append(path) or load(path))
    trainers = [Trainer(parse_cli(a).finalize(), *loaders, 19, device="cpu",
                        dual_head=dual_head)
                for a in (argv, argv + ["--no-pretrained"])]
    for t in trainers:
        t.initialize()
    with_file, without = (t.model for t in trainers)
    head = (lambda m: m.deeplab) if dual_head else (lambda m: m)
    want = {k: v for k, v in sds["mobilenet"].items()
            if not k.startswith(("features.18.", "classifier."))
            and not k.endswith("num_batches_tracked")}
    got = head(with_file).backbone.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the rest of the model is the random init, draw for draw
    other = without.state_dict()
    prefix = "deeplab.backbone." if dual_head else "backbone."
    for k, v in with_file.state_dict().items():
        if not k.startswith(prefix):
            assert torch.equal(v, other[k]), k
    # the next round's fresh model gets the transplant again; the file is
    # read once
    trainers[0].initialize()
    got = head(trainers[0].model).backbone.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert reads == [paths["mobilenet"]["npz"]]


def test_only_deeplab_heads_take_the_transplant(files):
    paths, _ = files
    for arch in ("enet", "fastscnn"):
        cfg = parse_cli(["--architecture", arch, "--seed", "5", "--epochs", "1",
                         "--pretrained-weights", paths["resnet"]["pth"]]).finalize()
        trainer = Trainer(cfg, Loader([], 2), Loader([], 2), 19, device="cpu")
        trainer.initialize()   # no backbone to fill: nothing read
        assert trainer._pretrained is None
