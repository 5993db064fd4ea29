"""Carry weights across from the JAX package's flax trees.

``flax_to_deeplab_state_dict``, ``flax_to_enet_state_dict`` and
``flax_to_unet_state_dict`` are the exact inverses of the JAX package's
``models/pretrained.py`` mappings (``mobilenet_state_dict_to_flax`` with
``deeplab_state_dict_to_flax``, ``enet_state_dict_to_flax`` and
``unet_state_dict_to_flax``): each takes the (params, batch_stats) trees
as numpy and returns a ``state_dict`` under the reference's torch key
names, which are also this package's module names. So the result loads
with ``model.load_state_dict`` (strict), a reference checkpoint loads
unchanged, and the JAX package's mapping takes the result back bit for
bit. ``flax_to_accuracy_predictor_state_dict`` puts the two heads of the
two-headed model under ``deeplab.`` and ``unet.``.

Rules: conv kernels (kh, kw, I, O) -> (O, I, kh, kw), the same transpose
for depthwise kernels ((kh, kw, 1, C) -> (C, 1, kh, kw)); transposed-conv
kernels undo ``pretrained.py::_tconv``: a spatial flip, then
(kh, kw, I, O) -> (I, O, kh, kw); BN scale / bias / mean / var -> weight /
bias / running_mean / running_var, with ``num_batches_tracked`` 0.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from deep_active_semantic_segmentation_torch.models.enet import stage23_names


def _conv(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))))


def _tconv(kernel) -> torch.Tensor:
    k = np.asarray(kernel, np.float32)[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))))


def _vec(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


class _Writer:
    def __init__(self, params: Dict, stats: Dict):
        self.params, self.stats, self.sd = params, stats, OrderedDict()

    def conv(self, path, key: str):
        node = _node(self.params, path)
        self.sd[key + ".weight"] = _conv(node["kernel"])
        if "bias" in node:
            self.sd[key + ".bias"] = _vec(node["bias"])

    def bn(self, path, key: str):
        p, s = _node(self.params, path), _node(self.stats, path)
        self.sd[key + ".weight"] = _vec(p["scale"])
        self.sd[key + ".bias"] = _vec(p["bias"])
        self.sd[key + ".running_mean"] = _vec(s["mean"])
        self.sd[key + ".running_var"] = _vec(s["var"])
        self.sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _node(tree: Dict, path):
    for k in path:
        tree = tree[k]
    return tree


def _mobilenet(w: _Writer, prefix: str) -> None:
    w.conv(("backbone", "stem_conv"), f"{prefix}features.0.0")
    w.bn(("backbone", "stem_bn"), f"{prefix}features.0.1")
    blocks = sorted((k for k in w.params["backbone"] if k.startswith("block_")),
                    key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(blocks):
        b = ("backbone", name)
        t = f"{prefix}features.{i + 1}.conv"
        if "expand_conv" in w.params["backbone"][name]:
            w.conv(b + ("expand_conv",), f"{t}.0")
            w.bn(b + ("expand_bn",), f"{t}.1")
            dw, proj = 3, 6
        else:  # expand ratio 1: depthwise first (mobilenet.py:93)
            dw, proj = 0, 3
        w.conv(b + ("depthwise_conv",), f"{t}.{dw}")
        w.bn(b + ("depthwise_bn",), f"{t}.{dw + 1}")
        w.conv(b + ("project_conv",), f"{t}.{proj}")
        w.bn(b + ("project_bn",), f"{t}.{proj + 1}")
    # the reference registers features[0:4] / features[4:] a second time
    # as low_level_features / high_level_features: same tensors, more keys
    # (a sliced nn.Sequential keeps its children's original indices)
    head = f"{prefix}features."
    for key in [k for k in w.sd if k.startswith(head)]:
        rest = key[len(head):]
        split = "low" if int(rest.split(".", 1)[0]) < 4 else "high"
        w.sd[f"{prefix}{split}_level_features.{rest}"] = w.sd[key]


def flax_to_deeplab_state_dict(params: Dict, batch_stats: Dict,
                               backbone: str = "mobilenet") -> "OrderedDict[str, torch.Tensor]":
    """JAX DeepLab (params, batch_stats) trees -> reference-named state_dict."""
    if backbone != "mobilenet":
        raise NotImplementedError(f"backbone '{backbone}' is not ported yet "
                                  "(ROADMAP A14)")
    w = _Writer(params, batch_stats)
    _mobilenet(w, "backbone.")
    for i in (1, 2, 3, 4):
        w.conv(("aspp", f"aspp{i}", "atrous_conv"), f"aspp.aspp{i}.atrous_conv")
        w.bn(("aspp", f"aspp{i}", "bn"), f"aspp.aspp{i}.bn")
    w.conv(("aspp", "gap_conv"), "aspp.global_average_pool.1")
    w.bn(("aspp", "gap_bn"), "aspp.bn_global_average_pool")
    w.conv(("aspp", "conv1"), "aspp.conv1")
    w.bn(("aspp", "bn1"), "aspp.bn1")

    w.conv(("decoder", "conv1"), "decoder.conv1")
    w.bn(("decoder", "bn1"), "decoder.bn1")
    w.conv(("decoder", "last_conv0"), "decoder.last_conv.0")
    w.bn(("decoder", "last_bn0"), "decoder.last_conv.1")
    w.conv(("decoder", "last_conv1"), "decoder.last_conv.3")
    w.bn(("decoder", "last_bn1"), "decoder.last_conv.4")
    w.conv(("decoder", "classifier"), "decoder.last_conv.7")
    return w.sd


def flax_to_enet_state_dict(params: Dict, batch_stats: Dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX ENet (params, batch_stats) trees -> reference-named state_dict.

    PReLU slopes (ENet with ``encoder_relu``/``decoder_relu`` False) are not
    in the JAX package's mapping; they go under this package's own keys,
    ``initial_block.out_act.weight`` and ``<block>.act.weight``, as (1,)
    tensors."""
    w = _Writer(params, batch_stats)

    def prelu(name: str, act: str = "act"):
        node = params[name].get(act)
        if node is not None:
            w.sd[f"{name}.{act}.weight"] = _vec(node["negative_slope"]).reshape(1)

    w.conv(("initial_block", "main_branch"), "initial_block.main_branch")
    w.bn(("initial_block", "batch_norm"), "initial_block.batch_norm")
    prelu("initial_block", "out_act")

    def regular(name: str, asymmetric: bool = False):
        w.conv((name, "ext_conv1"), f"{name}.ext_conv1.0")
        w.bn((name, "ext_bn1"), f"{name}.ext_conv1.1")
        if asymmetric:
            w.conv((name, "ext_conv2a"), f"{name}.ext_conv2.0")
            w.bn((name, "ext_bn2a"), f"{name}.ext_conv2.1")
            w.conv((name, "ext_conv2b"), f"{name}.ext_conv2.3")
            w.bn((name, "ext_bn2b"), f"{name}.ext_conv2.4")
        else:
            w.conv((name, "ext_conv2"), f"{name}.ext_conv2.0")
            w.bn((name, "ext_bn2"), f"{name}.ext_conv2.1")
        w.conv((name, "ext_conv3"), f"{name}.ext_conv3.0")
        w.bn((name, "ext_bn3"), f"{name}.ext_conv3.1")
        prelu(name)

    def upsample(name: str):
        w.conv((name, "main_conv1"), f"{name}.main_conv1.0")
        w.bn((name, "main_bn1"), f"{name}.main_conv1.1")
        w.conv((name, "ext_conv1"), f"{name}.ext_conv1.0")
        w.bn((name, "ext_bn1"), f"{name}.ext_conv1.1")
        w.sd[f"{name}.ext_conv2.0.weight"] = _tconv(params[name]["ext_tconv2"]["kernel"])
        w.bn((name, "ext_bn2"), f"{name}.ext_conv2.1")
        w.conv((name, "ext_conv3"), f"{name}.ext_conv3.0")
        w.bn((name, "ext_bn3"), f"{name}.ext_conv3.1")
        prelu(name)

    regular("downsample1_0")
    for i in range(1, 5):
        regular(f"regular1_{i}")
    regular("downsample2_0")
    for name, kind, _ in stage23_names():
        regular(name, asymmetric=kind == "asymmetric")
    upsample("upsample4_0")
    regular("regular4_1")
    regular("regular4_2")
    upsample("upsample5_0")
    regular("regular5_1")
    w.sd["transposed_conv.weight"] = _tconv(params["transposed_conv"]["kernel"])
    return w.sd


_UNET_BLOCKS = ("dconv_down1", "dconv_down2", "dconv_down3", "dconv_down4",
                "dconv_up3", "dconv_up2", "dconv_up1")


def flax_to_unet_state_dict(params: Dict, batch_stats: Dict,
                            prefix: str = "") -> "OrderedDict[str, torch.Tensor]":
    """JAX UNet (params, batch_stats) trees -> reference-named state_dict
    (keys under ``prefix``): each double conv's convs at ``.0`` / ``.3``,
    its BNs at ``.1`` / ``.4``."""
    w = _Writer(params, batch_stats)
    for name in _UNET_BLOCKS:
        for j, (c, b) in enumerate(((0, 1), (3, 4))):
            w.conv((name, f"conv{j}"), f"{prefix}{name}.{c}")
            w.bn((name, f"bn{j}"), f"{prefix}{name}.{b}")
    w.conv(("conv_last",), f"{prefix}conv_last")
    return w.sd


def flax_to_accuracy_predictor_state_dict(
        params: Dict, batch_stats: Dict, backbone: str = "mobilenet",
        symmetry: bool = False) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``DeepLabAccuracyPredictor`` trees (a DeepLab segmentation head)
    -> state_dict: the segmentation head under ``deeplab.``, the error head
    (the UNet, or with ``symmetry`` a second DeepLab) under ``unet.``."""
    sd = OrderedDict((f"deeplab.{k}", v) for k, v in flax_to_deeplab_state_dict(
        params["deeplab"], batch_stats["deeplab"], backbone).items())
    if symmetry:
        sd.update((f"unet.{k}", v) for k, v in flax_to_deeplab_state_dict(
            params["unet"], batch_stats["unet"], backbone).items())
    else:
        sd.update(flax_to_unet_state_dict(params["unet"], batch_stats["unet"],
                                          prefix="unet."))
    return sd
