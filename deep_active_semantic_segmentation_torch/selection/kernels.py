"""Batch scoring computations shared by the selectors (parity: the JAX
package's selection/kernels.py: MC-dropout on DeepLab and ENet, and the
deterministic CEAL scores and weak labels).

One call scores a whole batch on the device and returns (B, H, W) maps.
The MC sweep runs the deterministic part of the network once per batch
(DeepLab's backbone; ENet's initial block and ``downsample1_0`` up to its
dropout), then ``num_steps`` dropout forwards of the rest. Each step's
votes go into a compact uint8 stack, and the vote entropy is computed
once at the end. DeepLab votes through kernel B1 (``upsample4_argmax``)
on decoder-resolution logits, (S, B, H, W); ENet through kernel B2
(``tconv2x_argmax_parity_major``) on its stage-5 features, parity-major
(S, B, 4, H/2, W/2), with the entropy map interleaved to (B, H, W) once.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from deep_active_semantic_segmentation_torch.ops import entropy as ent_ops
from deep_active_semantic_segmentation_torch.ops import tconv_votes as tv
from deep_active_semantic_segmentation_torch.ops import upsample_argmax as ua

# ImageNet normalization constants (data/transforms.py IMAGENET_MEAN/STD)
_NORM_MEAN = (0.485, 0.456, 0.406)
_NORM_STD = (0.229, 0.224, 0.225)


def normalize_on_device(images: torch.Tensor) -> torch.Tensor:
    """NHWC uint8 wire -> NCHW f32 network input: /255, minus mean, over
    std, the host Normalize math in f32 elementwise ops. Float inputs are
    taken as already normalized and only change layout."""
    if images.dtype == torch.uint8:
        x = images.to(torch.float32) / 255.0
        mean = torch.tensor(_NORM_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(_NORM_STD, dtype=torch.float32, device=x.device)
        images = (x - mean) / std
    return images.permute(0, 3, 1, 2).contiguous()


def mc_generator(seed: int, batch_index: int, device) -> torch.Generator:
    """The dropout-mask generator of one scoring batch, seeded from
    (seed, batch index): the port's counterpart of
    ``jax.random.fold_in(PRNGKey(seed), i)`` in the JAX selector."""
    state = np.random.SeedSequence([seed, batch_index]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def cast_for_mc(model: torch.nn.Module, compute_dtype: str) -> torch.nn.Module:
    """``model`` itself when its weights are already ``compute_dtype``,
    else a cast copy: weights AND BN running statistics, since eval-mode BN
    normalizes with them (the JAX package casts both, kernels.py:89-92)."""
    dtype = getattr(torch, compute_dtype)
    if next(model.parameters()).dtype == dtype:
        return model
    return copy.deepcopy(model).to(dtype)


@contextlib.contextmanager
def _mc_precision():
    """cuDNN TF32 ON for the MC forwards. The JAX package runs them at the
    TPU's default single-pass bf16 matmul precision: votes are argmaxes,
    which the rounding perturbs far less than the MC sampling noise does.
    TF32 is the card's counterpart (and cuDNN's default). The
    deterministic scorers turn it off (``_deterministic_precision``)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def _deterministic_precision():
    """cuDNN and matmul TF32 OFF for the deterministic scorers (CEAL): one
    forward per image whose softmax ranks near-equal images, which TF32's
    10 mantissa bits reorder. The JAX package runs them at 'high' matmul
    precision (its selection/base.py:30,53). The flags are restored on
    exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def mc_vote_entropy_maps(model, images, labels, generator: torch.Generator,
                         num_classes: int, num_steps: int,
                         noise_mode: str = "dropout",
                         fused_upsample: bool = False,
                         compute_dtype: str = "float32",
                         labels_packed: bool = False) -> torch.Tensor:
    """(B, H, W) f32 masked vote-entropy maps over ``num_steps`` MC-dropout
    forwards of an eval-mode DeepLab or ENet, masks drawn from
    ``generator``.

    images: (B, H, W, 3) uint8 wire (or normalized float) on the device.
    labels: (B, H, W) label plane, or with ``labels_packed`` the packed
    1-bit valid mask (B, H, ceil(W/8)).
    fused_upsample: DeepLab votes through the CUDA upsample4_argmax kernel
    on decoder-resolution logits when the geometry is an exact 4x; any
    other geometry (the crop_size=-1 letterbox) upsamples with
    F.interpolate and takes the argmax. ENet votes through the CUDA
    tconv2x_argmax_parity_major kernel on its stage-5 features when the
    geometry is an exact 2x; unfused, it runs its transposed-conv
    classifier and takes the argmax.
    compute_dtype: 'float32' | 'bfloat16' dtype of the forwards (a model
    of another dtype is cast, see ``cast_for_mc``); the entropy over the
    uint8 vote stack is always f32.
    """
    if noise_mode != "dropout":
        raise NotImplementedError(f"noise_mode '{noise_mode}' (MC-noise) is "
                                  "not ported yet (ROADMAP A11)")
    model_name = getattr(model, "model_name", "")
    if model_name not in ("deeplab", "enet"):
        raise NotImplementedError(f"MC scoring is ported for DeepLab and ENet "
                                  f"only, not '{model_name}'")
    if model.training:
        raise ValueError("MC scoring needs the model in eval mode (BN at "
                         "running statistics)")
    model = cast_for_mc(model, compute_dtype)
    B, H, W = images.shape[:3]
    with torch.inference_mode(), _mc_precision():
        x = normalize_on_device(images).to(getattr(torch, compute_dtype))
        if model_name == "deeplab":
            # backbone hoist: every dropout site sits at or after the
            # backbone outputs, so the deterministic backbone runs once
            feats = model(x, backbone_only=True)
            # decoder logits come out at the low-level features' resolution
            fused = fused_upsample and ua.supports(feats[1].shape[2:], (H, W))
            hoist = {"backbone_features": feats}
        else:
            # prefix hoist: the initial block and downsample1_0 up to its
            # dropout (the first draw) run once
            feats = model(x, prefix_only=True)
            # stage-5 features sit at twice the stage-1 grid
            fused = fused_upsample and tv.supports(
                [2 * n for n in feats[0].shape[2:]], (H, W))
            hoist = {"prefix_features": feats}
        tconv_fused = fused and model_name == "enet"
        shape = (B, 4, H // 2, W // 2) if tconv_fused else (B, H, W)
        votes = torch.empty((num_steps,) + shape, dtype=torch.uint8,
                            device=x.device)
        for s in range(num_steps):
            out = model(x, use_dropout=True, generator=generator,
                        upsample_logits=not fused, **hoist)
            if not fused:
                votes[s] = out.argmax(dim=1)
            elif tconv_fused:
                votes[s] = tv.tconv2x_argmax_parity_major(
                    out, model.transposed_conv.weight)
            else:
                votes[s] = ua.upsample4_argmax(out, out_size=(H, W))
        ent = ent_ops.vote_entropy(votes, num_classes)
        if tconv_fused:
            ent = tv.interleave_parity_major(ent)   # once, after the steps
        mask = (ent_ops.unpack_mask(labels, W) if labels_packed
                else ent_ops.valid_mask(labels, num_classes))
        return torch.where(mask, ent, torch.zeros_like(ent))


def _unpacked_labels(labels, width: int, num_classes: int,
                     labels_packed: bool) -> torch.Tensor:
    """Resolve the packed-mask wire for the deterministic scorers: a labels
    plane whose valid_mask equals the shipped 1-bit predicate (0 where
    valid, num_classes where not). They read labels only through
    valid_mask, so this is exact."""
    if not labels_packed:
        return labels
    mask = ent_ops.unpack_mask(labels, width)
    return torch.where(mask, 0, num_classes).to(torch.int32)


def _deterministic_logits(model, images) -> torch.Tensor:
    """(B, C, H, W) full-resolution logits of one eval-mode forward."""
    if model.training:
        raise ValueError("deterministic scoring needs the model in eval mode "
                         "(BN at running statistics, no dropout)")
    return model(normalize_on_device(images))


def softmax_score_per_image(model, images, labels, num_classes: int,
                            mode: str, labels_packed: bool = False) -> torch.Tensor:
    """One deterministic forward -> (B,) per-image mean score.

    mode: 'confidence' (ceal.py:19-70), 'margin' (ceal.py:72-98),
    'entropy' (ceal.py:100-126). Runs neither B1 nor B2: the logits are
    upsampled to full resolution and every class's probability is needed.
    """
    scorers = {"confidence": ent_ops.max_confidence, "margin": ent_ops.margin,
               "entropy": ent_ops.softmax_entropy}
    if mode not in scorers:
        raise NotImplementedError(mode)
    labels = _unpacked_labels(labels, images.shape[2], num_classes,
                              labels_packed)
    with torch.inference_mode(), _deterministic_precision():
        logits = _deterministic_logits(model, images)
        return ent_ops.mean_over_pixels(scorers[mode](logits, labels,
                                                      num_classes))


def weak_label_predictions(model, images, labels, num_classes: int,
                           labels_packed: bool = False) -> torch.Tensor:
    """(B, H, W) uint8 argmax predictions, 255 at ignored pixels
    (ceal.py:158-164)."""
    labels = _unpacked_labels(labels, images.shape[2], num_classes,
                              labels_packed)
    with torch.inference_mode(), _deterministic_precision():
        pred = _deterministic_logits(model, images).argmax(dim=1).to(torch.uint8)
        valid = ent_ops.valid_mask(labels, num_classes)
        return torch.where(valid, pred, torch.full_like(pred, 255))
