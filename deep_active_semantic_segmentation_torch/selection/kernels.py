"""Batch scoring computations shared by the selectors (parity: the JAX
package's selection/kernels.py: the MC sweeps — dropout, input noise,
feature noise — on DeepLab and ENet, the deterministic CEAL scores and
weak labels, the core-set / max-subset feature taps, the oracle's
misprediction counts and the accuracy predictor's error-head scores,
error maps and input-gradient norms).

One call scores a whole batch on the device and returns (B, H, W) maps.
The MC-dropout sweep runs the deterministic part of the network once per
batch (DeepLab's backbone; ENet's initial block and ``downsample1_0`` up
to its dropout), then ``num_steps`` dropout forwards of the rest; the
noise sweeps run the whole forward each step. Each step's votes go into a
compact uint8 stack, and the vote entropy is computed once at the end.
DeepLab votes through kernel B1 (``upsample4_argmax``) on
decoder-resolution logits, (S, B, H, W); ENet through kernel B2
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
from deep_active_semantic_segmentation_torch.ops.interpolate import (
    resize_bilinear_align_corners)

# ImageNet normalization constants (data/transforms.py IMAGENET_MEAN/STD)
_NORM_MEAN = (0.485, 0.456, 0.406)
_NORM_STD = (0.229, 0.224, 0.225)


def normalize_on_device(images: torch.Tensor, mean=_NORM_MEAN,
                        std=_NORM_STD) -> torch.Tensor:
    """NHWC uint8 wire -> NCHW f32 network input: /255, minus mean, over
    std (one value per channel; ImageNet's by default), the host Normalize
    math in f32 elementwise ops, bit for bit on the card too: every
    divisor is a device tensor, since CUDA turns a division by a host
    scalar into a multiplication by its reciprocal, up to 1 ulp off.
    Float inputs are taken as already normalized and only change
    layout."""
    if images.dtype == torch.uint8:
        c = images.shape[-1]
        if len(mean) != c or len(std) != c:
            raise ValueError(f"{len(mean)}-channel mean and {len(std)}-channel "
                             f"std for {c}-channel images")
        consts = torch.tensor((255.0, *mean, *std), dtype=torch.float32,
                              device=images.device)
        x = images.to(torch.float32) / consts[0]
        images = (x - consts[1:1 + c]) / consts[1 + c:]
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


# oneDNN's per-operation float32 precisions (torch >= 2.9); "none" defers to
# torch.backends.fp32_precision, which a caller may have set to bf16 or tf32
_ONEDNN_FP32 = ("matmul", "conv")


@contextlib.contextmanager
def _deterministic_precision():
    """Full float32 for the deterministic scorers (CEAL, the feature taps)
    and the greedy selections: cuDNN and cuBLAS TF32 OFF, oneDNN's CPU
    matmuls and convs at IEEE float32, and autocast off on the CPU and the
    card. One forward per image whose softmax ranks near-equal images, and
    greedy picks whose distances part by 1e-5, both of which a reduced
    precision reorders: a bf16 CPU matmul is off by ~4e-3 relative. The JAX
    package runs them at 'high' matmul precision (its selection/base.py
    :30,53). Every setting is restored on exit, oneDNN's before the TF32
    flags (torch refuses to read a legacy matmul precision that its
    per-backend settings contradict), cuBLAS's per-backend value last."""
    b = torch.backends
    onednn = [getattr(b.mkldnn, op) for op in _ONEDNN_FP32
              if hasattr(getattr(b.mkldnn, op, None), "fp32_precision")]
    cublas = [b.cuda.matmul] if hasattr(b.cuda.matmul, "fp32_precision") else []
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             [m.fp32_precision for m in onednn + cublas])
    b.cudnn.allow_tf32 = False
    b.cuda.matmul.allow_tf32 = False
    for m in onednn:
        m.fp32_precision = "ieee"
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    try:
        with contextlib.ExitStack() as stack:
            for device in devices:
                stack.enter_context(torch.autocast(device, enabled=False))
            yield
    finally:
        for m, value in zip(onednn, saved[2]):
            m.fp32_precision = value
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved[:2]
        for m, value in zip(cublas, saved[2][len(onednn):]):
            m.fp32_precision = value   # "none" where it was unset


def _step_votes(model, out: torch.Tensor, fused: bool, H: int, W: int):
    """One MC step's votes from the tail output of a forward run with
    ``upsample_logits=False``: DeepLab's decoder-resolution logits through
    B1 at an exact 4x (else the model's own align-corners upsample and an
    argmax), (B, H, W); FastSCNN's 1/8 logits the same way, never fused
    (the JAX package fuses DeepLab only); ENet's stage-5 features through
    B2 at an exact 2x, parity-major (B, 4, H/2, W/2) (else the model's
    transposed-conv classifier and an argmax, (B, H, W))."""
    if model.model_name in ("deeplab", "fastscnn"):
        if (fused and model.model_name == "deeplab"
                and ua.supports(out.shape[2:], (H, W))):
            return ua.upsample4_argmax(out, out_size=(H, W))
        return resize_bilinear_align_corners(out, H, W).argmax(dim=1)
    if fused and tv.supports(out.shape[2:], (H, W)):
        return tv.tconv2x_argmax_parity_major(out, model.transposed_conv.weight)
    return model.transposed_conv(out).argmax(dim=1)


def mc_vote_entropy_maps(model, images, labels, generator: torch.Generator,
                         num_classes: int, num_steps: int,
                         noise_mode: str = "dropout",
                         fused_upsample: bool = False,
                         compute_dtype: str = "float32",
                         labels_packed: bool = False) -> torch.Tensor:
    """(B, H, W) f32 masked vote-entropy maps over ``num_steps``
    stochastic forwards of an eval-mode DeepLab, ENet or FastSCNN, every
    draw taken from ``generator`` (FastSCNN has no dropout or noise site:
    only 'input' noise moves its votes, as in the JAX package).

    noise_mode (the JAX package's kernels.py:61-64):
      'dropout' — MC dropout; the deterministic prefix is hoisted (DeepLab's
                  backbone, ENet's initial block and ``downsample1_0`` up
                  to its dropout) and runs once per batch (FastSCNN: no
                  hoist);
      'input'   — the normalized images + 0.125 * N(0, 1) in the compute
                  dtype (the draw is f32), dropout off;
      'feature' — the models' ``noisy_features`` sites, dropout off.
    The noise modes run the whole forward every step (no hoist).
    images: (B, H, W, 3) uint8 wire (or normalized float) on the device.
    labels: (B, H, W) label plane, or with ``labels_packed`` the packed
    1-bit valid mask (B, H, ceil(W/8)).
    fused_upsample: vote through the CUDA kernels where the geometry
    allows, decided from the tail output's shape (``_step_votes``); any
    other geometry (the crop_size=-1 letterbox) votes unfused.
    compute_dtype: 'float32' | 'bfloat16' dtype of the forwards (a model
    of another dtype is cast, see ``cast_for_mc``); the entropy over the
    uint8 vote stack is always f32.
    """
    if noise_mode not in ("dropout", "input", "feature"):
        raise NotImplementedError(noise_mode)
    model_name = getattr(model, "model_name", "")
    if model_name not in ("deeplab", "enet", "fastscnn"):
        raise NotImplementedError(f"MC scoring of '{model_name}'")
    if model.training:
        raise ValueError("MC scoring needs the model in eval mode (BN at "
                         "running statistics)")
    model = cast_for_mc(model, compute_dtype)
    H, W = images.shape[1:3]
    with torch.inference_mode(), _mc_precision():
        x = normalize_on_device(images).to(getattr(torch, compute_dtype))
        hoist = {}
        if noise_mode == "dropout" and model_name == "deeplab":
            hoist = {"backbone_features": model(x, backbone_only=True)}
        elif noise_mode == "dropout" and model_name == "enet":
            hoist = {"prefix_features": model(x, prefix_only=True)}
        votes = None
        for s in range(num_steps):
            if noise_mode == "dropout":
                out = model(x, use_dropout=True, generator=generator,
                            upsample_logits=False, **hoist)
            elif noise_mode == "input":
                z = torch.randn(x.shape, dtype=torch.float32, device=x.device,
                                generator=generator)
                out = model(x + 0.125 * z.to(x.dtype), use_dropout=False,
                            upsample_logits=False)
            else:
                out = model(x, use_dropout=False, generator=generator,
                            noisy_features=True, upsample_logits=False)
            step = _step_votes(model, out, fused_upsample, H, W)
            if votes is None:
                votes = torch.empty((num_steps,) + tuple(step.shape),
                                    dtype=torch.uint8, device=x.device)
            votes[s] = step
        ent = ent_ops.vote_entropy(votes, num_classes)
        if votes.dim() == 5:   # parity-major B2 votes: interleave once
            ent = tv.interleave_parity_major(ent)
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


def _feature_map(model, images) -> torch.Tensor:
    """(B, C, fh, fw) decoder feature tap of one eval-mode forward:
    DeepLab's 304-channel concat, ENet's stage-3 output."""
    if model.training:
        raise ValueError("feature extraction needs the model in eval mode")
    _, feats = model(normalize_on_device(images), use_dropout=False,
                     upsample_logits=False, return_features=True)
    return feats


def pooled_features(model, images, pool_kernel: int,
                    pool_stride: int) -> torch.Tensor:
    """(B, D) avg-pooled, flattened feature vectors (core_set.py:57-63,
    max_subset.py:73-89), TF32 off. Kernel and stride are clamped to the
    map, k = min(kernel, fh, fw), s = min(stride, k), as in the JAX
    package (kernels.py:290: the reference's fixed pool errors on maps
    smaller than its kernel); the pool is VALID. Flattened in (h, w, c)
    order, the JAX package's NHWC order, element for element."""
    with torch.inference_mode(), _deterministic_precision():
        feats = _feature_map(model, images)
        k = min(pool_kernel, feats.shape[2], feats.shape[3])
        pooled = torch.nn.functional.avg_pool2d(feats, k, min(pool_stride, k))
        return pooled.permute(0, 2, 3, 1).reshape(pooled.shape[0], -1)


def raw_features(model, images) -> torch.Tensor:
    """(B, fh, fw, C) feature map, NHWC as the JAX package returns it
    (kernels.py:314), TF32 off."""
    with torch.inference_mode(), _deterministic_precision():
        return _feature_map(model, images).permute(0, 2, 3, 1)


def misprediction_counts(model, images, labels,
                         num_classes: int) -> torch.Tensor:
    """(B,) f32 oracle counts of valid pixels whose argmax is not the label
    (accuracy.py:18-37), TF32 off; ``labels`` is the full label plane. A
    two-headed model is scored by its segmentation head."""
    with torch.inference_mode(), _deterministic_precision():
        logits = _deterministic_logits(model, images)
        if isinstance(logits, tuple):
            logits = logits[0]
        pred = logits.argmax(dim=1)
        valid = ent_ops.valid_mask(labels, num_classes)
        wrong = valid & (pred != labels.to(torch.int64))
        return wrong.sum(dim=(1, 2)).to(torch.float32)


def _error_logits(model, images, labels, num_classes: int,
                  labels_packed: bool):
    """(error-head logits (B, 2, H, W), valid mask (B, H, W)) of one
    eval-mode forward of the two-headed model."""
    labels = _unpacked_labels(labels, images.shape[2], num_classes,
                              labels_packed)
    _, err = _deterministic_logits(model, images)
    return err, ent_ops.valid_mask(labels, num_classes)


def error_head_scores(model, images, labels, num_classes: int, mode: str,
                      labels_packed: bool = False) -> torch.Tensor:
    """(B,) per-image scores of the two-headed model's error head
    (accuracy.py:39-71, 98-117), TF32 off:

      'softmax' — the sum of P(wrong) (class 0) over valid pixels;
      'argmax'  — the count of valid pixels predicted wrong;
      'unsure'  — the mean of 4p - 4p^2, p = P(right) (class 1), over the
                  valid pixels (at least one).
    """
    if mode not in ("softmax", "argmax", "unsure"):
        raise NotImplementedError(mode)
    with torch.inference_mode(), _deterministic_precision():
        err, valid = _error_logits(model, images, labels, num_classes,
                                   labels_packed)
        if mode == "softmax":
            y = torch.softmax(err, dim=1)[:, 0]
        elif mode == "argmax":
            y = 1.0 - err.argmax(dim=1).to(torch.float32)
        else:
            p = torch.softmax(err, dim=1)[:, 1]
            y = 4.0 * p - 4.0 * p * p
        total = torch.where(valid, y, 0.0).sum(dim=(1, 2))
        if mode == "unsure":
            total = total / valid.sum(dim=(1, 2)).clamp_min(1)
        return total


def error_head_maps(model, images, labels, num_classes: int,
                    labels_packed: bool = False) -> torch.Tensor:
    """(B, H, W) P(wrong) maps of the error head, 0 at ignored pixels
    (accuracy.py:131-161), TF32 off."""
    with torch.inference_mode(), _deterministic_precision():
        err, valid = _error_logits(model, images, labels, num_classes,
                                   labels_packed)
        return torch.where(valid, torch.softmax(err, dim=1)[:, 0], 0.0)


def input_gradient_norms(model, images, labels, num_classes: int,
                         labels_packed: bool = False) -> torch.Tensor:
    """(B,) mean over all H*W pixels of ||d sum(error logits) / d input||_2
    (accuracy.py:73-96), the input being the error head's
    ``cat([softmax(seg), normalized image])`` and the norm taken over its
    channels, 0 at ignored pixels; the error head in eval mode, TF32 off.
    The only selector that runs backward: call it outside
    ``torch.inference_mode``."""
    labels = _unpacked_labels(labels, images.shape[2], num_classes,
                              labels_packed)
    if model.training:
        raise ValueError("deterministic scoring needs the model in eval mode "
                         "(BN at running statistics, no dropout)")
    with _deterministic_precision():
        x = normalize_on_device(images)
        with torch.no_grad():
            probs = torch.softmax(model.deeplab(x), dim=1)
        inp = torch.cat([probs, x], dim=1).requires_grad_(True)
        with torch.enable_grad():
            out = model(x, unet_only_input=inp)
            (grad,) = torch.autograd.grad(out.sum(), inp)
        norms = grad.square().sum(dim=1).sqrt()
        valid = ent_ops.valid_mask(labels, num_classes)
        return torch.where(valid, norms, 0.0).mean(dim=(1, 2))
