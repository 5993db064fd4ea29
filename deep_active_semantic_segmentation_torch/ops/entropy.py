"""Uncertainty scoring helpers: vote entropy, softmax entropy, confidence
and margin (own copy of the JAX package's ops/entropy.py).

Parity targets:
* vote entropy over MC argmax votes — reference
  active_selection/mc_dropout.py:43-49 (log2, +1e-12 eps, ignored pixels
  zeroed);
* softmax entropy — ceal.py:114-119; max-softmax confidence —
  ceal.py:36-39 (ignored pixels 1); best-minus-second margin — ceal.py
  :83-91 (ignored pixels 1).

Logits are NCHW (classes on dim 1); the softmax is taken in f32.
"""

from __future__ import annotations

import torch

LOG2_EPS = 1e-12


def valid_mask(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """True where the ground-truth label is a real class (ref mc_dropout.py:45)."""
    lab = labels.to(torch.int32)
    return (lab >= 0) & (lab < num_classes)


def unpack_mask(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of ``np.packbits(mask, axis=-1)`` (MSB-first): uint8
    (..., ceil(W/8)) -> bool (..., W). Device half of the packed-mask
    scoring wire (data/loader.PathsLoader ``labels_as_mask``)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    return bits[..., :width].to(torch.bool)


def vote_entropy(votes: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(S, B, H, W) integer votes -> (B, H, W) f32 per-pixel vote entropy,
    H = -sum_c p_c log2(p_c + 1e-12) with p_c = count_c / S: the JAX
    package's formula (selection/kernels.py:175-178), one pass per class
    over the compact vote stack."""
    num_steps = votes.shape[0]
    ent = torch.zeros(votes.shape[1:], dtype=torch.float32,
                      device=votes.device)
    for c in range(num_classes):
        p = (votes == c).sum(dim=0, dtype=torch.int32).to(torch.float32) / num_steps
        ent = ent - p * torch.log2(p + LOG2_EPS)
    return ent


def softmax_entropy(logits: torch.Tensor, labels: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """(B, C, H, W) logits -> (B, H, W) per-pixel softmax entropy, zeroed
    at ignored pixels (ceal.py:114-119)."""
    p = torch.softmax(logits.to(torch.float32), dim=1)
    ent = -(p * torch.log2(p + LOG2_EPS)).sum(dim=1)
    return torch.where(valid_mask(labels, num_classes), ent,
                       torch.zeros_like(ent))


def max_confidence(logits: torch.Tensor, labels: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """Per-pixel max softmax probability; ignored pixels 1 (ceal.py:36-39)."""
    conf = torch.softmax(logits.to(torch.float32), dim=1).amax(dim=1)
    return torch.where(valid_mask(labels, num_classes), conf,
                       torch.ones_like(conf))


def margin(logits: torch.Tensor, labels: torch.Tensor,
           num_classes: int) -> torch.Tensor:
    """Best-minus-second-best softmax probability; ignored pixels 1
    (ceal.py:83-91)."""
    p = torch.softmax(logits.to(torch.float32), dim=1)
    top2 = p.topk(2, dim=1).values
    m = top2[:, 0] - top2[:, 1]
    return torch.where(valid_mask(labels, num_classes), m, torch.ones_like(m))


def mean_over_pixels(maps: torch.Tensor) -> torch.Tensor:
    """Per-image mean over the spatial map (the reference's image score)."""
    return maps.to(torch.float32).mean(dim=(1, 2))
