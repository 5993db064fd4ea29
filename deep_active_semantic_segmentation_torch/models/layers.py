"""Shared NCHW building blocks with the JAX package's semantics.

* ``conv`` / ``batch_norm`` — torch Conv2d and BatchNorm2d as the reference
  builds them (BN momentum 0.1, eps 1e-5); kernel, padding and dilation
  may be (h, w) pairs (ENet's asymmetric 5x1 / 1x5 convs). The conv is a
  ``Conv2d``: under ``parallel.spatial.spatial_rows`` (the height-sharded
  step) a conv whose window spans rows fetches the rows it reads across
  the bands' edges first; ``MaxPool2d`` and ``ConvTranspose2d`` do the
  same for the 3x3 / stride 2 pool and transposed conv.
  ``init_weights`` draws every conv and transposed-conv kernel
  kaiming-normal (fan_in, gain^2 = 2, untruncated) from an explicit
  generator, BN weight 1 / bias 0, conv bias 0.
* ``activation`` — ENet's one shared activation per block: ReLU, or one
  scalar PReLU (flax ``nn.PReLU``: slope init 0.01) that the block reuses
  for all its activations.
* ``ChannelDropout`` — torch ``nn.Dropout2d`` semantics (one Bernoulli per
  (image, channel), survivors scaled by 1/(1-p)) with the draw taken from
  an explicit ``torch.Generator`` on the tensor's device, so MC-dropout
  masks are reproducible per (seed, batch). Under ``dropout_rows`` (a
  data-parallel train step) a rank draws the global batch's masks and
  keeps its rows, so N ranks see the one-card step's masks.
* ``feature_noise`` — the MC-noise hook: additive gaussian noise scaled
  by |mean(x)| over the whole batch tensor, drawn from an explicit
  generator.
* ``fixed_padding`` (TF-style SAME pad, reference
  models/backbone/mobilenet.py:23-30); on height-sharded bands only the
  global top and bottom bands pad their rows. ReLU6 is torch's
  ``nn.ReLU6``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_active_semantic_segmentation_torch.parallel.spatial import (
    sharded_conv, sharded_conv_transpose, sharded_max_pool)

Pair = Union[int, Tuple[int, int]]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (the same parameters and state_dict keys). ``shard``:
    the spatial axis under ``spatial_rows``, when the input is this
    rank's band of rows; a conv that reads across rows (a window taller
    than 1, or a stride) then runs as ``parallel.spatial.sharded_conv``.
    ``edge_rows``: rows of ``fixed_padding`` its input carries at the
    global top and bottom (the inverted residuals' depthwise convs)."""

    shard = None
    edge_rows = (0, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard is None or (self.kernel_size[0], self.stride[0]) == (1, 1):
            return super().forward(x)
        return sharded_conv(self, x, self.shard)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d(3, 2, 1)`` (no state). ``shard``: as ``Conv2d``'s;
    the pool then runs as ``parallel.spatial.sharded_max_pool`` (its
    padding -inf at the global top only)."""

    shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard is None:
            return super().forward(x)
        if (self.kernel_size, self.stride, self.padding) != (3, 2, 1):
            raise NotImplementedError(f"a height-sharded {self}")
        return sharded_max_pool(x, self.shard)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (the same parameters and state_dict keys).
    ``shard``: as ``Conv2d``'s; the 3x3 / stride 2 transposed conv then
    runs as ``parallel.spatial.sharded_conv_transpose``."""

    shard = None

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        if self.shard is None:
            return super().forward(x, output_size)
        return sharded_conv_transpose(self, x, self.shard)


def conv(cin: int, cout: int, kernel: Pair, stride: int = 1, padding: Pair = 0,
         dilation: Pair = 1, groups: int = 1, bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, bias=bias)


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Reference ``_init_weight``: kaiming-normal convs, BN weight=1 bias=0;
    conv biases start at 0 as in the JAX package. A transposed conv's
    fan_in is its input channels times its window, as for the JAX
    package's HWIO kernel."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = (m.weight[0].numel() if isinstance(m, nn.Conv2d)
                      else m.weight[:, 0].numel())
            m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()


def activation(relu: bool) -> nn.Module:
    """ReLU, or one scalar PReLU with flax's slope init 0.01 (the JAX
    package's ``models/enet.py::_activation``)."""
    return nn.ReLU() if relu else nn.PReLU(num_parameters=1, init=0.01)


class ChannelDropout(nn.Module):
    """Channel dropout (torch nn.Dropout2d) drawing from a given generator.

    ``forward(x, generator)``: with ``generator=None`` the layer is off
    (identity); otherwise one keep/drop per (image, channel) is drawn from
    ``generator`` and survivors are scaled by 1/(1-p). Holds no parameters,
    so it leaves the state_dict keys of the module around it unchanged.
    ``rows`` = (rank, world): the masks are drawn for ``world`` times the
    batch and rows [rank * B, (rank + 1) * B) are kept (``dropout_rows``).
    """

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.rows = (0, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            return x
        keep = 1.0 - self.p
        rank, world = self.rows
        b = x.shape[0]
        # drawn in f32 whatever x's dtype, so f32 and bf16 forwards from
        # one generator state see the same masks
        mask = torch.empty((b * world,) + x.shape[1:2] + (1, 1),
                           dtype=torch.float32, device=x.device)
        mask.bernoulli_(keep, generator=generator).div_(keep)
        return x * mask[rank * b:(rank + 1) * b].to(x.dtype)

    def extra_repr(self) -> str:
        return f"p={self.p}"


@contextlib.contextmanager
def dropout_rows(model: nn.Module, rank: int, world: int):
    """For the length of a ``with`` block, every ``ChannelDropout`` of
    ``model`` draws the masks of a ``world``-rank global batch and keeps
    rank ``rank``'s rows (the data-parallel train step's forward)."""
    drops = [m for m in model.modules() if isinstance(m, ChannelDropout)]
    for m in drops:
        m.rows = (rank, world)
    try:
        yield
    finally:
        for m in drops:
            m.rows = (0, 1)


def fixed_padding_rows(kernel_size: int, dilation: int) -> Tuple[int, int]:
    """(before, after): the TF-style SAME pad of each side."""
    effective = kernel_size + (kernel_size - 1) * (dilation - 1)
    pad_total = effective - 1
    beg = pad_total // 2
    return beg, pad_total - beg


def fixed_padding(x: torch.Tensor, kernel_size: int, dilation: int,
                  shard=None) -> torch.Tensor:
    """Reference models/backbone/mobilenet.py:23-30 (TF-style SAME pad).
    ``shard`` (the spatial axis; ``x`` this rank's band of rows): the
    columns pad on every rank, the rows only at the global top (rank 0)
    and bottom (the last rank), so the bands together are the padded
    image."""
    beg, end = fixed_padding_rows(kernel_size, dilation)
    top, bottom = beg, end
    if shard is not None:
        top = beg if shard.rank == 0 else 0
        bottom = end if shard.rank == shard.world - 1 else 0
    return F.pad(x, (beg, end, top, bottom))


def noise_scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """|mean(x)| * factor as a 0-d f32 tensor: the mean over the WHOLE
    tensor, batch included (a padded batch's duplicates too, as in the JAX
    package), formed in f32 whatever x's dtype."""
    return x.float().mean().abs() * factor


def feature_noise(x: torch.Tensor, factor: float,
                  generator: torch.Generator) -> torch.Tensor:
    """x + sigma * N(0, 1), sigma = ``noise_scale(x, factor)`` (the JAX
    package's ``models/layers.py::feature_noise``, the reference's
    noisy-features hook, models/deeplab.py:39-56). The draw is f32 from
    ``generator`` whatever x's dtype, so f32 and bf16 forwards from one
    generator state see the same noise."""
    z = torch.randn(x.shape, dtype=torch.float32, device=x.device,
                    generator=generator)
    return x + (noise_scale(x, factor) * z).to(x.dtype)
