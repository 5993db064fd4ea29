"""ENet (parity: reference models/enet.py:486-664, the JAX package's
models/enet.py).

Initial block (strided conv || max pool, concat), regular / dilated /
asymmetric bottlenecks, downsampling bottlenecks that keep their pool's
argmax, upsampling bottlenecks that max-unpool with it, and the final
``ConvTranspose2d(16, C, 3, s2, p1, op1)`` classifier. NCHW.

Module names keep the reference's torch ``state_dict`` keys, the ones the
JAX package's ``models/pretrained.py::enet_state_dict_to_flax`` reads
(``regular1_1.ext_conv1.0.weight``, ``asymmetric2_3.ext_conv2.3.weight``,
``upsample4_0.ext_conv2.0.weight``, ``transposed_conv.weight``, ...). A
block's one shared activation is ``act`` (``out_act`` in the initial
block); its PReLU slope, which that mapping does not carry, sits under
that key.

Pool and unpool are deterministic and give the JAX package's answer:
``max_pool_with_indices`` returns the window-offset selector (0..8,
row-major in the 3x3 window) of the first maximum, and ``max_unpool2x``
is the JAX package's parity-plane unpool, where a write collision goes to
the window that is last in row-major order. (``F.max_unpool2d`` leaves
the order of colliding writes undefined on CUDA.)

Call-time flags mirror the JAX package's:

* ``use_dropout`` (default ``self.training``) with ``generator`` — every
  Dropout2d site draws its mask from ``generator``, which dropout needs.
* ``upsample_logits=False`` — return the stage-5 features
  (B, 16, H/2, W/2) instead of the classifier's logits; the fused
  transposed-conv + argmax kernel (ops/tconv_votes.py) consumes them.
* ``prefix_only`` / ``prefix_features`` — the MC hoist: everything up to
  ``downsample1_0``'s dropout is deterministic, so MC scoring computes
  (padded pool main, pool selector, pre-dropout ext) once per batch and
  feeds it back in. That dropout is the first draw both ways, so with the
  same generator state the hoisted forward equals the monolithic one.
* ``return_features`` — also return the stage-3 encoder output.
* ``noisy_features`` — MC-noise: one ``layers.feature_noise`` site after
  stage 3 (x0.5), drawn from ``generator`` (the returned stage-3
  features are the noise-free ones, as in the JAX package).

Under ``parallel.spatial.spatial_rows`` ``x`` is this rank's band of
every image's rows, a multiple of 8 rows, and the logits are the same
band of the whole image's: the convs fetch their halos
(``layers.Conv2d``); the initial block's pool (on the normalized image,
so its -inf edge matters) and the downsampling pools read one halo row
above (``parallel.spatial.sharded_max_pool``, whose selector counts
offsets as on the whole image); the unpool reads the window under a
band's last row from the next band (``parallel.spatial.row_below``:
values and selectors, 0 and -1 below the global bottom); the transposed
convs read one row below (``layers.ConvTranspose2d``). Every spatial rank
of a data row draws the same dropout masks (``layers.dropout_rows``).
MC noise is refused there (its scale is a mean over the whole tensor).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_active_semantic_segmentation_torch.models.layers import (
    ChannelDropout, ConvTranspose2d, MaxPool2d, activation, batch_norm, conv,
    feature_noise)
from deep_active_semantic_segmentation_torch.parallel.spatial import (
    check_band, row_below, sharded_max_pool)


def max_pool_with_indices(x: torch.Tensor, shard=None):
    """MaxPool2d(3, stride 2, padding 1) -> (pooled, selector). The
    selector is the int8 offset ``3*dr + dc`` of the first maximum in the
    window (row-major scan, strict '>', as torch's pool and the JAX
    package's tournament both break ties), not torch's flat index.
    ``shard``: ``x`` is this rank's band of the rows (the height check
    reads the global height)."""
    B, C, H, W = x.shape
    H *= shard.world if shard is not None else 1
    if H % 2 or W % 2:
        raise ValueError(
            f"ENet requires even input sizes (its MaxUnpool2d(2) doubles "
            f"the pooled grid exactly; the torch reference also fails "
            f"end-to-end at odd sizes) — got {H}x{W}. Use an even "
            f"--crop-size (e.g. 512) with --architecture enet.")
    if shard is not None:
        return sharded_max_pool(x, shard, selector=True)
    pooled, flat = F.max_pool2d(x, 3, 2, 1, return_indices=True)
    h, w = pooled.shape[2:]
    # window (r, c) starts at plane cell (2r-1, 2c-1)
    dr = flat // W - 2 * torch.arange(h, device=x.device)[:, None] + 1
    dc = flat % W - 2 * torch.arange(w, device=x.device) + 1
    return pooled, (3 * dr + dc).to(torch.int8)


def max_unpool2x(values: torch.Tensor, selector: torch.Tensor,
                 shard=None) -> torch.Tensor:
    """MaxUnpool2d(2) for a 3x3/s2/p1 pool's selector, scatter-free (the
    JAX package's ``max_unpool2x``). Window (r, c) with offset (dr, dc)
    wrote its value at plane cell (2r+dr-1, 2c+dc-1); grouped by output
    parity, each cell has a fixed set of candidate writers:

      even y, even x: d=(1,1) from (i, j)
      even y, odd  x: d=(1,0) from (i, j+1);   d=(1,2) from (i, j)
      odd  y, even x: d=(0,1) from (i+1, j);   d=(2,1) from (i, j)
      odd  y, odd  x: d=(0,0) from (i+1, j+1); d=(0,2) from (i+1, j);
                      d=(2,0) from (i, j+1);   d=(2,2) from (i, j)

    A collision goes to the window last in row-major order, the JAX
    package's rule; cells no window wrote are 0. The windows (i+1, .)
    are the rows of the band extended by one row below: the next band's
    first row under ``shard``, else none (values 0, selectors -1)."""
    B, C, h, w = values.shape
    if shard is None:
        ve = F.pad(values, (0, 0, 0, 1))
        se = F.pad(selector, (0, 0, 0, 1), value=-1)
    else:
        ve, se = row_below(values, shard), row_below(selector, shard, -1)

    def left(a, fill):    # read from window (i, j+1)
        return F.pad(a[..., 1:], (0, 1), value=fill)

    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    vel, sel = left(ve, 0), left(se, -1)
    v_l, s_l = vel[:, :, :h], sel[:, :, :h]
    v_u, s_u = ve[:, :, 1:], se[:, :, 1:]        # window (i+1, j)
    v_ul, s_ul = vel[:, :, 1:], sel[:, :, 1:]    # window (i+1, j+1)

    p00 = torch.where(selector == 4, values, zero)
    p01 = torch.where(s_l == 3, v_l, torch.where(selector == 5, values, zero))
    p10 = torch.where(s_u == 1, v_u, torch.where(selector == 7, values, zero))
    p11 = torch.where(selector == 8, values, zero)
    p11 = torch.where(s_l == 6, v_l, p11)
    p11 = torch.where(s_u == 2, v_u, p11)
    p11 = torch.where(s_ul == 0, v_ul, p11)

    top = torch.stack([p00, p01], dim=-1)             # (B, C, h, w, 2)
    bot = torch.stack([p10, p11], dim=-1)
    return torch.stack([top, bot], dim=3).reshape(B, C, 2 * h, 2 * w)


def transposed_conv2x(cin: int, cout: int) -> ConvTranspose2d:
    """torch ConvTranspose2d(3, stride 2, padding 1, output_padding 1),
    bias-free: exactly doubles h and w (the JAX package's
    ``ConvTranspose2dTorch``)."""
    return ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                           output_padding=1, bias=False)


def _conv_bn(*convs: nn.Module) -> nn.Sequential:
    """(conv, BN) pairs at the reference's Sequential indices: one pair at
    0, 1; two at 0, 1 and 3, 4. Index 2, where the reference's Sequential
    holds its activation, is a parameter-free slot here, since the block
    applies its one shared ``act`` itself."""
    layers = []
    for i, c in enumerate(convs):
        if i:
            layers.append(nn.Identity())
        layers += [c, batch_norm(c.out_channels)]
    return nn.Sequential(*layers)


class InitialBlock(nn.Module):
    """enet.py:6-74: 13-ch conv stride 2 || 3-ch max pool, concat, BN, act."""

    def __init__(self, out_channels: int = 16, relu: bool = True):
        super().__init__()
        self.main_branch = conv(3, out_channels - 3, 3, 2, 1)
        self.pool = MaxPool2d(3, 2, 1)
        self.batch_norm = batch_norm(out_channels)
        self.out_act = activation(relu)

    def forward(self, x):
        y = torch.cat([self.main_branch(x), self.pool(x)], dim=1)
        return self.out_act(self.batch_norm(y))


class RegularBottleneck(nn.Module):
    """enet.py:77-215: shortcut + (1x1 -> kxk [or kx1, 1xk] -> 1x1 ->
    Dropout2d)."""

    def __init__(self, channels: int, internal_ratio: int = 4,
                 kernel_size: int = 3, padding: int = 0, dilation: int = 1,
                 asymmetric: bool = False, dropout_prob: float = 0.0,
                 relu: bool = True):
        super().__init__()
        internal = channels // internal_ratio
        self.asymmetric = asymmetric
        self.ext_conv1 = _conv_bn(conv(channels, internal, 1))
        if asymmetric:
            self.ext_conv2 = _conv_bn(
                conv(internal, internal, (kernel_size, 1), 1, (padding, 0),
                     dilation=dilation),
                conv(internal, internal, (1, kernel_size), 1, (0, padding),
                     dilation=dilation))
        else:
            self.ext_conv2 = _conv_bn(conv(internal, internal, kernel_size, 1,
                                           padding, dilation=dilation))
        self.ext_conv3 = _conv_bn(conv(internal, channels, 1))
        self.ext_regul = ChannelDropout(dropout_prob)
        self.act = activation(relu)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        act, c2 = self.act, self.ext_conv2
        ext = act(self.ext_conv1(x))
        ext = act(c2[1](c2[0](ext)))
        if self.asymmetric:
            ext = act(c2[4](c2[3](ext)))
        ext = act(self.ext_conv3(ext))
        return act(x + self.ext_regul(ext, generator))


class DownsamplingBottleneck(nn.Module):
    """enet.py:218-362: max pool with indices on the main branch (channels
    zero-padded to ``out_channels``) + 2x2/s2 -> 3x3 -> 1x1 extension.

    ``pre_dropout_only`` returns (padded main, selector, pre-dropout ext);
    ``precomputed`` takes that triple back and runs only dropout + merge."""

    shard = None   # the spatial axis under spatial_rows

    def __init__(self, in_channels: int, out_channels: int,
                 internal_ratio: int = 4, dropout_prob: float = 0.0,
                 relu: bool = True):
        super().__init__()
        internal = in_channels // internal_ratio
        self.pad_channels = out_channels - in_channels
        self.ext_conv1 = _conv_bn(conv(in_channels, internal, 2, 2, 0))
        self.ext_conv2 = _conv_bn(conv(internal, internal, 3, 1, 1))
        self.ext_conv3 = _conv_bn(conv(internal, out_channels, 1))
        self.ext_regul = ChannelDropout(dropout_prob)
        self.act = activation(relu)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                pre_dropout_only: bool = False, precomputed=None):
        if precomputed is None:
            main, selector = max_pool_with_indices(x, self.shard)
            main = F.pad(main, (0, 0, 0, 0, 0, self.pad_channels))
            ext = self.act(self.ext_conv1(x))
            ext = self.act(self.ext_conv2(ext))
            ext = self.act(self.ext_conv3(ext))
            if pre_dropout_only:
                return main, selector, ext
        else:
            main, selector, ext = precomputed
        return self.act(main + self.ext_regul(ext, generator)), selector


class UpsamplingBottleneck(nn.Module):
    """enet.py:365-483: 1x1 + BN + unpool main branch, 1x1 -> transposed
    conv -> 1x1 extension."""

    shard = None   # the spatial axis under spatial_rows

    def __init__(self, in_channels: int, out_channels: int,
                 internal_ratio: int = 4, dropout_prob: float = 0.0,
                 relu: bool = True):
        super().__init__()
        internal = in_channels // internal_ratio
        self.main_conv1 = _conv_bn(conv(in_channels, out_channels, 1))
        self.ext_conv1 = _conv_bn(conv(in_channels, internal, 1))
        self.ext_conv2 = _conv_bn(transposed_conv2x(internal, internal))
        self.ext_conv3 = _conv_bn(conv(internal, out_channels, 1))
        self.ext_regul = ChannelDropout(dropout_prob)
        self.act = activation(relu)

    def forward(self, x, selector, generator: Optional[torch.Generator] = None):
        main = max_unpool2x(self.main_conv1(x), selector, self.shard)
        ext = self.act(self.ext_conv1(x))
        ext = self.act(self.ext_conv2(ext))
        ext = self.act(self.ext_conv3(ext))
        return self.act(main + self.ext_regul(ext, generator))


# (kind, RegularBottleneck arguments) of the eight 128-channel
# bottlenecks of stage 2 (named from 1) and stage 3 (named from 0)
STAGE23 = (
    ("regular", dict(padding=1)),
    ("dilated", dict(dilation=2, padding=2)),
    ("asymmetric", dict(kernel_size=5, padding=2, asymmetric=True)),
    ("dilated", dict(dilation=4, padding=4)),
    ("regular", dict(padding=1)),
    ("dilated", dict(dilation=8, padding=8)),
    ("asymmetric", dict(kernel_size=5, padding=2, asymmetric=True)),
    ("dilated", dict(dilation=16, padding=16)),
)


def stage23_names():
    """(name, kind, arguments) of stages 2 and 3, by the reference's names."""
    return [(f"{kind}{stage}_{start + k}", kind, spec)
            for stage, start in (("2", 1), ("3", 0))
            for k, (kind, spec) in enumerate(STAGE23)]


class ENet(nn.Module):
    model_name = "enet"
    shard = None   # the spatial axis under spatial_rows

    def __init__(self, num_classes: int = 19, encoder_relu: bool = False,
                 decoder_relu: bool = True):
        super().__init__()
        er, dr = encoder_relu, decoder_relu
        self.num_classes = num_classes
        self.initial_block = InitialBlock(16, relu=er)
        self.downsample1_0 = DownsamplingBottleneck(16, 64, dropout_prob=0.01,
                                                    relu=er)
        for i in range(1, 5):
            self.add_module(f"regular1_{i}", RegularBottleneck(
                64, padding=1, dropout_prob=0.01, relu=er))
        self.downsample2_0 = DownsamplingBottleneck(64, 128, dropout_prob=0.1,
                                                    relu=er)
        self.stage23 = [name for name, _, _ in stage23_names()]
        for name, _, spec in stage23_names():
            self.add_module(name, RegularBottleneck(128, dropout_prob=0.1,
                                                    relu=er, **spec))
        self.upsample4_0 = UpsamplingBottleneck(128, 64, dropout_prob=0.1,
                                                relu=dr)
        self.regular4_1 = RegularBottleneck(64, padding=1, dropout_prob=0.1,
                                            relu=dr)
        self.regular4_2 = RegularBottleneck(64, padding=1, dropout_prob=0.1,
                                            relu=dr)
        self.upsample5_0 = UpsamplingBottleneck(64, 16, dropout_prob=0.1,
                                                relu=dr)
        self.regular5_1 = RegularBottleneck(16, padding=1, dropout_prob=0.1,
                                            relu=dr)
        self.transposed_conv = transposed_conv2x(16, num_classes)

    def forward(self, x, use_dropout: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                return_features: bool = False,
                noisy_features: bool = False,
                upsample_logits: bool = True,
                prefix_only: bool = False,
                prefix_features=None):
        if use_dropout is None:
            use_dropout = self.training
        if use_dropout and generator is None:
            raise ValueError("dropout needs an explicit torch.Generator")
        if noisy_features and generator is None:
            raise ValueError("noisy_features needs an explicit torch.Generator")
        gen = generator if use_dropout else None
        if self.shard is not None:
            if noisy_features:
                raise ValueError("noisy_features on height-sharded bands")
            if x is not None:
                check_band(self, x.shape[2])

        if prefix_features is None:
            y = self.initial_block(x)
            if prefix_only:
                return self.downsample1_0(y, pre_dropout_only=True)
            y, sel1 = self.downsample1_0(y, gen)
        else:
            y, sel1 = self.downsample1_0(None, gen, precomputed=prefix_features)
        for i in range(1, 5):
            y = getattr(self, f"regular1_{i}")(y, gen)
        y, sel2 = self.downsample2_0(y, gen)
        for name in self.stage23:
            y = getattr(self, name)(y, gen)
        features = y
        if noisy_features:
            y = feature_noise(y, 0.5, generator)

        y = self.upsample4_0(y, sel2, gen)
        y = self.regular4_1(y, gen)
        y = self.regular4_2(y, gen)
        y = self.upsample5_0(y, sel1, gen)
        y = self.regular5_1(y, gen)
        if upsample_logits:
            y = self.transposed_conv(y)
        if return_features:
            return y, features
        return y
