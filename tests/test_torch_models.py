"""The port's DeepLab-v3+/MobileNetV2 against the JAX package's, with the
weights carried across by flax_to_deeplab_state_dict.

Tolerance of the forward checks: max |port - jax| <= 1e-4 * max |jax|. Both
run f32 on the CPU; the convolutions sum in other orders (oneDNN vs XLA)
and BN folds its scale differently, which leaves ~1e-5 relative after the
network's ~60 layers."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.models.convert import (
    flax_to_deeplab_state_dict)
from deep_active_semantic_segmentation_torch.models.layers import ChannelDropout
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    deeplab_state_dict_to_flax)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    jax_deeplab, one_torch_thread, port_deeplab)

REL_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    model, params, stats = jax_deeplab(seed=0)
    return model, params, stats, port_deeplab(params, stats)


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def test_parameter_counts_equal(pair):
    _, params, _, port = pair
    jax_count = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == jax_count == 5815539


def test_state_dict_round_trips_exactly(pair):
    _, params, stats, port = pair
    sd = flax_to_deeplab_state_dict(params, stats)
    # the converted dict has exactly the model's (reference) keys
    assert set(sd) == set(port.state_dict())
    assert "backbone.features.1.conv.3.weight" in sd
    assert "backbone.low_level_features.3.conv.7.running_var" in sd
    assert "aspp.global_average_pool.1.weight" in sd
    assert "decoder.last_conv.7.bias" in sd
    back_p, back_s = deeplab_state_dict_to_flax(
        {k: v.numpy() for k, v in port.state_dict().items()})
    for a, b in ((params, back_p), (stats, back_s)):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("size", [33, 65])
def test_dropout_off_forward_matches_jax(pair, size):
    model, params, stats, port = pair
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    apply = jax.jit(partial(model.apply, train=False),
                    static_argnames=("upsample_logits", "backbone_only"))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        _close(_nhwc(port(xt)), apply(variables, x))
        low = port(xt, upsample_logits=False)
        assert low.shape[2:] == ((size - 1) // 4 + 1,) * 2
        _close(_nhwc(low), apply(variables, x, upsample_logits=False))
        high, low_level = port(xt, backbone_only=True)
        jh, jl = apply(variables, x, backbone_only=True)
        _close(_nhwc(high), jh)
        _close(_nhwc(low_level), jl)


def test_hoisted_mc_forward_equals_monolithic(pair):
    *_, port = pair
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 3, 33, 33)
                         .astype(np.float32))
    with torch.no_grad():
        feats = port(x, backbone_only=True)
        for upsample in (True, False):
            mono = port(x, use_dropout=True, upsample_logits=upsample,
                        generator=torch.Generator().manual_seed(7))
            hoisted = port(x, use_dropout=True, upsample_logits=upsample,
                           backbone_features=feats,
                           generator=torch.Generator().manual_seed(7))
            assert torch.equal(mono, hoisted)
        # and dropout really acts: another draw gives other logits
        other = port(x, use_dropout=True, upsample_logits=False,
                     backbone_features=feats,
                     generator=torch.Generator().manual_seed(8))
        assert not torch.equal(mono, other)
        with pytest.raises(ValueError, match="Generator"):
            port(x, use_dropout=True)


def test_channel_dropout_is_torch_dropout2d():
    x = torch.ones(64, 32, 5, 5)
    y = ChannelDropout(0.25)(x, torch.Generator().manual_seed(0))
    # one draw per (image, channel), survivors scaled by 1/(1-p)
    per_channel = y[:, :, :1, :1]
    assert torch.equal(y, per_channel.expand_as(y))
    assert set(torch.unique(y).tolist()) == {0.0, torch.tensor(1.0 / 0.75).item()}
    assert abs((per_channel == 0).float().mean().item() - 0.25) < 0.03
    assert torch.equal(ChannelDropout(0.25)(x), x)  # no generator: off
