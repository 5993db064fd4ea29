"""The port's UNet against the JAX package's, on the same numpy inputs and
weights: the forward at an even and an odd size, with the JAX UNet on its
default space-to-depth path (the zero-refreshed odd canvas included) and
on its plain path, in eval mode and in train mode (batch statistics); and
the weight mapping, whose result the JAX package's own
``unet_state_dict_to_flax`` takes back bit for bit.

Tolerance: logits within 3e-5 of the largest |logit| (measured: at most
3.1e-6 of it in eval mode and 9.6e-6 in train mode, where BN divides by
the batch's standard deviation)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.models.convert import (
    flax_to_unet_state_dict)
from deep_active_semantic_segmentation_torch.models.factory import build_model
from deep_active_semantic_segmentation_torch.models.unet import UNet
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    unet_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.models.unet import UNet as JaxUNet
from torch_port_helpers import draw_like, one_torch_thread  # noqa: F401

CIN, NCLASS = 6, 2
REL = 3e-5


@pytest.fixture(scope="module")
def weights():
    """(params, batch_stats) of a JAX UNet drawn with numpy (seed 3)."""
    shapes = jax.eval_shape(partial(JaxUNet(in_channels=CIN, num_classes=NCLASS).init,
                                    train=False),
                            {"params": jax.random.PRNGKey(0)},
                            jax.ShapeDtypeStruct((1, 32, 32, CIN), jnp.float32))
    rng = np.random.RandomState(3)
    return draw_like(shapes["params"], rng), draw_like(shapes["batch_stats"], rng)


def _port(params, stats):
    model = UNet(in_channels=CIN, num_classes=NCLASS)
    model.load_state_dict(flax_to_unet_state_dict(params, stats))
    return model


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("use_s2d", [True, False])
@pytest.mark.parametrize("side", [32, 33])
def test_unet_forward_matches_jax(weights, side, use_s2d, train):
    params, stats = weights
    x = np.random.RandomState(side).randn(2, side, side + 2, CIN).astype(np.float32)
    jmodel = JaxUNet(in_channels=CIN, num_classes=NCLASS, use_s2d=use_s2d)
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                       train=train, mutable=["batch_stats"] if train else False)
    ref = np.asarray(ref[0] if train else ref)
    model = _port(params, stats).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, side, side + 2, NCLASS)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"unet {side} s2d={use_s2d} train={train}: {err:.2e} of max |logit|")
    assert err <= REL, err


def test_unet_weights_round_trip_bit_for_bit(weights):
    params, stats = weights
    sd = flax_to_unet_state_dict(params, stats, prefix="unet.")
    model = UNet(in_channels=CIN, num_classes=NCLASS)
    model.load_state_dict({k[len("unet."):]: v for k, v in sd.items()})  # strict
    back_p, back_s = unet_state_dict_to_flax(
        {k: v.numpy() for k, v in sd.items()}, prefix="unet.")
    for tree, ref in ((back_p, params), (back_s, stats)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, tree, ref)
    # the factory's UNet has the same keys and the JAX init's zero biases
    built = build_model("unet", NCLASS, input_channels=CIN, device="cpu")
    assert built.state_dict().keys() == model.state_dict().keys()
    assert not built.training and float(built.conv_last.bias.detach().abs().max()) == 0.0
