"""Kernel B2's plain version (the port's ops/tconv_votes.py) against the JAX
package's Pallas kernel, run as the JAX package's own tests run it on the
CPU (interpret mode), and against torch's ConvTranspose2d + argmax.

Bar for votes from another summation order (tests/test_pallas_kernels.py,
the B1 bar): >= 99.5% of votes equal, and every vote equal where the
parity's top-2 logit gap exceeds 1e-3. The parity-major layout helpers are
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_active_semantic_segmentation_torch.ops import tconv_votes as tv
from deep_active_semantic_segmentation_tpu.models.pretrained import _tconv
from deep_active_semantic_segmentation_tpu.ops import tconv_votes as jx_tv
from deep_active_semantic_segmentation_tpu.ops.pallas import (
    tconv_votes_fused as jx_tvf)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

NUM_CLASSES = 19


def _inputs(shape_nhwc, seed, cout=NUM_CLASSES):
    """Features (NHWC numpy) and a torch-layout (Cin, Cout, 3, 3) weight."""
    rng = np.random.RandomState(seed)
    B, h, w, cin = shape_nhwc
    x = rng.randn(B, h, w, cin).astype(np.float32)
    weight = (rng.randn(cin, cout, 3, 3) / np.sqrt(cin)).astype(np.float32)
    return x, weight


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _full_logits(x, weight):
    """(B, Cout, 2h, 2w) f64 logits of the transposed conv."""
    return F.conv_transpose2d(_nchw(x).double(), torch.from_numpy(weight).double(),
                              stride=2, padding=1, output_padding=1)


def _assert_b1_bar(votes, ref, logits):
    """votes, ref: (B, 2h, 2w) class votes; logits: (B, C, 2h, 2w)."""
    votes, ref = np.asarray(votes), np.asarray(ref)
    top2 = torch.topk(logits, 2, dim=1).values.numpy()
    confident = (top2[:, 0] - top2[:, 1]) > 1e-3
    same = votes == ref
    assert same.mean() >= 0.995, same.mean()
    assert same[confident].all()


@pytest.mark.parametrize("shape", [(2, 40, 128, 16), (2, 12, 10, 16),
                                   (2, 33, 130, 16)])
def test_plain_matches_pallas_kernel_at_ragged_shapes(shape):
    """h % 32 != 0 and w not a multiple of 128 among them."""
    x, weight = _inputs(shape, seed=sum(shape))
    ref = np.asarray(jx_tvf.tconv2x_argmax_parity_major(
        jnp.asarray(x), jnp.asarray(_tconv(weight))))
    got = tv.tconv2x_argmax_parity_major(_nchw(x), torch.from_numpy(weight))
    assert got.dtype == torch.int32 and got.shape == (shape[0], 4) + shape[1:3]
    _assert_b1_bar(tv.interleave_parity_major(got).numpy(),
                   np.asarray(jx_tv.interleave_parity_major(jnp.asarray(ref))),
                   _full_logits(x, weight))


@pytest.mark.parametrize("shape,cout", [((2, 16, 16, 16), 19), ((3, 33, 47, 16), 19),
                                        ((1, 1, 5, 16), 19), ((2, 9, 7, 8), 21)])
def test_plain_matches_conv_transpose_argmax(shape, cout):
    x, weight = _inputs(shape, seed=cout + shape[1], cout=cout)
    got = tv.tconv2x_argmax_parity_major(_nchw(x), torch.from_numpy(weight))
    logits = _full_logits(x, weight)
    _assert_b1_bar(tv.interleave_parity_major(got).numpy(),
                   logits.argmax(dim=1).numpy(), logits)


def test_parity_major_layout_matches_jax():
    maps = np.random.RandomState(4).rand(3, 4, 5, 7).astype(np.float32)
    np.testing.assert_array_equal(
        tv.interleave_parity_major(torch.from_numpy(maps)).numpy(),
        np.asarray(jx_tv.interleave_parity_major(jnp.asarray(maps))))
    for low, full in (((16, 16), (32, 32)), ((16, 17), (32, 32)),
                      ((256, 256), (512, 512)), ((3, 5), (6, 11))):
        assert tv.supports(low, full) == jx_tv.supports(low, full)


def test_bf16_disagreement_with_unfused_module_bounded():
    """bf16 votes round each f32 logit to bf16 before the argmax; the
    unfused bf16 ConvTranspose2d sums in bf16 on the CPU, so votes may part
    only at near-ties (the JAX package's bar, tests/test_scoring_ops.py)."""
    x, weight = _inputs((2, 16, 16, 16), seed=11)
    xb, wb = _nchw(x).bfloat16(), torch.from_numpy(weight).bfloat16()
    fused = tv.interleave_parity_major(tv.tconv2x_argmax_parity_major(xb, wb))
    unfused = F.conv_transpose2d(xb, wb, stride=2, padding=1,
                                 output_padding=1).float().argmax(dim=1)
    rate = (fused != unfused).float().mean().item()
    assert rate < 0.02, rate


def test_wrapper_takes_plain_on_cpu_and_checks_its_inputs():
    x, weight = _inputs((2, 6, 9, 16), seed=3)
    xt, wt = _nchw(x), torch.from_numpy(weight)
    before = tv.tconv2x_argmax_parity_major.launches
    assert torch.equal(tv.tconv2x_argmax_parity_major(xt, wt),
                       tv.tconv2x_argmax_parity_major_plain(xt, wt))
    assert tv.tconv2x_argmax_parity_major.launches == before  # CPU: no launch
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tv.tconv2x_argmax_parity_major(xt.double(), wt)
    with pytest.raises(ValueError, match="ConvTranspose2d weight"):
        tv.tconv2x_argmax_parity_major(xt, wt[:8])
    with pytest.raises(ValueError, match="ConvTranspose2d weight"):
        tv.tconv2x_argmax_parity_major(xt, wt[..., :2])
