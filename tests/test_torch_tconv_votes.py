"""Kernel B2's plain version (the port's ops/tconv_votes.py) against the JAX
package's Pallas kernel, run as the JAX package's own tests run it on the
CPU (interpret mode), and against torch's ConvTranspose2d + argmax.

Bar for votes from another summation order (tests/test_pallas_kernels.py,
the B1 bar): >= 99.5% of votes equal, and every vote equal where the
parity's top-2 logit gap exceeds 1e-3. The parity-major layout helpers are
exact.

The CUDA kernel (csrc/tconv_votes.cu) runs on the tensor cores in TF32,
which runs only on the card; its precision scheme is emulated here in
numpy, bit for bit in each operand: hi = TF32(v) rounded to nearest with
ties away from zero (cvt.rna), lo = v - hi truncated to TF32 (the tensor
core reads the top 10 mantissa bits), logits = hi.hi + hi.lo + lo.hi. The
products are summed in f64 here (the card sums them in f32, ~1e-6
relative: far inside the 1e-3 bar)."""

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


@pytest.mark.parametrize("dtype,decided", [("float32", [False, True, True]),
                                            ("bfloat16", [False, False, True])])
def test_confident_votes_margin(dtype, decided):
    """The vote bar decides a vote where the top-2 gap exceeds 1e-3, and for
    bf16 also one bf16 ulp of the top logit (2^-5 at 4.0)."""
    gaps = torch.tensor([0.0005, 0.02, 0.05], dtype=torch.float64)
    logits = torch.stack([torch.full_like(gaps, 4.0), 4.0 - gaps,
                          torch.zeros_like(gaps)])[None, :, None, :]  # (1, 3, 1, 3)
    assert tv.confident_votes(logits, dtype)[0, 0].tolist() == decided


# ------------------------------------------- the kernel's TF32 pass split

def _tf32_rna(a):
    """f32 -> TF32 (10 mantissa bits), nearest, ties away from zero."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a):
    """f32 -> TF32 by dropping the low 13 mantissa bits."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    hi = _tf32_rna(a)
    return hi, _tf32_trunc(a - hi)


def _emulated_votes(x, weight, passes, dtype=torch.float32):
    """Parity-major (B, 4, h, w) votes of the tensor-core scheme: x (B, Cin,
    h, w) and weight (Cin, C, 3, 3) f32 numpy; passes 3 (hi.hi + hi.lo +
    lo.hi) or 1 (hi.hi); logits rounded to ``dtype``, first maximum."""
    B, _, h, w = x.shape
    xp = np.pad(x, ((0, 0), (0, 0), (0, 1), (0, 1)))   # the zero edge
    votes = []
    for taps in tv.TAPS:
        acc = 0.0
        for di, dj, ky, kx in taps:
            xh, xl = _split(xp[:, :, di:di + h, dj:dj + w])
            wh, wl = _split(weight[:, :, ky, kx])
            terms = [(xh, wh)] if passes == 1 else [(xl, wh), (xh, wl), (xh, wh)]
            for a, b in terms:
                acc = acc + np.einsum("bchw,cd->bdhw", a.astype(np.float64),
                                      b.astype(np.float64))
        logits = torch.from_numpy(acc.astype(np.float32)).to(dtype).float()
        votes.append(logits.argmax(dim=1))
    return torch.stack(votes, dim=1).to(torch.int32)


def test_tensor_core_scheme_meets_the_bar_against_pallas_kernel():
    """Three TF32 passes, at a small ENet-like shape, against the Pallas
    kernel (interpret mode) and the f64 transposed conv."""
    x, weight = _inputs((2, 32, 40, 16), seed=5)
    xt = _nchw(x).numpy()
    got = tv.interleave_parity_major(_emulated_votes(xt, weight, 3)).numpy()
    ref = np.asarray(jx_tv.interleave_parity_major(jnp.asarray(
        jx_tvf.tconv2x_argmax_parity_major(jnp.asarray(x), jnp.asarray(_tconv(weight))))))
    logits = _full_logits(x, weight)
    _assert_b1_bar(got, ref, logits)
    _assert_b1_bar(got, logits.argmax(dim=1).numpy(), logits)


def test_tensor_core_scheme_bf16_meets_the_bar_against_plain():
    """bf16 features are exact in TF32 (lo = 0: two passes); the logits are
    rounded to bf16 on both sides before the argmax."""
    x, weight = _inputs((2, 32, 40, 16), seed=6)
    xb = _nchw(x).bfloat16()
    wb = torch.from_numpy(weight).bfloat16()
    xe, we = xb.float().numpy(), wb.float().numpy()
    assert not _split(xe)[1].any()                       # lo = 0
    got = tv.interleave_parity_major(_emulated_votes(xe, we, 3, torch.bfloat16))
    plain = tv.interleave_parity_major(tv.tconv2x_argmax_parity_major_plain(xb, wb))
    logits = F.conv_transpose2d(xb.double(), wb.double(), stride=2, padding=1,
                                output_padding=1)
    same = (got == plain).numpy()
    assert same.mean() >= 0.995, same.mean()
    assert same[tv.confident_votes(logits, "bfloat16").numpy()].all()


@pytest.mark.parametrize("passes,meets", [(3, True), (1, False)])
def test_one_tf32_pass_misses_the_bar_at_chip_scale(passes, meets):
    """At chip_smoke.py's input scale (x ~ N(0, 1), w ~ N(0, 1) / 4, Cin 16,
    19 classes) one TF32 pass leaves ~1e-3 rms logit error and flips votes
    whose f64 top-2 gap exceeds 1e-3 (7 of them here, gaps up to 1.45e-3);
    three passes flip none."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16, 128, 128).astype(np.float32)        # 262k votes
    weight = (rng.randn(16, NUM_CLASSES, 3, 3) / 4).astype(np.float32)
    logits = F.conv_transpose2d(torch.from_numpy(x).double(),
                                torch.from_numpy(weight).double(),
                                stride=2, padding=1, output_padding=1)
    got = tv.interleave_parity_major(_emulated_votes(x, weight, passes)).numpy()
    same = got == logits.argmax(dim=1).numpy()
    assert same.mean() >= 0.995, same.mean()            # both pass the share...
    assert bool(same[tv.confident_votes(logits, "float32").numpy()].all()) == meets  # ...one misses
