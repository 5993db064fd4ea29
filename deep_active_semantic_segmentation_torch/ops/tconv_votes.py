"""Fused 2x transposed-conv classifier + per-parity class argmax (kernel
B2), and the parity-major layout helpers.

Port of the JAX package's Pallas kernel
``ops/pallas/tconv_votes_fused.py::tconv2x_argmax_parity_major`` (with
``ops/tconv_votes.py::interleave_parity_major`` and ``supports``) to a
CUDA C++ kernel for Hopper (``csrc/tconv_votes.cu``, which carries the
note on what bounds it). ENet's last layer is a bias-free
``ConvTranspose2d(Cin, C, 3, stride 2, padding 1, output_padding 1)``; in
MC scoring its logits feed only an argmax vote, so the kernel takes the
stage-5 features and returns the votes: the (B, C, 2h, 2w) logits never
exist.

With k=3, s=2, p=1, op=1 each output parity reads a fixed set of taps.
In the torch weight layout W (Cin, C, 3, 3), with x (B, Cin, h, w):

  out[2i,   2j]   = x[i,j]·W[1,1]
  out[2i,   2j+1] = x[i,j]·W[1,2] + x[i,j+1]·W[1,0]
  out[2i+1, 2j]   = x[i,j]·W[2,1] + x[i+1,j]·W[0,1]
  out[2i+1, 2j+1] = x[i,j]·W[2,2] + x[i,j+1]·W[2,0]
                  + x[i+1,j]·W[0,2] + x[i+1,j+1]·W[0,0]

(from out[y] = sum over y = 2i - 1 + k of x[i] W[k]); taps past the
bottom or right edge read zero. The JAX table is the same one written for
its flipped HWIO kernel, K[a, b] = W[:, :, 2-a, 2-b].

Votes come out PARITY-MAJOR, (B, 4, h, w) int32 with axis 1 = parity 00,
01, 10, 11, as in the JAX package: MC scoring keeps that layout through
the vote stack and the entropy and interleaves once at the end.

``tconv2x_argmax_parity_major`` launches the kernel for a CUDA tensor and
computes ``tconv2x_argmax_parity_major_plain`` for a CPU tensor. The plain
version sums in f32 on the plain pipes; the kernel sums three TF32 passes
on the tensor cores in its own order, so the two are not bit-equal: the
kernel meets the plain version under the vote bar (``confident_votes``).
There is no fallback: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_ENTRY = {torch.float32: "tconv2x_argmax_parity_major_f32",
          torch.bfloat16: "tconv2x_argmax_parity_major_bf16"}

# Largest channel counts the kernel holds: the 4 parities' Cout
# accumulators live in registers, the weight's taps in shared memory.
MAX_CIN = 32
MAX_COUT = 32

# TAPS[p]: (di, dj, ky, kx) per tap of output parity p, in the plain
# version's summation order (input offsets 00, 01, 10, 11, as in the JAX
# package's tap table); W index [.., .., ky, kx]. The kernel sums the same
# taps on the tensor cores in its own order.
TAPS = (
    ((0, 0, 1, 1),),
    ((0, 0, 1, 2), (0, 1, 1, 0)),
    ((0, 0, 2, 1), (1, 0, 0, 1)),
    ((0, 0, 2, 2), (0, 1, 2, 0), (1, 0, 0, 2), (1, 1, 0, 0)),
)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, csrc=None):
    """The C entry point for ``dtype``, typed: every pointer and the stream
    a c_void_p, so ctypes never cuts them to 32 bits. ``csrc``: another
    checkout's sources to build it from (default: this package's)."""
    from deep_active_semantic_segmentation_torch import cuda_build

    lib = cuda_build.load("tconv_votes", csrc or cuda_build.CSRC_DIR)
    fn = getattr(lib, _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def supports(shape_low, shape_full) -> bool:
    """True when the full-res geometry is the exact 2x of the low-res one."""
    return (shape_full[0] == 2 * shape_low[0]
            and shape_full[1] == 2 * shape_low[1])


def interleave_parity_major(packed: torch.Tensor) -> torch.Tensor:
    """(B, 4, h, w) parity-major maps (axis 1 = parity 00, 01, 10, 11) ->
    (B, 2h, 2w) full resolution."""
    B, _, h, w = packed.shape
    p = packed.reshape(B, 2, 2, h, w)
    return p.permute(0, 3, 1, 4, 2).reshape(B, 2 * h, 2 * w)


def tconv2x_argmax_parity_major_plain(features: torch.Tensor,
                                      weight: torch.Tensor) -> torch.Tensor:
    """The reference the kernel meets under the vote bar
    (``confident_votes``), in tensor ops: per parity, the logits summed tap
    by tap and, within a tap, input channel by input channel, each product
    and sum rounded once in f32; then rounded to the input dtype (round to
    nearest even; a no-op for f32) and the first maximum over classes
    taken."""
    B, Cin, h, w = features.shape
    x = features.to(torch.float32)
    wt = weight.to(torch.float32)
    shifted = {(0, 0): x,
               (0, 1): torch.nn.functional.pad(x[..., 1:], (0, 1)),
               (1, 0): torch.nn.functional.pad(x[:, :, 1:], (0, 0, 0, 1))}
    shifted[(1, 1)] = torch.nn.functional.pad(shifted[(1, 0)][..., 1:], (0, 1))
    votes = []
    for taps in TAPS:
        acc = None
        for di, dj, ky, kx in taps:
            xs = shifted[(di, dj)]
            for ci in range(Cin):
                term = xs[:, ci:ci + 1] * wt[ci, :, ky, kx][None, :, None, None]
                acc = term if acc is None else acc + term
        votes.append(acc.to(features.dtype).to(torch.float32).argmax(dim=1))
    return torch.stack(votes, dim=1).to(torch.int32)


def confident_votes(logits: torch.Tensor, dtype: str) -> torch.Tensor:
    """The vote bar's decided votes: where the top-2 gap of the (B, C, 2h,
    2w) f64 logits exceeds 1e-3, plus, for ``dtype`` "bfloat16", one bf16
    ulp of the top logit (both sides round the logits to bf16 before the
    argmax). The kernel's votes equal the plain version's at every decided
    vote and at >= 99.5% of all."""
    top2 = logits.topk(2, dim=1).values
    margin = 1e-3
    if dtype == "bfloat16":
        margin = margin + (top2[:, 0].abs().log2().floor() - 7).exp2()
    return (top2[:, 0] - top2[:, 1]) > margin


def tconv2x_argmax_parity_major(features: torch.Tensor,
                                weight: torch.Tensor) -> torch.Tensor:
    """(B, Cin, h, w) f32/bf16 features + the (Cin, C, 3, 3) weight of a
    bias-free ConvTranspose2d(3, s2, p1, op1) -> (B, 4, h, w) int32 votes,
    parity-major.

    CUDA tensors go through the hand-written kernel, CPU tensors through
    ``tconv2x_argmax_parity_major_plain``; anything else raises."""
    if features.dim() != 4:
        raise ValueError(f"expected (B, Cin, h, w) features, got {tuple(features.shape)}")
    B, Cin, h, w = features.shape
    if weight.shape[0] != Cin or tuple(weight.shape[2:]) != (3, 3) or weight.dim() != 4:
        raise ValueError(f"weight {tuple(weight.shape)} is not a (Cin={Cin}, C, 3, 3) "
                         "ConvTranspose2d weight")
    if features.dtype not in _ENTRY:
        raise TypeError("tconv2x_argmax_parity_major takes float32 or bfloat16, "
                        f"got {features.dtype}")
    if features.device.type == "cpu":
        return tconv2x_argmax_parity_major_plain(features, weight)
    if features.device.type != "cuda":
        raise ValueError(f"tconv2x_argmax_parity_major runs on cuda or cpu, not {features.device}")
    if weight.device != features.device:
        raise ValueError(f"weight on {weight.device}, features on {features.device}")
    if not features.is_contiguous():
        raise ValueError("tconv2x_argmax_parity_major needs contiguous NCHW features")
    Cout = weight.shape[1]
    if min(B, Cin, h, w, Cout) < 1:
        raise ValueError(f"empty input: features {tuple(features.shape)}, "
                         f"weight {tuple(weight.shape)}")
    if Cin > MAX_CIN or Cout > MAX_COUT:
        raise ValueError(f"the kernel holds Cin <= {MAX_CIN} and C <= {MAX_COUT}, "
                         f"got Cin={Cin}, C={Cout}")

    fn = _entry(features.dtype)
    wt = weight.to(torch.float32).contiguous()   # exact for a bf16 weight
    out = torch.empty((B, 4, h, w), dtype=torch.int32, device=features.device)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(features.data_ptr(), wt.data_ptr(), out.data_ptr(),
                 B, Cin, h, w, Cout, stream)
    if err != 0:
        raise RuntimeError(f"tconv2x_argmax_parity_major kernel launch failed: cudaError {err}")
    tconv2x_argmax_parity_major.launches += 1
    return out


# Launches of the CUDA kernel (CPU calls do not count); callers reset it.
tconv2x_argmax_parity_major.launches = 0
