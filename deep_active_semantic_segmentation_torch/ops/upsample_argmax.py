"""Fused 4x align-corners bilinear upsample + class argmax (kernel B1).

Port of the JAX package's Pallas kernel
``ops/pallas/upsample_argmax.py::upsample4_argmax`` to a CUDA C++ kernel
for Hopper (``csrc/upsample_argmax.cu``, which carries the note on what
bounds it). DeepLab's final upsample is exactly 4x for every FixScaleCrop
geometry (129 -> 513), so the MC-dropout scoring loop feeds the
decoder-resolution logits straight in and gets int32 class votes back: the
(B, C, 513, 513) full-resolution logits never exist.

``upsample4_argmax`` launches the kernel for a CUDA tensor and computes
``upsample4_argmax_plain``, the same arithmetic in tensor ops, for a CPU
tensor. There is no fallback: a CUDA tensor the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_ENTRY = {torch.float32: "upsample4_argmax_f32",
          torch.bfloat16: "upsample4_argmax_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, csrc=None):
    """The C entry point for ``dtype``, typed: every pointer and the stream
    a c_void_p, so ctypes never cuts them to 32 bits. ``csrc``: another
    checkout's sources to build it from (default: this package's)."""
    from deep_active_semantic_segmentation_torch import cuda_build

    lib = cuda_build.load("upsample_argmax", csrc or cuda_build.CSRC_DIR)
    fn = getattr(lib, _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def supports(shape_low, shape_full) -> bool:
    """True when the full-res geometry is the exact 4x of the low-res one."""
    return (shape_full[0] == 4 * (shape_low[0] - 1) + 1
            and shape_full[1] == 4 * (shape_low[1] - 1) + 1)


def _lerp_weights(n_out: int, n_in: int, device):
    """Source indices and weights of the exact-4x align-corners lerp:
    output o reads sources o//4 and min(o//4+1, n_in-1) with weights
    1-f/4 and f/4, f = o%4 (exact in f32)."""
    o = torch.arange(n_out, device=device)
    lo = o // 4
    hi = torch.clamp(lo + 1, max=n_in - 1)
    w1 = (o % 4).to(torch.float32) * 0.25
    return lo, hi, 1.0 - w1, w1


def upsample4_argmax_plain(logits_low: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain tensor ops: rows lerped first, then
    columns, each product and sum rounded once in f32, then a running
    strict-'>' max over classes (the first maximum wins)."""
    B, C, h, w = logits_low.shape
    H, W = 4 * (h - 1) + 1, 4 * (w - 1) + 1
    x = logits_low.to(torch.float32)
    rlo, rhi, rw0, rw1 = _lerp_weights(H, h, x.device)
    clo, chi, cw0, cw1 = _lerp_weights(W, w, x.device)
    rw0, rw1 = rw0[:, None], rw1[:, None]
    best = arg = None
    for c in range(C):
        xc = x[:, c]
        rows = xc[:, rlo, :] * rw0 + xc[:, rhi, :] * rw1          # (B, H, w)
        v = rows[:, :, clo] * cw0 + rows[:, :, chi] * cw1          # (B, H, W)
        if c == 0:
            best = v
            arg = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
        else:
            better = v > best
            best = torch.where(better, v, best)
            arg = torch.where(better, torch.full_like(arg, c), arg)
    return arg


def upsample4_argmax(logits_low: torch.Tensor, out_size=None) -> torch.Tensor:
    """(B, C, h, w) f32/bf16 logits -> (B, 4(h-1)+1, 4(w-1)+1) int32 votes.

    ``out_size`` (H, W), when given, must be the exact 4x geometry
    (``supports``). CUDA tensors go through the hand-written kernel, CPU
    tensors through ``upsample4_argmax_plain``; anything else raises.
    """
    if logits_low.dim() != 4:
        raise ValueError(f"expected (B, C, h, w) logits, got {tuple(logits_low.shape)}")
    B, C, h, w = logits_low.shape
    if out_size is not None and not supports((h, w), out_size):
        raise ValueError(f"({h}, {w}) -> {tuple(out_size)} is not an exact "
                         "4x align-corners upsample")
    if logits_low.dtype not in _ENTRY:
        raise TypeError(f"upsample4_argmax takes float32 or bfloat16, got {logits_low.dtype}")
    if logits_low.device.type == "cpu":
        return upsample4_argmax_plain(logits_low)
    if logits_low.device.type != "cuda":
        raise ValueError(f"upsample4_argmax runs on cuda or cpu, not {logits_low.device}")
    if not logits_low.is_contiguous():
        raise ValueError("upsample4_argmax needs contiguous NCHW logits")
    if min(B, C, h, w) < 1:
        raise ValueError(f"empty logits {tuple(logits_low.shape)}")

    fn = _entry(logits_low.dtype)
    out = torch.empty((B, 4 * (h - 1) + 1, 4 * (w - 1) + 1), dtype=torch.int32,
                      device=logits_low.device)
    with torch.cuda.device(logits_low.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(logits_low.data_ptr(), out.data_ptr(), B, C, h, w, stream)
    if err != 0:
        raise RuntimeError(f"upsample4_argmax kernel launch failed: cudaError {err}")
    upsample4_argmax.launches += 1
    return out


# Launches of the CUDA kernel (CPU calls do not count); callers reset it.
upsample4_argmax.launches = 0
