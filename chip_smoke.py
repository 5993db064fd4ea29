#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--seed N] [--out results.json] [--old-tree DIR]

1. Requires CUDA (exits non-zero without it) and prints the card's name
   and power limit as nvidia-smi reports them.
2. Builds every hand-written kernel from the sources in the checkout
   (one nvcc per source, all started together) and prints the seconds,
   ptxas's registers and spills, and the tensor-core instructions in each
   library's SASS (B2 must hold HGMMA).
3. Kernel phase: each kernel (B1 upsample4_argmax, B2
   tconv2x_argmax_parity_major) against its plain PyTorch version on the
   card at its main path's shapes plus ragged and tile-edge ones, with the
   stated bar (B1 bit-exact; B2 the vote bar), and timed with CUDA events
   beside its bound and the PyTorch library call that computes the same
   function: warm (back-to-back on one input, which stays in L2) and cold
   (L2 flushed before each launch). With --old-tree DIR, the kernels of
   that checkout (the design these replace) are built and timed in turns
   with these.
4. Main-path phases, over one synthetic Cityscapes-sized DirectoryStore
   of 20 records written once: one MC-dropout vote-entropy selection
   query at full width through the selector a user calls, for
   - DeepLab-v3+/MobileNetV2 (the canonical experiment: os16, 19 classes,
     crop 513, batch 5, 20 MC steps; votes through B1), and
   - ENet (the JAX package's factory config: 19 classes, crop 512,
     batch 8, 20 MC steps; votes through B2).
   Every launch count is set to 0 just before each query and read just
   after it. Then one batch is re-scored with the fused kernel off under
   the same dropout masks and the entropy maps are compared, and the
   layers are timed apart: the host geometry of one batch, the
   device-resident MC sweep of one batch, and a torch.profiler breakdown
   of that sweep by device kernel.
5. Prints one {"kernels": [...]} line, then, as the last line,
   {"ok": true, "device": {...}}. Any failed check raises: exit code 1.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, dense TF32 FLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_TC_FLOPS = 495e12

# written between two cold launches: more than the 50 MB L2, and long
# enough on the card (~80 us) that the host enqueues the next launch
# before the card reaches it
FLUSH_BYTES = 256 << 20

NUM_CLASSES = 19
POOL = 20

# main paths: (crop, batch, kernel the fused MC sweep votes through,
# build_model arguments)
PATHS = {
    "deeplab": dict(crop=513, batch=5, kernel="upsample4_argmax",
                    build=dict(backbone="mobilenet", output_stride=16,
                               mc_dropout=True)),
    "enet": dict(crop=512, batch=8, kernel="tconv2x_argmax_parity_major",
                 build={}),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after warm-up). Where ``fn`` enqueues faster than the
    card runs it, host time between calls is counted too."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def hold_card(ms: float) -> None:
    """Keep the card busy for about ``ms`` (a spin kernel), so that the host
    can enqueue a run of calls before the card reaches the first one."""
    import torch

    if not hasattr(hold_card, "cycles_per_ms"):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        b.synchronize()
        hold_card.cycles_per_ms = 10_000_000 / a.elapsed_time(b)
    torch.cuda._sleep(int(ms * hold_card.cycles_per_ms))


def warm_ms(fn, iters: int = 200) -> float:
    """Mean device milliseconds of one call of ``fn`` over ``iters``
    back-to-back calls on the same inputs, which stay in L2 (as in the MC
    sweep, where the layer before has just written them). The card is held
    while the calls are enqueued, so the wrapper's host time is not
    counted."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_card(min(2 * iters * host_ms + 5, 500))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int = 50) -> float:
    """Median device milliseconds of one call of ``fn`` with L2 flushed
    before each: FLUSH_BYTES written between calls, one pair of events
    around each call."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    hold_card(5)
    for k, (a, b) in enumerate(pairs):
        flush.fill_(float(k))
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    del flush
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke check failed: {what}")


def kernel_wrappers():
    """Kernel name -> its wrapper, whose ``launches`` counts real launches."""
    from deep_active_semantic_segmentation_torch.ops import tconv_votes as tv
    from deep_active_semantic_segmentation_torch.ops import upsample_argmax as ua

    return {"upsample4_argmax": ua.upsample4_argmax,
            "tconv2x_argmax_parity_major": tv.tconv2x_argmax_parity_major}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def bound(bytes_moved: float, flops: float, flops_per_s: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of the unit that does them."""
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / flops_per_s * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations")


# ---------------------------------------------------------------- kernels

DESIGNS = {
    "upsample4_argmax":
        "one thread per source cell makes its 4x4 output patch (16 "
        "running maxima in registers); 4x32 source cells per block staged "
        "with a halo in shared memory, 32 classes at a time; output rows "
        "stored through shared memory; bit-exact (no FMA)",
    "tconv2x_argmax_parity_major":
        "per-parity GEMM on the tensor cores, wgmma m64n24k8 TF32 (A "
        "from registers, B from shared memory) in three passes (hi.hi + "
        "hi.lo + lo.hi; two for bf16); persistent one-warpgroup blocks stage "
        "the split weight once and walk 4x16-pixel tiles staged with a halo "
        "in shared memory; argmax by transposed quad shuffles",
}


def sass_tensor_ops(lib: Path):
    """Tensor-core instructions in a built library's SASS (cuobjdump), by
    opcode; None where the toolkit has no cuobjdump."""
    from deep_active_semantic_segmentation_torch import cuda_build

    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ops = {}
    for word in sass.split():
        if word.startswith(("HMMA", "HGMMA")):
            ops[word.rstrip(";")] = ops.get(word.rstrip(";"), 0) + 1
    return ops


def old_kernels(tree: Path):
    """The kernels of another checkout of the repo (the design this one
    replaces), built from its sources as the package builds its own:
    kernel name -> {dtype: C entry point}. The C signatures are this
    checkout's (the wrappers' ``_entry``)."""
    import torch

    from deep_active_semantic_segmentation_torch import cuda_build
    from deep_active_semantic_segmentation_torch.ops import tconv_votes as tv
    from deep_active_semantic_segmentation_torch.ops import upsample_argmax as ua

    csrc = tree / "deep_active_semantic_segmentation_torch" / "csrc"
    cuda_build.build(csrc=csrc)
    return {kernel: {dtype: op._entry(dtype, csrc)
                     for dtype in (torch.float32, torch.bfloat16)}
            for kernel, op in (("upsample4_argmax", ua),
                               ("tconv2x_argmax_parity_major", tv))}


def compare_designs(new_fn, old_fn):
    """Warm and cold ms of the new design and, where ``old_fn`` is given,
    of the old one, in turns (old, new, new, old) on the same inputs."""
    if old_fn is None:
        return {"warm_ms": warm_ms(new_fn), "cold_ms": cold_ms(new_fn)}
    runs = {"new": [], "old": []}
    for which in ("old", "new", "new", "old"):
        fn = new_fn if which == "new" else old_fn
        runs[which].append((warm_ms(fn), cold_ms(fn)))
    result = {"warm_ms": float(np.mean([r[0] for r in runs["new"]])),
              "cold_ms": float(np.mean([r[1] for r in runs["new"]])),
              "turns_warm_cold_ms": runs["new"]}
    result["old_design"] = {
        "warm_ms": float(np.mean([r[0] for r in runs["old"]])),
        "cold_ms": float(np.mean([r[1] for r in runs["old"]])),
        "turns_warm_cold_ms": runs["old"]}
    return result


def timing_fields(name, times, bound_ms):
    """The row's time fields: ms is the warm time; bound_share is the bound
    over the cold time (a warm share can exceed 1 only through L2)."""
    row = {"ms": times["warm_ms"], "kernel_ms": times["warm_ms"], **times,
           "bound_share": bound_ms / times["cold_ms"],
           "warm_bound_share": bound_ms / times["warm_ms"],
           "design": DESIGNS[name]}
    print(f"{name} timing: warm {times['warm_ms']:.5f} ms, cold "
          f"{times['cold_ms']:.5f} ms, bound {bound_ms:.5f} ms, share of "
          f"bound (cold) {row['bound_share']:.3f}"
          + (f"; old design warm {times['old_design']['warm_ms']:.5f} ms, cold "
             f"{times['old_design']['cold_ms']:.5f} ms" if "old_design" in times else ""),
          flush=True)
    return row


def upsample_kernel_phase(torch, gen, old=None):
    """B1 against its plain version: the votes equal bit for bit (both round
    each product and sum once, in the same order). Also printed: the share
    of equal votes, whether every vote agrees where the interpolated top-2
    gap exceeds 1e-3 (tests/test_pallas_kernels.py bar), and max_abs_err:
    the largest drop in the interpolated max logit from taking the
    kernel's vote instead of the plain one (0 where they agree). Shapes:
    the main path's, and tile edges (h, w off the 4x32 tile; h = w = 2; a
    67-wide row, 268 B, not 16-byte aligned), in both dtypes."""
    import torch.nn.functional as F

    from deep_active_semantic_segmentation_torch.ops import upsample_argmax as ua

    checks = []
    for shape, dtype in (((5, 19, 129, 129), torch.float32),
                         ((5, 19, 129, 129), torch.bfloat16),
                         ((3, 21, 17, 33), torch.float32),
                         ((1, 19, 129, 129), torch.float32),
                         ((2, 19, 2, 2), torch.float32),
                         ((2, 19, 2, 2), torch.bfloat16),
                         ((1, 19, 130, 67), torch.float32),
                         ((1, 19, 130, 67), torch.bfloat16)):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        votes = ua.upsample4_argmax(x)
        plain = ua.upsample4_argmax_plain(x)
        torch.cuda.synchronize()
        H, W = votes.shape[1:]
        full = F.interpolate(x.float(), size=(H, W), mode="bilinear",
                             align_corners=True)
        top2 = full.topk(2, dim=1).values
        confident = (top2[:, 0] - top2[:, 1]) > 1e-3
        same = votes == plain
        err = (full.gather(1, plain.long()[:, None])
               - full.gather(1, votes.long()[:, None])).abs().max().item()
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
               "agreement": same.float().mean().item(),
               "bit_exact": bool(torch.equal(votes, plain)),
               "confident_exact": bool(same[confident].all().item()),
               "max_abs_err": err}
        checks.append(row)
        print("upsample4_argmax check", json.dumps(row), flush=True)
        check(row["bit_exact"], f"upsample4_argmax equals plain at {shape} {dtype}")

    # timing at the main path's shape and dtype (f32: MC dtype 'auto')
    B, C, h, w = PATHS["deeplab"]["batch"], NUM_CLASSES, 129, 129
    H, W = 4 * (h - 1) + 1, 4 * (w - 1) + 1
    x = torch.randn((B, C, h, w), device="cuda", generator=gen)
    old_fn = None
    if old is not None:
        fn, out = old["upsample4_argmax"][torch.float32], torch.empty(
            (B, H, W), dtype=torch.int32, device="cuda")
        old_fn = lambda: fn(x.data_ptr(), out.data_ptr(), B, C, h, w,  # noqa: E731
                            torch.cuda.current_stream().cuda_stream)
    times = compare_designs(lambda: ua.upsample4_argmax(x), old_fn)
    plain_ms = warm_ms(lambda: ua.upsample4_argmax_plain(x), 10)
    library_ms = warm_ms(lambda: F.interpolate(
        x, size=(H, W), mode="bilinear", align_corners=True).argmax(1), 50)
    bytes_moved = x.numel() * 4 + B * H * W * 4
    flops = B * H * W * C * 9  # three lerps of 2 mul + 1 add per class
    bound_ms, bound_by = bound(bytes_moved, flops, F32_FLOPS)
    return {
        "name": "upsample4_argmax", "route": "cuda",
        "source": "deep_active_semantic_segmentation_torch/csrc/upsample_argmax.cu",
        "replaces": "deep_active_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:73",
        "launches": None,  # filled from the main-path run
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        **timing_fields("upsample4_argmax", times, bound_ms),
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "timed_shape": [B, C, h, w], "timed_dtype": "float32",
        "checks": checks,
    }


def tconv_kernel_phase(torch, gen, old=None):
    """B2 against its plain version, the bar: >= 99.5% of votes equal and
    every vote equal where it is decided (ops/tconv_votes.py's
    confident_votes). The kernel sums
    in another order, three TF32 passes on the tensor cores, so bit
    equality is printed, not required. max_abs_err: the largest drop in
    the f64 logit from taking the kernel's vote instead of the plain one
    (0 where they agree). Shapes: the main path's, ragged ones and tile
    edges (h, w off the 4x16 tile; one pixel; a 129-wide row, 516 B, not
    16-byte aligned), in both dtypes."""
    import torch.nn.functional as F

    from deep_active_semantic_segmentation_torch.ops import tconv_votes as tv

    def tconv(x, weight):
        return F.conv_transpose2d(x, weight, stride=2, padding=1,
                                  output_padding=1)

    checks = []
    for shape, dtype in (((8, 16, 256, 256), torch.float32),
                         ((8, 16, 256, 256), torch.bfloat16),
                         ((3, 16, 33, 47), torch.float32),
                         ((1, 16, 1, 5), torch.float32),
                         ((2, 16, 65, 129), torch.float32),
                         ((2, 16, 65, 129), torch.bfloat16),
                         ((1, 16, 1, 1), torch.float32),
                         ((1, 16, 1, 1), torch.bfloat16)):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        weight = (torch.randn((shape[1], NUM_CLASSES, 3, 3), device="cuda",
                              generator=gen) / 4.0).to(dtype)
        votes = tv.tconv2x_argmax_parity_major(x, weight)
        plain = tv.tconv2x_argmax_parity_major_plain(x, weight)
        torch.cuda.synchronize()
        full = tconv(x.double(), weight.double())           # (B, C, 2h, 2w)
        name = str(dtype).split(".")[1]
        confident = tv.confident_votes(full, name)
        kv = tv.interleave_parity_major(votes)
        pv = tv.interleave_parity_major(plain)
        same = kv == pv
        err = (full.gather(1, pv.long()[:, None])
               - full.gather(1, kv.long()[:, None])).abs().max().item()
        row = {"shape": list(shape), "dtype": name,
               "agreement": same.float().mean().item(),
               "bit_exact": bool(torch.equal(votes, plain)),
               "confident_exact": bool(same[confident].all().item()),
               "confident_share": confident.float().mean().item(),
               "max_abs_err": err}
        checks.append(row)
        print("tconv2x_argmax_parity_major check", json.dumps(row), flush=True)
        check(row["agreement"] >= 0.995 and row["confident_exact"],
              f"tconv2x_argmax_parity_major vs plain at {shape} {dtype}")
        del full, confident

    # timing at the ENet path's shape and dtype (f32: MC dtype 'auto')
    B, Cin, h, w = PATHS["enet"]["batch"], 16, 256, 256
    C = NUM_CLASSES
    x = torch.randn((B, Cin, h, w), device="cuda", generator=gen)
    weight = torch.randn((Cin, C, 3, 3), device="cuda", generator=gen) / 4.0
    old_fn = None
    if old is not None:
        fn, out = old["tconv2x_argmax_parity_major"][torch.float32], torch.empty(
            (B, 4, h, w), dtype=torch.int32, device="cuda")
        old_fn = lambda: fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(),  # noqa: E731
                            B, Cin, h, w, C, torch.cuda.current_stream().cuda_stream)
    times = compare_designs(lambda: tv.tconv2x_argmax_parity_major(x, weight), old_fn)
    plain_ms = warm_ms(lambda: tv.tconv2x_argmax_parity_major_plain(x, weight), 10)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True     # PyTorch's default
        library_ms = warm_ms(lambda: tconv(x, weight).argmax(1), 50)
        torch.backends.cudnn.allow_tf32 = False
        library_ms_fp32 = warm_ms(lambda: tconv(x, weight).argmax(1), 50)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    bytes_moved = x.numel() * 4 + B * 4 * h * w * 4
    # non-zero taps per input pixel over the four parities: 1 + 2 + 2 + 4
    flops = B * h * w * 9 * Cin * C * 2
    bound_ms, bound_by = bound(bytes_moved, flops, TF32_TC_FLOPS)
    return {
        "name": "tconv2x_argmax_parity_major", "route": "cuda",
        "source": "deep_active_semantic_segmentation_torch/csrc/tconv_votes.cu",
        "replaces": "deep_active_semantic_segmentation_tpu/ops/pallas/tconv_votes_fused.py:125",
        "launches": None,  # filled from the main-path run
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        **timing_fields("tconv2x_argmax_parity_major", times, bound_ms),
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "library": "F.conv_transpose2d(s2, p1, op1).argmax(1), cuDNN TF32 on",
        "library_ms_tf32_off": library_ms_fp32,
        "timed_shape": [B, Cin, h, w], "timed_cout": C, "timed_dtype": "float32",
        "checks": checks,
    }


# --------------------------------------------------------------- main path

def write_store(root: Path, seed: int):
    """POOL Cityscapes-sized (1024x2048) RGB+label records from ``seed``;
    labels are blocky class maps with void (255) bands, as Cityscapes
    labels are."""
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore

    rng = np.random.RandomState(seed)
    store = DirectoryStore(str(root), readonly=False)
    keys = []
    for i in range(POOL):
        img = rng.randint(0, 256, (1024, 2048, 3), dtype=np.uint8)
        lab = np.kron(rng.randint(0, NUM_CLASSES, (16, 32)),
                      np.ones((64, 64), np.int64)).astype(np.uint8)
        lab[:rng.randint(40, 120)] = 255
        key = f"/leftImg8bit/train/city/city_{i:06d}_leftImg8bit.png".encode()
        store.put(key, np.dstack((img, lab)))
        keys.append(key)
    store.finalize(keys)
    return DirectoryStore(str(root)), keys


def main_path_phase(torch, seed: int, arch: str, store, paths):
    """One selection query of ``arch`` (PATHS) through the entry point a
    user calls, with every launch count set to 0 just before it and read
    just after; then the gates and the layer timings."""
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.data.loader import PathsLoader
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.ops.entropy import mean_over_pixels
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)
    from deep_active_semantic_segmentation_torch.selection import kernels
    from deep_active_semantic_segmentation_torch.selection.base import (
        collect_scores, rank_descending)

    cfg = PATHS[arch]
    crop, batch_size, kernel = cfg["crop"], cfg["batch"], cfg["kernel"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = build_model(arch, NUM_CLASSES, device="cuda", generator=gen,
                        **cfg["build"])
    bundle = ModelBundle(model, torch.device("cuda"))
    sel = get_active_selection_class("variance", NUM_CLASSES, store, crop,
                                     batch_size, device="cuda")
    check(sel.mc_dtype() == "float32", "MC dtype 'auto' is float32")

    # warm-up query (cuDNN setup, kernel load) on one batch
    sel.get_vote_entropy_for_images(bundle, paths[:batch_size], 1, seed=1)
    torch.cuda.synchronize()

    n_batches = -(-len(paths) // batch_size)
    reset_counts()
    t0 = time.perf_counter()
    top = sel.get_vote_entropy_for_images(bundle, paths, 5, seed=0)
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    counts = read_counts()
    launches = counts[kernel]
    print(f"{arch} path: {len(paths)} images in {query_s:.3f} s "
          f"({len(paths) / query_s:.2f} images/s, {n_batches} batches of "
          f"{batch_size} at crop {crop}, launches {json.dumps(counts)}) "
          f"on {card_line()}", flush=True)
    check(launches == constants.MC_STEPS * n_batches,
          f"{kernel} launched {launches} times, expected "
          f"{constants.MC_STEPS * n_batches}")
    check(all(n == 0 for name, n in counts.items() if name != kernel),
          f"no other kernel launched on the {arch} path: {counts}")
    check(len(top) == 5 and len(set(top)) == 5, "top-5 has 5 distinct paths")

    # the same query's scores (same seed -> same masks): finite, and
    # they rank as the entry point ranked
    scorer = sel._entropy_scorer(bundle, 0)
    scores = collect_scores(
        sel._paths_loader(paths, include_labels=True,
                          labels_as_mask=NUM_CLASSES),
        lambda b: mean_over_pixels(scorer(b)))
    check(len(scores) == len(paths) and bool(np.isfinite(scores).all()),
          "scores are finite, one per image")
    check(rank_descending(scores, list(paths), 5) == top,
          "re-scored ranking equals the entry point's")

    # fused vs unfused on batch 0 under the same dropout masks
    batch = next(iter(sel._paths_loader(paths[:batch_size], include_labels=True,
                                        labels_as_mask=NUM_CLASSES)))
    maps = {}
    for fused in (True, False):
        maps[fused] = kernels.mc_vote_entropy_maps(
            model, batch["image"], batch["label"],
            kernels.mc_generator(0, 0, "cuda"), NUM_CLASSES,
            constants.MC_STEPS, "dropout", fused_upsample=fused,
            labels_packed=True)
    a, b = maps[False], maps[True]
    check(tuple(b.shape) == (batch_size, crop, crop),
          f"entropy map shape {tuple(b.shape)}")
    check(bool(torch.isfinite(b).all()), "entropy maps finite")
    mean_abs = (a - b).abs().mean().item()
    equal = (a == b).float().mean().item()
    print(f"{arch} fused vs unfused entropy maps: mean |d| {mean_abs:.6f}, "
          f"equal {equal:.6f}", flush=True)
    check(mean_abs < 0.02 and equal >= 0.98, "fused and unfused agree")

    # device-resident MC sweep of one batch (no host work)
    def sweep():
        kernels.mc_vote_entropy_maps(
            model, batch["image"], batch["label"],
            kernels.mc_generator(0, 0, "cuda"), NUM_CLASSES,
            constants.MC_STEPS, "dropout", fused_upsample=True,
            labels_packed=True)
    batch_ms = cuda_ms(sweep, 5, warmup=1)
    print(f"{arch} MC sweep of one batch (device-resident): {batch_ms:.3f} ms "
          f"({batch_size / batch_ms * 1e3:.2f} images/s)", flush=True)

    # host layer alone: store reads + FixScaleCrop + wire packing of
    # one batch on one thread (the query runs 3 such workers)
    loader = PathsLoader(store, paths[:batch_size], crop, batch_size,
                         include_labels=True, labels_as_mask=NUM_CLASSES)
    t0 = time.perf_counter()
    loader.build_batch(paths[:batch_size])
    host_batch_s = time.perf_counter() - t0
    print(f"{arch} host geometry of one batch (one thread): {host_batch_s:.3f} s "
          f"({batch_size / host_batch_s:.2f} images/s)", flush=True)

    return {"arch": arch, "crop": crop, "batch": batch_size,
            "pool": len(paths), "batches": n_batches,
            "launches": launches, "counts": counts,
            "query_s": query_s, "images_per_s": len(paths) / query_s,
            "host_batch_s": host_batch_s,
            "host_images_per_s_one_thread": batch_size / host_batch_s,
            "mc_batch_ms": batch_ms,
            "mc_images_per_s": batch_size / batch_ms * 1e3,
            "fused_vs_unfused": {"mean_abs": mean_abs, "equal": equal},
            "profile": profile_sweep(torch, sweep, arch),
            "top5": [p.decode() for p in top]}


def profile_sweep(torch, sweep, arch: str):
    """Device time by kernel name over one MC sweep (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sweep()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        if dev_us and e.device_type.name == "CUDA":
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    top = [{"kernel": k[:120], "device_ms": us / 1e3, "calls": n}
           for us, k, n in rows[:15]]
    ours = [{"kernel": k[:120], "device_ms": us / 1e3, "calls": n,
             "share": us / 1e3 / device_ms}
            for us, k, n in rows if "_argmax" in k and "_kernel" in k]
    print("%s profile of one MC sweep: wall %.3f ms, device kernels %.3f ms" % (
        arch, wall_ms, device_ms), flush=True)
    for r in top:
        print("  %9.3f ms %5d  %s" % (r["device_ms"], r["calls"], r["kernel"]))
    for r in ours:
        print("  hand-written: %9.3f ms %5d  (%.1f%%)  %s" % (
            r["device_ms"], r["calls"], 100 * r["share"], r["kernel"]))
    return {"wall_ms": wall_ms, "device_kernel_ms": device_ms, "top": top,
            "hand_written": ours}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the full results as JSON here")
    ap.add_argument("--old-tree", type=Path,
                    help="another checkout of the repo (e.g. a git archive of "
                         "the parent commit): its kernels are built too and "
                         "timed in turns with these on the same inputs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device",
          torch.cuda.get_device_name(0), flush=True)

    from deep_active_semantic_segmentation_torch import cuda_build

    t0 = time.perf_counter()
    reports = cuda_build.build()
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s", flush=True)
    for name, text in reports.items():
        print(f"nvcc {name}:\n{text.strip()}", flush=True)
    sass = {name: sass_tensor_ops(cuda_build.library_path(name))
            for name in cuda_build.SOURCES}
    print("tensor-core instructions in the SASS:", json.dumps(sass), flush=True)
    if sass["tconv_votes"] is not None:
        check(any(op.startswith("HGMMA") for op in sass["tconv_votes"]),
              "B2 runs on the tensor cores (HGMMA in its SASS)")

    old = old_kernels(args.old_tree) if args.old_tree else None
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = [upsample_kernel_phase(torch, gen, old), tconv_kernel_phase(torch, gen, old)]

    tmp = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=REPO))
    try:
        t0 = time.perf_counter()
        store, paths = write_store(tmp, args.seed)
        store_s = time.perf_counter() - t0
        paths_result = {arch: main_path_phase(torch, args.seed, arch, store, paths)
                        for arch in PATHS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        row["launches"] = next(r["launches"] for r in paths_result.values()
                               if PATHS[r["arch"]]["kernel"] == row["name"])
        check(row["launches"] > 0, f"{row['name']} ran on its main path")

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "build_s": build_s, "store_write_s": store_s,
             "sass_tensor_ops": sass,
             "kernels": rows, "main_paths": paths_result}, indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: v for k, v in row.items() if k != "checks"}
                                  for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
