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
     crop 513, batch 5, 20 MC steps; votes through B1),
   - ENet (the JAX package's factory config: 19 classes, crop 512,
     batch 8, 20 MC steps; votes through B2), and
   - DeepLab-v3+/ResNet-50 (the CLI's default backbone; as the first,
     its backbone hoisted once per batch; votes through B1).
   Every launch count is set to 0 just before each query and read just
   after it. Then one batch is re-scored with the fused kernel off under
   the same dropout masks and the entropy maps are compared, and the
   layers are timed apart: the host geometry of one batch, the
   device-resident MC sweep of one batch, and a torch.profiler breakdown
   of that sweep by device kernel.
5. Training, over the same store as a dataset (train split, a 5-record
   val split, seed sets): DeepLab train steps at full width (crop 513,
   batch 5, SGD lr 0.01 poly, balanced weights) in bf16 and in f32, timed
   on a device-resident batch, with peak memory, finite and falling
   losses, and a profile of one bf16 step; a Trainer epoch through the
   port's Loader; eval images/s and the eval confusion matrix against a
   host bincount; one step on the card against the same step on the CPU
   in f32 and in f64 (TF32 off, dropout off, BN at running statistics).
6. One AL round of the canonical experiment through run_active_loop
   (variance mode, 20-image pool, 10-image seed set, active batch 5, 1
   epoch, 2 rounds), launch counts set to 0 just before and read just
   after: selections 10 then 15, best.ckpt reloads bit for bit, B1 20
   launches per scoring batch and no B2, finite scores whose top 5 is the
   pick; the round's seconds in train, validate and select.
7. Region selection, each with its launch counts set to 0 just before
   and read just after: two rounds of `variance` on
   active_cityscapes_region (region 129, 80 boxes requested, the whole
   pool scored through B1: 80 launches, no B2), its selections.txt in the
   JAX format, the labeled pixels grown by count * 129², its boxes equal
   to the device and the host NMS on the re-scored normalized maps; one
   region query at pa_experiments_06t-09t.sh's geometry (20 synthetic
   375x500 Pascal records, base 512, crop -1, 21 classes: unfused, no B1
   or B2 launch), device boxes equal to host ones; the square NMS at the
   canonical pool size ((2975, 385, 385) f32, 791 boxes), device boxes
   equal to host ones, its ms and peak memory, and the box sum of one
   batch of 5 maps at 513².
8. Two rounds of `ceal_entropy_weakly_labeled` through run_active_loop:
   no B1 or B2 launch, round 1's train pool labeled + weak, weak targets
   255 exactly where the mask is invalid, the pick equal to the top 5 of
   the re-scored entropies; then the confidence, margin and fusion
   queries on round 0's best.ckpt against a re-score, and the CEAL query
   images/s.
9. The remaining selection modes, each phase with its launch counts set
   to 0 just before and read just after: the MC-noise queries
   (`noise_image`, `noise_feature`, `noise_variance` on DeepLab: B1 80 /
   80 / 160; `noise_feature` on ENet: B2 60), each timed 3 times, its
   picks the same every run and the top 5 of its re-scored scores, batch
   0 re-scored with the kernel's plain version swapped in (B1 bit-equal,
   B2 the vote bar) and one batch's sweep profiled; two rounds of region
   `noise_variance` (B1 160, boxes equal the device and host NMS on a
   re-score); one round each of `coreset` (no launch) and
   `variance_representative` (B1 only in its MC stage), the picks equal
   to a re-run on best.ckpt; k-center greedy ((2975, 2736), 150 picks)
   and max-representative (47,600 x 1,898 x 304, 949 picks) on seeded
   features, timed 3 times with peak memory, picks equal to the CPU's
   (the process's float32 precision state printed first; a k-center
   split dumped to kcenter_mismatch.npz beside the --out file, or in the
   repo's root, with the first pick where the card, the CPU, the CPU
   again and the CPU at full f32 part from an f64 greedy, before the
   near-tie check);
   an `accuracy_labels` query (no launch, counts equal a recount, the
   pick their top 5) and an `accuracy_eval` consumer round replaying the
   AL round's selections.txt.
10. The accuracy predictor (DeepLab + UNet error head) at
   pa_experiments_07t.sh / 17t.sh's geometry over the Pascal phase's 20
   records (the 512 letterbox, 21 classes, batch 5), every phase with
   its launch counts set to 0 just before and read just after (no B1 or
   B2): the dual train step device-resident in bf16 and f32 (ms, peak
   memory, finite falling losses, a profile of one bf16 step), the dual
   eval step's two confusions against host bincounts, a dual epoch
   through the Loader and a validation; one f32 dual step on the card
   against the CPU; one 2-round accuracy_predictor_train_torch.main on
   active_pascal_image and on active_pascal_region (best.ckpt reloads bit
   for bit, the image pick the top 5 of a re-score); then, on that run's
   round 0 best.ckpt, the `accuracy` (softmax, argmax), `uncertain`,
   `gradient` and `uncertain_gradient` image queries and the `accuracy`
   region maps, each timed 3 times, their picks equal a re-score's and
   the CPU's (TF32 off; a near-tie within 1e-5 relative allowed and
   printed), the gradient query's peak memory.
11. Slice 8, train.py's path and the rest of the zoo, every phase with
   its launch counts set to 0 just before and read just after (no B1 or
   B2 launch in any): the native resampler (built with g++ at the start,
   beside the kernels) byte-equal to PIL on the records, the host
   geometry of one batch natively and through PIL, and in turns (PIL,
   native, native, PIL) a passive Loader epoch and the canonical
   dropout query; the train steps of DeepLab-ResNet-50 (crop 513, batch
   4, SGD poly), ENet (crop 512, batch 4, Adam) and FastSCNN (crop 512,
   batch 4) in bf16 and f32 with peak memory and an eval confusion
   against a host bincount, and one f32 step of each against the CPU;
   train_torch.main with train.py's flags (ResNet-50) over 12 + 4
   records, twice and then a resume (experiment_0..2, best_pred.txt,
   the model_best promotion, the resume's epoch, one train grid per
   epoch); the pretrained-backbone transplant of a seeded ResNet-50 and
   MobileNetV2 checkpoint at every initialize(); the ENet-headed
   accuracy predictor's dual step at Pascal's 512 letterbox. The
   ResNet-50 DeepLab variance query (20 images, batch 5) runs with the
   main paths of 4: B1 80 launches.
12. Slice 9, checkpoint replay and the remaining entry points, every
   phase with its launch counts set to 0 just before and read just after
   (no B1 or B2 launch but the profiling phase's 20): visualize_torch.main
   on the AL-round phase's round 0 best.ckpt (its mIoU equal to the run's
   best_pred.txt to 1e-9, one PNG triple per val image);
   eval_series_torch.main over that experiment and, with --dual-head,
   over the accuracy predictor's active_pascal_image run (every row's
   mIoU equal to its best_pred.txt, validation_mIoUs.txt written); each
   checkpoint evaluated once more on the drivers' Trainer, timed (eval
   images/s, s per round) and equal to the drivers' metrics; the SEM
   trainer, unet_train_torch.main at its own width (UNet(1, 2), crop
   512, batch 2, RMSprop) for 5 epochs over synthetic 768x1024 grayscale
   PNGs, its f32 step timed with its peak memory, one step against the
   CPU (gradients within 1e-5 of the largest); the dataset
   converter on synthetic Cityscapes (1024x2048 PNGs, labelIds) and
   Pascal VOC (375x500 JPEGs) folders, records equal to the remapped
   sources, seed sets emitted, the stores read back onto the card,
   records/s; compare_selections of the AL round against the
   accuracy_eval consumer that replays it (every round N/N); a
   torch.profiler trace (utils/profiling.trace) of one canonical dropout
   batch naming B1's kernel 20 times, Throughput against CUDA events.
13. Slice 10, the data-parallel path (parallel/mesh.py, crossreplica.py,
   the sharded scorer): (a) two ranks sharing the card over gloo (NCCL
   refuses two ranks on one device; where the machine shows two cards,
   also one rank per card over NCCL), spawned by parallel.mesh.launch:
   one DeepLab-ResNet-50 step at 513² on 4 rows per rank (f64 and f32,
   TF32 off, BN biases drawn off the ReLU kinks) against the one-process
   step on the same 8 images (PR 8's card-vs-CPU bars; both ranks' tensors,
   BN buffers included, equal), a bf16 step timed per rank and the
   gradient all-reduce timed; the canonical MobileNetV2 dropout query (B1)
   and the ENet query (B2) over the 20 records sharded over the ranks,
   scores and picks equal to the one-process queries and each rank's
   launches summing to the one-process count; one 2-rank `variance` round
   through active_train_torch.main (--num-devices 2, a global batch of 8:
   selections 10 then 15, best.ckpt without 'module.' keys; the ranks
   check their labeled pools against each other).
   (b) The NCCL route at world 1: make_mesh(backend="nccl") and one DDP
   step with cross-replica BN against the plain step (BN frozen: equal
   tensors; train mode: PR 8's bars). The two-ranks-on-one-card times are
   the cost of the collectives through the host, not a scaling result.
14. Slice 11, the multi_rank_drivers phase: the four drivers that run on
   N ranks since the two-headed trainer does, two gloo ranks sharing the
   card (the step, the picks and the f64 SEM run also one rank per card
   over NCCL where the machine shows two cards). One two-headed step (DeepLab-v3+/MobileNetV2 with the UNet error
   head, 513², train-mode cross-replica BN, 2 rows per rank) against one
   process on the same 4 images (f64 within 1e-12 of the largest weight,
   f32 within 5e-4, bf16 loss within 1e-2; ms per rank); the four
   accuracy_predictor_train.py modes' picks from one checkpoint, sharded,
   equal to one process's; one 2-round accuracy_predictor_train_torch.main
   on 2 ranks (selections 10 then 15); visualize_torch.main and
   eval_series_torch.main --dual-head on 2 ranks against one rank (equal
   metrics and validation_mIoUs.txt, byte-equal PNGs); the SEM trainer's
   rank body on 2 ranks in f64 against one process (5 epochs at 512²,
   batch 2, its batch-1 validation; 1e-4 relative) and
   unet_train_torch.main on 2 ranks in f32; whether the lmdb binding
   imports (where it does, a converted LMDB store through the factory).
   No B1 or B2 launch there.
15. Slices 12-13, the spatial phase (parallel/spatial.py, the
   height-sharded step), for every model JAX's spatial step takes, at
   full width: DeepLab-v3+/MobileNetV2 and DeepLab-v3+/ResNet-101 os16,
   ENet and FastSCNN, 19 classes, at Cityscapes' full 1024x2048 frame,
   and the SEM UNet (1 input channel, 2 classes) at 768x1024; BN biases
   drawn off the ReLU kinks. Two gloo ranks sharing the card as a (1x2)
   mesh (also one rank per card over NCCL where two cards are visible;
   one spawn runs every model), each on its half of the rows: the f64
   step on 1 image (state within 1e-10 of the largest weight, BN running
   statistics included; the f32 loss within 1e-6) and the f32 step on 2
   images (TF32 off: loss within 1e-5, weights within 5e-4; 5e-3 for
   ResNet-101, under the JAX package's own spatial-vs-unsharded gap)
   against one process on the whole images; the bf16 step's ms per rank
   and each rank's peak memory against one process's (each below it); each
   model's seconds as ``spatial_<model>`` in the phase seconds.
   dryrun_multichip(2) in JAX's (1x2) layout and on the data-only (2x1)
   mesh on the card, each rank's B1 launches (its pool scoring) read
   from its line; dryrun_multichip(4) over NCCL as (2x2) where four
   cards are visible.
16. Slice 15, the remat phase (``--remat``, parallel/remat.py: one
   checkpoint per block of the model): each model of the spatial phase
   at its full frame in one process on 2 images and the two-headed step
   at Pascal's 512 letterbox (batch 5), dropout on, plain against remat
   from one generator seed: the bf16 step's ms and peak memory each way
   (the remat peak below the plain one; DeepLab-ResNet-101's step
   profiled each way), and one f32 step each way (TF32 off, cuDNN
   deterministic): the loss and BN running statistics within 1e-6 of
   the largest, the parameters within 1e-6 of the largest weight or 10x
   a second plain step's own gap (the backward's atomic adds),
   ``num_batches_tracked`` and the generator states equal; one canonical `variance` round through
   ``active_train_torch.main --remat`` (launch counts set to 0 just
   before and read just after: B1 as often as the AL-round phase's plain
   round, no B2); DeepLab-ResNet-101 plain and remat on a (1x2) mesh of
   two gloo ranks sharing the card (and one rank per card over NCCL
   where two cards are visible): the spatial step in f64 (remat within
   1e-10 of plain) and bf16 (ms and peak per rank, the remat peak below
   the plain one), and the data-parallel f64 step on the (2x1) mesh of
   the same ranks at 512x1024 (within 1e-10). No B1 or B2 launch in its
   steps.
17. Slice 16, the trace phase: tools/trace_step_torch.py's per-op
   profile (torch.profiler through utils/profiling) of each of its modes
   at full width, 2 warm-up and 3 profiled steps each: the DeepLab-v3+/
   MobileNetV2 and two-headed train steps at 513², the ENet and FastSCNN
   steps and ENet's MC-dropout scoring at 512², the 3-channel 19-class
   UNet's step at 512², all batch 8, bf16. Each mode's device and wall
   ms per step and top 5 ops; B2's kernel named 20 times per scoring
   step (its counter agreeing), neither kernel in a train step; each
   device total positive and within the wall time.
18. Prints the phases' seconds, one {"kernels": [...]} line, then, as the
   last line, {"ok": true, "device": {...}}. Any failed check raises:
   exit code 1.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import random
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
    # the CLI's default backbone: its decoder sits at 1/4, so at 513² the
    # votes go through B1, and its backbone (no dropout site) runs once per
    # batch
    "deeplab_resnet50": dict(crop=513, batch=5, kernel="upsample4_argmax",
                             model="deeplab",
                             build=dict(backbone="resnet", output_stride=16,
                                        mc_dropout=True)),
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


@contextlib.contextmanager
def plain_kernels():
    """Both kernels' wrappers replaced by their plain versions for the
    length of a ``with`` block: a re-score "with the fused kernels off",
    the same arithmetic in tensor ops on the same tensors. Launch counts
    are not read inside."""
    from deep_active_semantic_segmentation_torch.ops import tconv_votes as tv
    from deep_active_semantic_segmentation_torch.ops import upsample_argmax as ua

    saved = ua.upsample4_argmax, tv.tconv2x_argmax_parity_major
    ua.upsample4_argmax = lambda x, out_size=None: ua.upsample4_argmax_plain(x)
    tv.tconv2x_argmax_parity_major = tv.tconv2x_argmax_parity_major_plain
    try:
        yield
    finally:
        ua.upsample4_argmax, tv.tconv2x_argmax_parity_major = saved


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

def write_store(root: Path, seed: int, n: int = POOL, split: str = "train",
                hw=(1024, 2048), block: int = 64, num_classes: int = NUM_CLASSES,
                void=(40, 120)):
    """``n`` RGB+label records of size ``hw`` (Cityscapes-sized by default)
    from ``seed``; labels are blocky class maps (``block``-pixel cells)
    with void (255) bands of ``void`` rows, as Cityscapes and Pascal VOC
    labels are."""
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore

    rng = np.random.RandomState(seed)
    store = DirectoryStore(str(root), readonly=False)
    keys = []
    for i in range(n):
        img = rng.randint(0, 256, hw + (3,), dtype=np.uint8)
        lab = np.kron(rng.randint(0, num_classes, (hw[0] // block, hw[1] // block)),
                      np.ones((block, block), np.int64)).astype(np.uint8)
        lab[:rng.randint(*void)] = 255
        key = f"/leftImg8bit/{split}/city/city_{i:06d}_leftImg8bit.png".encode()
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
        rank_descending)

    cfg = PATHS[arch]
    crop, batch_size, kernel = cfg["crop"], cfg["batch"], cfg["kernel"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = build_model(cfg.get("model", arch), NUM_CLASSES, device="cuda",
                        generator=gen, **cfg["build"])
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
    scorer = sel._scorer(bundle, 0)
    scores = sel._collect_scores(paths, lambda b: mean_over_pixels(scorer(b)),
                                 include_labels=True, labels_as_mask=NUM_CLASSES)
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
            "profile": profile_sweep(torch, sweep, f"one {arch} MC sweep"),
            "top5": [p.decode() for p in top]}


def profile_sweep(torch, sweep, label: str):
    """Device time by kernel name over one call of ``sweep`` (torch.profiler)."""
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
    print("profile of %s: wall %.3f ms, device kernels %.3f ms" % (
        label, wall_ms, device_ms), flush=True)
    for r in top:
        print("  %9.3f ms %5d  %s" % (r["device_ms"], r["calls"], r["kernel"]))
    for r in ours:
        print("  hand-written: %9.3f ms %5d  (%.1f%%)  %s" % (
            r["device_ms"], r["calls"], 100 * r["share"], r["kernel"]))
    return {"wall_ms": wall_ms, "device_kernel_ms": device_ms, "top": top,
            "hand_written": ours}


# ------------------------------------------------------- training and round

# the canonical experiment's flags (test_scripts/cs_experiments_*.sh): crop
# 513, batch 5, SGD lr 0.01 poly, balanced weights, bf16 by default; the
# round is cut to 20 pool images, a 10-image seed set, 1 epoch, 2 rounds
ROUND_ARGV = ["--dataset", "active_cityscapes_image", "--backbone", "mobilenet",
              "--crop-size", "513", "--base-size", "513", "--batch-size", "5",
              "--lr", "0.01", "--use-lr-scheduler", "--use-balanced-weights",
              "--eval-interval", "1", "--epochs", "1", "--active-batch-size", "5",
              "--max-iterations", "2", "--no-early-stop",
              "--active-selection-mode", "variance", "--workers", "0"]
SEED_SET = 10
# the card the phases below run on (main() refuses to start without one)
DEVICE = "cuda"
VAL = 5
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
# card vs CPU, one step (TF32 off, dropout off, BN at running stats): the
# loss to this relative gap, the updated parameters to this one (see
# card_vs_cpu_phase)
CPU_LOSS_RTOL = 1e-4
CPU_PARAM_RTOL = 1e-3


def write_dataset(root: Path, seed: int, family: str = "cityscapes", **records):
    """The loop's dataset layout under ``root / family``: the POOL-record
    train split, a VAL-record val split, and seed sets (the first SEED_SET
    train images; all of them); ``records`` are ``write_store``'s record
    options."""
    city = root / family
    store, paths = write_store(city / "train", seed, **records)
    write_store(city / "val", seed + 1, n=VAL, split="val", **records)
    (city / "seed_sets").mkdir()
    for name, keys in (("set_0.txt", paths[:SEED_SET]), ("set_all.txt", paths)):
        (city / "seed_sets" / name).write_text(
            "".join(k.decode() + "\n" for k in keys))
    return store, paths


def freeze_bn(model):
    """Train mode with every BN layer at its running statistics."""
    import torch

    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    return model


def train_phase(torch, seed: int, root: Path):
    """Full-width train steps in bf16 then f32 (TF32 on): device ms per
    step on a device-resident batch, peak memory, every loss finite and
    falling over the steps on that one batch; a Trainer epoch through the
    port's Loader (host geometry included); the host geometry of one
    batch; eval images/s and the eval step's confusion matrix against a
    host bincount of the same predictions; a profile of one bf16 step."""
    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.engine.trainer import Trainer
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import make_schedule
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_eval_step, make_train_step)
    from deep_active_semantic_segmentation_torch.utils.class_weights import (
        calculate_weights_labels)

    cfg = parse_cli(ROUND_ARGV + ["--seed", str(seed), "--seed_set", "set_all.txt",
                                  "--epochs", "200"]).finalize()
    _, train_loader, val_loader, _, nclass = make_dataloader(
        cfg.dataset, cfg.base_size, cfg.crop_size, cfg.batch_size,
        init_set=cfg.seed_set, dataset_root=str(root), seed=seed,
        rng=random.Random(seed), device=DEVICE)
    t0 = time.perf_counter()
    host_batch = next(iter(train_loader))
    host_batch_s = time.perf_counter() - t0
    cw = torch.as_tensor(calculate_weights_labels(train_loader, nclass),
                         dtype=torch.float32, device=DEVICE)
    batch = {k: torch.from_numpy(host_batch[k]).to(DEVICE) for k in ("image", "label")}
    B = cfg.batch_size
    out = {"host_geometry_s_per_batch": host_batch_s, "batch": B,
           "crop": cfg.crop_size}
    print(f"train host geometry of one batch (one thread): {host_batch_s:.3f} s",
          flush=True)

    for dtype in ("bfloat16", "float32"):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        model = build_model("deeplab", nclass, mc_dropout=True, device=DEVICE,
                            generator=gen).train()
        opt = build_optimizer("SGD", param_groups(model, "deeplab"), cfg)
        ipe = len(train_loader)
        step = make_train_step(model, opt, build_loss("ce", class_weights=cw),
                               make_schedule("poly", cfg.lr, cfg.epochs, ipe),
                               compute_dtype=dtype, generator=gen)
        losses = [step(batch, i)["loss"] for i in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
            losses.append(step(batch, i)["loss"])
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / TRAIN_STEPS
        losses = torch.stack(losses).tolist()
        peak = torch.cuda.max_memory_allocated()
        print(f"train step {dtype}: {step_ms:.3f} ms per step of {B} at "
              f"{cfg.crop_size} "
              f"({B / step_ms * 1e3:.2f} images/s on a device-resident batch), "
              f"peak memory {peak / 2**30:.3f} GiB, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
        check(bool(np.isfinite(losses).all()), f"{dtype} train losses finite")
        check(losses[-1] < losses[0], f"{dtype} loss falls over {len(losses)} "
                                      "steps on one batch")
        out[dtype] = {"step_ms": step_ms, "images_per_s": B / step_ms * 1e3,
                      "peak_bytes": peak, "losses": losses}
        if dtype == "bfloat16":
            out["profile_bf16_step"] = profile_sweep(
                torch, lambda: step(batch, 0), "one bf16 train step")

    # eval at crop 513: device-resident batch, confusion vs a host bincount
    eval_step = make_eval_step(model, nclass, build_loss(
        "ce", class_weights=cw, batch_average=False))
    ev = eval_step(batch, B)
    pred, lab = ev["pred"].cpu().numpy(), host_batch["label"].astype(np.int64)
    valid = lab < nclass
    host = np.bincount(nclass * lab[valid] + pred[valid],
                       minlength=nclass * nclass).reshape(nclass, nclass)
    check(np.array_equal(ev["confusion"].cpu().numpy(), host),
          "eval confusion equals a host bincount of the same predictions")
    eval_ms = cuda_ms(lambda: eval_step(batch, B), 20)
    out["eval"] = {"step_ms": eval_ms, "images_per_s": B / eval_ms * 1e3}
    print(f"eval step: {eval_ms:.3f} ms per batch of {B} "
          f"({B / eval_ms * 1e3:.2f} images/s); confusion exact", flush=True)

    # a Trainer epoch over the 20-image pool through the Loader: host
    # geometry (one producer thread) overlapped with the bf16 steps
    trainer = Trainer(cfg, train_loader, val_loader, nclass, device=DEVICE,
                      rng=random.Random(seed))
    trainer.initialize()
    epochs = []
    for epoch in range(2):   # the first one warms the pinned-memory pool
        t0 = time.perf_counter()
        trainer.training(epoch)
        epochs.append(len(train_loader.pool) / (time.perf_counter() - t0))
    out["loader_epoch_images_per_s"] = epochs[-1]
    print(f"train epoch through the Loader: {epochs[-1]:.2f} images/s "
          f"({len(train_loader.pool)} images, bf16, host geometry included)",
          flush=True)
    return out


def card_vs_cpu_phase(torch, seed: int, arch: str = "deeplab",
                      backbone: str = "mobilenet", side: int = 65,
                      dtypes=("float32", "float64")):
    """One train step of ``arch`` (SGD; at ``side`` px, 65 by default),
    batch 2, from the same weights on the card
    and on the CPU, TF32 off, dropout off, BN at running statistics; in
    f32 (the uint8 wire), then with f64 weights and a host-normalized f64
    image (the loss stays f32). The loss agrees within CPU_LOSS_RTOL. The
    updated parameters: in f32 the largest difference over the model
    within CPU_PARAM_RTOL of its largest weight (a zero-initialized bias
    updated once holds only -lr * grad, and a BN bias's grad is a sum over
    every pixel with much cancellation, which f32 summation order shifts
    by far more than 1e-3 of itself); in f64 every tensor within
    CPU_PARAM_RTOL of its own largest element."""
    import copy

    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import make_schedule
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import make_train_step

    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (2, side, side, 3), dtype=np.uint8)
    label = rng.randint(0, NUM_CLASSES, (2, side, side)).astype(np.uint8)
    label[:, :6] = 255
    cw = rng.uniform(0.5, 2.0, NUM_CLASSES).astype(np.float32)
    images = {"float32": image,
              "float64": ((image / 255.0 - np.array([0.485, 0.456, 0.406]))
                          / np.array([0.229, 0.224, 0.225]))}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dtype in dtypes:
            cpu_model = build_model(arch, NUM_CLASSES, backbone=backbone,
                                    mc_dropout=True, device="cpu",
                                    generator=torch.Generator().manual_seed(seed))
            cpu_model = cpu_model.to(getattr(torch, dtype))
            models = {"cpu": cpu_model, DEVICE: copy.deepcopy(cpu_model).to(DEVICE)}
            losses = {}
            for dev, model in models.items():
                freeze_bn(model)
                opt = build_optimizer("SGD", param_groups(model, arch))
                step = make_train_step(model, opt, build_loss(
                    "ce", class_weights=torch.from_numpy(cw).to(dev)),
                    make_schedule("poly", 0.01, 200, 4))
                batch = {"image": torch.from_numpy(images[dtype]).to(dev),
                         "label": torch.from_numpy(label).to(dev)}
                losses[dev] = float(step(batch, 0)["loss"])
            loss_rel = abs(losses[DEVICE] - losses["cpu"]) / abs(losses["cpu"])
            card = dict(models[DEVICE].named_parameters())
            per_tensor = sorted(
                (((card[n].detach().cpu() - p.detach()).abs().max()
                  / p.detach().abs().max().clamp_min(1e-30)).item(), n)
                for n, p in models["cpu"].named_parameters())
            model_rel = max((card[n].detach().cpu() - p.detach()).abs().max().item()
                            for n, p in models["cpu"].named_parameters()) / max(
                p.detach().abs().max().item() for p in models["cpu"].parameters())
            print(f"card vs CPU, one {dtype} {arch}/{backbone} step at {side} px: "
                  f"loss {losses[DEVICE]:.9f} "
                  f"vs {losses['cpu']:.9f} (rel {loss_rel:.2e}, bar {CPU_LOSS_RTOL}); "
                  f"parameters: largest difference {model_rel:.2e} of the largest "
                  f"weight; worst tensors {[(n, f'{r:.2e}') for r, n in per_tensor[-3:]]}"
                  f" (bar {CPU_PARAM_RTOL})", flush=True)
            check(loss_rel <= CPU_LOSS_RTOL, f"card and CPU {dtype} step losses agree")
            worst = model_rel if dtype == "float32" else per_tensor[-1][0]
            check(worst <= CPU_PARAM_RTOL,
                  f"card and CPU {dtype} updated parameters agree")
            out[dtype] = {"loss_card": losses[DEVICE], "loss_cpu": losses["cpu"],
                          "loss_rel": loss_rel, "model_rel": model_rel,
                          "worst_tensors": per_tensor[-3:]}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return out


def al_round_phase(torch, seed: int, root: Path, paths):
    """One whole AL round (and the next round's training) through
    ``run_active_loop`` on the card, every launch count set to 0 just
    before and read just after: selections 10 then 15, best.ckpt reloads
    bit for bit, the selection ran on B1 (20 launches per scoring batch)
    and not B2, and the scores of the remaining pool under round 0's
    best.ckpt are finite and rank the loop's pick."""
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.engine.active_loop import (
        run_active_loop)
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.ops.entropy import mean_over_pixels
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)
    from deep_active_semantic_segmentation_torch.selection.base import (
        rank_descending)
    from deep_active_semantic_segmentation_torch.utils.checkpoint import load_checkpoint

    cfg = parse_cli(ROUND_ARGV + ["--seed", str(seed), "--checkname", "round"]).finalize()
    runs = root / "runs"
    reset_counts()
    t0 = time.perf_counter()
    history = run_active_loop(cfg, dataset_root=str(root), runs_root=str(runs),
                              device=DEVICE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    exp = runs / cfg.dataset / cfg.checkname
    runs_dirs = sorted(d.name for d in exp.iterdir() if d.name.startswith("run_"))
    sel = [(exp / d / "selections.txt").read_text().splitlines() for d in runs_dirs]
    rounds = [history[k]["seconds"] for k in sorted(history)]
    print(f"AL round through run_active_loop: {wall_s:.3f} s for 2 rounds; "
          f"selections {[len(s) for s in sel]}; launches {json.dumps(counts)}; "
          "round 0 train / validate / select s: "
          f"{rounds[0]['train']:.3f} / {rounds[0]['validate']:.3f} / "
          f"{rounds[0]['select']:.3f}; round 1 train / validate s: "
          f"{rounds[1]['train']:.3f} / {rounds[1]['validate']:.3f}", flush=True)
    check([len(s) for s in sel] == [SEED_SET, SEED_SET + cfg.active_batch_size],
          f"selections.txt holds 10 then 15 lines: {[len(s) for s in sel]}")
    check(sel[1][:SEED_SET] == sel[0], "round 1 keeps round 0's labeled set")
    n_batches = -(-(POOL - SEED_SET) // cfg.batch_size)
    check(counts["upsample4_argmax"] == constants.MC_STEPS * n_batches,
          f"B1 launched {counts['upsample4_argmax']} times in the round, "
          f"expected {constants.MC_STEPS * n_batches}")
    check(counts["tconv2x_argmax_parity_major"] == 0, "no B2 launch in the round")

    # best.ckpt reloads onto the card bit for bit
    path = exp / runs_dirs[0] / "best.ckpt"
    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device=DEVICE)
    payload = load_checkpoint(str(path), model, device=DEVICE)
    on_file = torch.load(str(path), map_location="cpu", weights_only=True)["state_dict"]
    check(all(torch.equal(model.state_dict()[k].cpu(), v) for k, v in on_file.items())
          and payload["state_dict"].keys() == model.state_dict().keys(),
          "best.ckpt reloads to the same tensors bit for bit")
    # the scores the round ranked: finite, and their top 5 is the pick
    store = DirectoryStore(str(root / "cityscapes" / "train"))
    remaining = [p for p in paths if p.decode() not in set(sel[0])]
    sel_obj = get_active_selection_class("variance", NUM_CLASSES, store,
                                         cfg.crop_size, cfg.batch_size, device=DEVICE)
    scorer = sel_obj._scorer(ModelBundle(model, torch.device(DEVICE)), cfg.seed + 0)
    scores = sel_obj._collect_scores(remaining, lambda b: mean_over_pixels(scorer(b)),
                                     include_labels=True, labels_as_mask=NUM_CLASSES)
    check(len(scores) == len(remaining) and bool(np.isfinite(scores).all()),
          "the round's scores are finite")
    check([p.decode() for p in rank_descending(scores, remaining, cfg.active_batch_size)]
          == sel[1][SEED_SET:], "the round picked the top 5 of its scores")
    return {"wall_s": wall_s, "counts": counts, "selections": [len(s) for s in sel],
            "rounds": [history[f] for f in sorted(history)],
            "launches": counts["upsample4_argmax"]}


# ------------------------------------------------- region selection and CEAL

# region rounds: the canonical flags on active_cityscapes_region at the
# config's default region 129: ceil(5 * 513² / 129²) = 80 boxes requested
REGION = 129
REGION_ARGV = ROUND_ARGV + ["--dataset", "active_cityscapes_region",
                            "--active-region-size", str(REGION)]
# a CEAL weak-label round; the threshold sits above log2(19) = 4.25 bits, the
# largest entropy, so every remaining image but the picks is weakly labeled
CEAL_ARGV = ROUND_ARGV + ["--active-selection-mode", "ceal_entropy_weakly_labeled",
                          "--weak-label-entropy-threshold", "5.0"]
# timed runs of the CEAL entropy query over the pool (median and spread)
CEAL_QUERY_RUNS = 5
# the canonical region round's NMS: the 2975-image Cityscapes train split,
# box-sum maps at crop 513 (385²), ceil(50 * 513² / 129²) = 791 boxes
NMS_POOL, NMS_SIDE, NMS_BOXES = 2975, 513 - REGION + 1, 791
# pa_experiments_06t-09t.sh: Pascal VOC letterboxed to 512 (crop -1), 21
# classes; records the size of a VOC image
PASCAL_HW, PASCAL_CLASSES = (375, 500), 21
PASCAL_RECORDS = dict(hw=PASCAL_HW, block=25, num_classes=PASCAL_CLASSES,
                      void=(15, 47))


class spy_on:
    """Wrap ``cls.name`` for the length of a ``with`` block: after each
    call, ``after(obj, pixels_before, *args)`` runs, ``pixels_before``
    being the pool's labeled-pixel count before the call."""

    def __init__(self, cls, name, after):
        self.cls, self.name, self.after = cls, name, after

    def __enter__(self):
        real = self.real = getattr(self.cls, self.name)

        def wrapper(obj, *args):
            pixels_before = obj.labeled_pixel_count
            result = real(obj, *args)
            self.after(obj, pixels_before, *args)
            return result
        setattr(self.cls, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.real)


def read_selections(exp: Path):
    """{run dir: [(path, [(r, c, h, w), ...]), ...]} of a loop's
    selections.txt files, each line checked for the JAX package's format
    (``path`` or ``path,r,c,h,w[,r,c,h,w...]``)."""
    out = {}
    for d in sorted(p for p in exp.iterdir() if p.name.startswith("run_")):
        rows = []
        for line in (d / "selections.txt").read_text().splitlines():
            path, *nums = line.split(",")
            check(len(nums) % 4 == 0 and all(x.isdigit() for x in nums),
                  f"selections line in the JAX format: {line[:80]}")
            nums = [int(x) for x in nums]
            rows.append((path, [tuple(nums[i:i + 4]) for i in range(0, len(nums), 4)]))
        out[d.name] = rows
    return out


def nms_device_vs_host(torch, norm, region_size: int, count: int):
    """(device regions, host regions, device ms) of one NMS over ``norm``
    (N, S, S) on the card, which it modifies in place; the host NMS runs on
    a copy of the same maps, taken before."""
    from deep_active_semantic_segmentation_torch.ops import region as region_ops

    host_maps = norm.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    boxes, k = region_ops.square_nms_device(norm, region_size, count)
    k = int(k)                                 # the one wait for the card
    device_ms = (time.perf_counter() - t0) * 1e3
    dev = region_ops.device_boxes_to_regions(boxes.cpu().numpy(), k,
                                             norm.shape[0], region_size)
    host = region_ops.square_nms(host_maps, region_size, count)
    return dev, host, device_ms


def region_round_phase(torch, seed: int, root: Path, paths, mode: str = "variance"):
    """Two rounds of ``mode`` (``variance`` or ``noise_variance``) on
    ``active_cityscapes_region`` through ``run_active_loop``, launch counts
    set to 0 just before and read just after: B1 20 launches per scoring
    batch and sweep over the whole pool (4 batches; ``noise_variance``
    runs a feature-noise and a dropout sweep per batch), no B2;
    selections.txt in the JAX format with the seed images' whole boxes;
    the labeled pixels grow by count * 129²; the loop's boxes equal the
    device NMS and the host NMS on the same normalized maps, re-scored
    from round 0's best.ckpt with the loop's seed."""
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data import pools
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.engine.active_loop import (
        run_active_loop)
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.ops import region as region_ops
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)
    from deep_active_semantic_segmentation_torch.selection.region_pipeline import (
        region_score_maps)
    from deep_active_semantic_segmentation_torch.utils.checkpoint import load_checkpoint

    checkname = "region" if mode == "variance" else f"region_{mode}"
    cfg = parse_cli(REGION_ARGV + ["--seed", str(seed), "--checkname", checkname,
                                   "--active-selection-mode", mode]).finalize()
    sweeps = NOISE_MODES[mode][0] if mode in NOISE_MODES else ("dropout",)
    crop = cfg.crop_size
    requested = math.ceil(cfg.active_batch_size * crop ** 2 / REGION ** 2)
    grown = []
    with spy_on(pools.ActiveRegionPool, "expand_training_set",
                lambda pool, before, regions, pixels: grown.append(
                    (before, pool.labeled_pixel_count,
                     sum(len(v) for v in regions.values())))):
        reset_counts()
        t0 = time.perf_counter()
        history = run_active_loop(cfg, dataset_root=str(root),
                                  runs_root=str(root / "runs"), device=DEVICE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()
    rounds = [history[k]["seconds"] for k in sorted(history)]
    sel = list(read_selections(root / "runs" / cfg.dataset / cfg.checkname).values())
    n_boxes = [sum(len(b) for _, b in rows) for rows in sel]
    count = n_boxes[1] - n_boxes[0]
    print(f"region {mode} round through run_active_loop: {wall_s:.3f} s for 2 rounds; "
          f"boxes {count} of {requested} requested; launches {json.dumps(counts)}; "
          "round 0 train / validate / select s: "
          f"{rounds[0]['train']:.3f} / {rounds[0]['validate']:.3f} / "
          f"{rounds[0]['select']:.3f}; round 1 train / validate s: "
          f"{rounds[1]['train']:.3f} / {rounds[1]['validate']:.3f}", flush=True)
    n_batches = -(-POOL // cfg.batch_size)
    expected = constants.MC_STEPS * n_batches * len(sweeps)
    check(counts["upsample4_argmax"] == expected,
          f"B1 launched {counts['upsample4_argmax']} times in the region round, "
          f"expected {expected} (the whole pool is scored)")
    check(counts["tconv2x_argmax_parity_major"] == 0, "no B2 launch in the region round")
    check(sel[0] == [(p, [(0, 0, crop, crop)]) for p, _ in sel[0]]
          and len(sel[0]) == SEED_SET, "round 0 holds the seed images' whole boxes")
    check([p for p, _ in sel[1][:SEED_SET]] == [p for p, _ in sel[0]],
          "round 1 keeps round 0's images first")
    check(1 <= count <= requested, f"{count} boxes of {requested}")
    check(len(grown) == 1 and grown[0][2] == count
          and grown[0][1] - grown[0][0] == count * REGION ** 2,
          f"labeled pixels grew by count * {REGION}²: {grown}")

    # the same normalized maps re-scored from round 0's best.ckpt
    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device=DEVICE)
    exp = root / "runs" / cfg.dataset / cfg.checkname
    load_checkpoint(str(sorted(exp.glob("run_*"))[0] / "best.ckpt"), model, device=DEVICE)
    store = DirectoryStore(str(root / "cityscapes" / "train"))
    images = list(store.keys())
    seeded = {p.encode() for p, _ in sel[0]}
    existing = [[(0, 0, crop, crop)] if p in seeded else [] for p in images]
    sel_obj = get_active_selection_class(mode, NUM_CLASSES, store, crop,
                                         cfg.batch_size, device=DEVICE)
    bundle = ModelBundle(model, torch.device(DEVICE))
    norm = region_score_maps(
        sel_obj._scorer(bundle, cfg.seed + 0, sweeps),
        sel_obj._paths_loader(images, include_labels=True, labels_as_mask=NUM_CLASSES),
        existing, REGION)
    check(tuple(norm.shape) == (POOL, crop - REGION + 1, crop - REGION + 1)
          and bool(torch.isfinite(norm).all()), f"normalized maps {tuple(norm.shape)}")
    (dev, dev_count), (host, host_count), nms_ms = nms_device_vs_host(
        torch, norm, REGION, requested)
    check(dev == host and dev_count == host_count,
          "device NMS boxes equal host square_nms on the same maps")
    loop_new = {p.encode(): b[1:] if p.encode() in seeded else b for p, b in sel[1]}
    loop_new = {p: b for p, b in loop_new.items() if b}
    check(region_ops.regions_to_dict(images, dev) == loop_new and dev_count == count,
          "the loop's boxes equal the re-scored device NMS's")
    return {"wall_s": wall_s, "counts": counts, "boxes": count,
            "requested": requested, "rounds": [history[f] for f in sorted(history)],
            "nms_ms": nms_ms, "launches": counts["upsample4_argmax"]}


def pascal_region_phase(torch, seed: int, root: Path):
    """One ``create_region_maps`` call at pa_experiments_06t-09t.sh's
    geometry: 20 synthetic 375x500 Pascal records, base 512, crop -1 (the
    letterbox), 21 classes, region 129, round 0's architecture with fresh
    weights, the first 10 images labeled. 4x127+1 = 509 != 512, so the
    sweep runs unfused: no B1 and no B2 launch. Its boxes equal the host
    NMS's on the same normalized maps. Writes the Pascal dataset (train,
    val and seed sets) that the accuracy-predictor phases use too."""
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.ops import region as region_ops
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)
    from deep_active_semantic_segmentation_torch.selection.region_pipeline import (
        region_score_maps)

    store, paths = write_dataset(root, seed + 2, "pascal", **PASCAL_RECORDS)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = build_model("deeplab", PASCAL_CLASSES, device=DEVICE, generator=gen,
                        **PATHS["deeplab"]["build"])
    bundle = ModelBundle(model, torch.device(DEVICE))
    base, batch = 512, PATHS["deeplab"]["batch"]
    sel = get_active_selection_class("variance", PASCAL_CLASSES, store, -1, batch,
                                     device=DEVICE)
    existing = [[(0, 0, base, base)] if i < SEED_SET else [] for i in range(len(paths))]
    requested = math.ceil(5 * base ** 2 / REGION ** 2)
    reset_counts()
    t0 = time.perf_counter()
    regions, count = sel.create_region_maps(bundle, paths, existing, REGION, 5, seed=seed)
    query_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"pascal region query (base 512, crop -1, 21 classes): {len(paths)} images "
          f"in {query_s:.3f} s, {count} boxes of {requested}, launches "
          f"{json.dumps(counts)}", flush=True)
    check(all(n == 0 for n in counts.values()),
          f"the letterboxed sweep runs unfused: {counts}")
    norm = region_score_maps(
        sel._scorer(bundle, seed),
        sel._paths_loader(paths, include_labels=True, labels_as_mask=PASCAL_CLASSES),
        existing, REGION)
    check(tuple(norm.shape) == (len(paths), base - REGION + 1, base - REGION + 1),
          f"pascal normalized maps {tuple(norm.shape)}")
    (dev, dev_count), (host, host_count), _ = nms_device_vs_host(
        torch, norm, REGION, requested)
    check(dev == host and dev_count == host_count,
          "pascal: device NMS boxes equal host square_nms")
    check(region_ops.regions_to_dict(paths, dev) == regions and dev_count == count,
          "pascal: the entry point's boxes equal the re-scored NMS's")
    check(not any(p in regions for p in paths[:SEED_SET]),
          "pascal: the labeled images take no box")
    return {"query_s": query_s, "counts": counts, "boxes": count,
            "requested": requested}


def canonical_nms_phase(torch, seed: int):
    """The NMS at the canonical round's size: a seeded (2975, 385, 385) f32
    stack on the card (16 levels in 35-pixel cells: plateaus, with ties
    inside and across maps), 791 boxes. Device boxes equal the host
    square_nms's; device NMS ms (median of 3, the stack uploaded anew from
    a host copy before each, since the NMS works in place) and peak memory;
    box sum and normalization ms for one batch of 5 maps at 513²."""
    from deep_active_semantic_segmentation_torch.ops import region as region_ops
    from deep_active_semantic_segmentation_torch.selection.region_pipeline import (
        minmax_normalize)

    check(NMS_BOXES == math.ceil(region_ops.num_requested_regions(50, 513, REGION)),
          "791 boxes: a 50-image budget at 513² in 129² boxes")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    cells = NMS_SIDE // 35
    low = torch.randint(0, 16, (NMS_POOL, cells, cells), generator=gen,
                        device=DEVICE).float() / 15
    norm = minmax_normalize(low.repeat_interleave(35, 1).repeat_interleave(35, 2))
    del low
    stack_bytes = norm.numel() * 4
    t0 = time.perf_counter()
    host_maps = norm.cpu().numpy()
    copy_s = time.perf_counter() - t0
    # the stack's making held two copies; the peak is the NMS's, the one
    # stack it works on in place included
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for run in range(3):
        if run:
            norm.copy_(torch.from_numpy(host_maps))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        boxes, k = region_ops.square_nms_device(norm, REGION, NMS_BOXES)
        dev_count = int(k)
        runs.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() - base
    dev = region_ops.device_boxes_to_regions(boxes.cpu().numpy(), dev_count,
                                             NMS_POOL, REGION)
    t0 = time.perf_counter()
    host = region_ops.square_nms(host_maps, REGION, NMS_BOXES)
    host_s = time.perf_counter() - t0
    del host_maps
    nms_ms = float(np.median(runs))
    print(f"canonical NMS: ({NMS_POOL}, {NMS_SIDE}, {NMS_SIDE}) f32 "
          f"({stack_bytes / 1e9:.3f} GB), {dev_count} boxes of {NMS_BOXES}: device "
          f"{nms_ms:.3f} ms (runs {[round(r, 3) for r in runs]}), peak memory above "
          f"the start {peak / 2**30:.3f} GiB; host square_nms {host_s:.3f} s after a "
          f"{copy_s:.3f} s copy", flush=True)
    check(dev == host, "canonical NMS: device boxes equal host square_nms")
    check(dev_count == NMS_BOXES, f"{dev_count} boxes, expected {NMS_BOXES}")
    del norm, boxes

    maps = (torch.randint(0, 256, (5, 513, 513), generator=gen, device=DEVICE)
            .float() / 256)
    box_ms = cuda_ms(lambda: region_ops.box_sum_valid(maps, REGION), 20)
    box_norm_ms = cuda_ms(lambda: minmax_normalize(
        region_ops.box_sum_valid(maps, REGION)), 20)
    # f64 integral image: exact for k/256 values (sums stay far below 2^53/256)
    c = torch.nn.functional.pad(maps.double().cumsum(1).cumsum(2), (1, 0, 1, 0))
    R = REGION
    ref = c[:, R:, R:] - c[:, :-R, R:] - c[:, R:, :-R] + c[:, :-R, :-R]
    box_err = (region_ops.box_sum_valid(maps, REGION).double() - ref).abs().max().item()
    print(f"box sum of 5 maps at 513² (region {REGION}): {box_ms:.4f} ms; with the "
          f"normalization {box_norm_ms:.4f} ms; largest difference from an f64 "
          f"box sum {box_err:.3e} (values to {ref.max().item():.1f})", flush=True)
    check(box_err == 0.0, "box sum of k/256 maps is exact in f32")
    return {"pool": NMS_POOL, "side": NMS_SIDE, "boxes": dev_count,
            "stack_bytes": stack_bytes, "nms_ms": nms_ms, "nms_runs_ms": runs,
            "peak_bytes_above_start": peak, "host_nms_s": host_s,
            "host_copy_s": copy_s, "box_sum_ms_5x513": box_ms,
            "box_sum_normalize_ms_5x513": box_norm_ms}


def ceal_round_phase(torch, seed: int, root: Path, paths):
    """Two rounds of ``ceal_entropy_weakly_labeled`` through
    ``run_active_loop``, launch counts set to 0 just before and read just
    after: no B1 and no B2 launch; round 1's train pool is labeled + weak;
    each weak target is 255 exactly where the mask is invalid; the pick is
    the top 5 of the entropies re-scored on the card (TF32 off). Then, on
    round 0's best.ckpt: the confidence, margin and fusion queries, their
    scores finite and their picks equal to a re-score's; CEAL query
    images/s."""
    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data import pools
    from deep_active_semantic_segmentation_torch.data.loader import PathsLoader
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.engine.active_loop import (
        run_active_loop)
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)
    from deep_active_semantic_segmentation_torch.selection.base import rank_ascending
    from deep_active_semantic_segmentation_torch.utils.checkpoint import load_checkpoint

    cfg = parse_cli(CEAL_ARGV + ["--seed", str(seed), "--checkname", "ceal"]).finalize()
    added = []
    with spy_on(pools.ActiveImagePool, "add_weak_labels",
                lambda pool, before, weak: added.append(
                    (dict(weak), len(pool.current_image_paths), len(pool)))):
        reset_counts()
        t0 = time.perf_counter()
        history = run_active_loop(cfg, dataset_root=str(root),
                                  runs_root=str(root / "runs"), device=DEVICE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()
    rounds = [history[k]["seconds"] for k in sorted(history)]
    sel = [[p for p, _ in rows] for rows in
           read_selections(root / "runs" / cfg.dataset / cfg.checkname).values()]
    print(f"CEAL round through run_active_loop: {wall_s:.3f} s for 2 rounds; "
          f"selections {[len(s) for s in sel]}; launches {json.dumps(counts)}; "
          "round 0 train / validate / select s: "
          f"{rounds[0]['train']:.3f} / {rounds[0]['validate']:.3f} / "
          f"{rounds[0]['select']:.3f}; round 1 train / validate s: "
          f"{rounds[1]['train']:.3f} / {rounds[1]['validate']:.3f}", flush=True)
    check(all(n == 0 for n in counts.values()), f"no B1 or B2 launch in CEAL: {counts}")
    k = cfg.active_batch_size
    check([len(s) for s in sel] == [SEED_SET, SEED_SET + k] and sel[1][:SEED_SET] == sel[0],
          f"CEAL selections 10 then 15: {[len(s) for s in sel]}")
    check(len(added) == 1, "weak labels added once")
    weak, n_labeled, n_pool = added[0]
    check(n_labeled == SEED_SET + k and n_pool == n_labeled + len(weak)
          and len(weak) == POOL - SEED_SET - k,
          f"round 1's train pool is labeled + weak: {n_labeled} + {len(weak)} = {n_pool}")
    store = DirectoryStore(str(root / "cityscapes" / "train"))
    loader = PathsLoader(store, list(weak), cfg.crop_size, 1, include_labels=True,
                         labels_as_mask=NUM_CLASSES)
    for path, target in weak.items():
        packed = loader.build_batch([path])["label"][0]
        valid = np.unpackbits(packed, axis=-1)[:, :cfg.crop_size].astype(bool)
        check(target.dtype == np.uint8 and target.shape == valid.shape
              and np.array_equal(target == 255, ~valid)
              and bool((target[valid] < NUM_CLASSES).all()),
              "weak targets are 255 exactly where the mask is invalid")

    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device=DEVICE)
    exp = root / "runs" / cfg.dataset / cfg.checkname
    load_checkpoint(str(sorted(exp.glob("run_*"))[0] / "best.ckpt"), model, device=DEVICE)
    bundle = ModelBundle(model, torch.device(DEVICE))
    ceal = get_active_selection_class(cfg.active_selection_mode, NUM_CLASSES, store,
                                      cfg.crop_size, cfg.batch_size, device=DEVICE)
    remaining = [p for p in paths if p.decode() not in set(sel[0])]
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    top, entropies = ceal.get_maximum_entropy_samples(bundle, remaining, k)
    check(bool(np.isfinite(entropies).all()) and [p.decode() for p in top] == sel[1][SEED_SET:],
          "the CEAL round picked the top 5 of the re-scored entropies")
    ranked = {}
    for mode, entry in (("confidence", ceal.get_least_confident_samples),
                        ("margin", ceal.get_least_margin_samples)):
        picked = entry(bundle, remaining, k)
        scores = ceal._score(bundle, remaining, mode)
        check(bool(np.isfinite(scores).all())
              and rank_ascending(scores, remaining, k) == picked,
              f"CEAL {mode}: finite scores, pick equal to a re-score's")
        ranked[mode] = picked
    fused = ceal.get_fusion_of_confidence_margin_entropy_samples(
        bundle, remaining, k, rng=random.Random(seed))
    union = set(ranked["confidence"] + ranked["margin"] + top)
    check(len(fused) == min(k, len(union)) and set(fused) <= union
          and fused == ceal.get_fusion_of_confidence_margin_entropy_samples(
              bundle, remaining, k, rng=random.Random(seed)),
          "CEAL fusion: a draw from the three picks' union, the same from one seed")
    check((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
          == flags, "the CEAL scorers restore the TF32 flags")

    # CEAL query throughput: the entropy query over the whole pool, timed
    # CEAL_QUERY_RUNS times after a warm-up (one run is too short a window)
    ceal.get_maximum_entropy_samples(bundle, paths[:cfg.batch_size], 1)   # warm-up
    runs = []
    for _ in range(CEAL_QUERY_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ceal.get_maximum_entropy_samples(bundle, paths, k)
        runs.append(time.perf_counter() - t0)
    query_s = float(np.median(runs))
    rates = sorted(len(paths) / r for r in runs)
    print(f"CEAL entropy query: {len(paths)} images, median of {CEAL_QUERY_RUNS} "
          f"{query_s:.3f} s ({len(paths) / query_s:.2f} images/s; runs "
          f"{[round(r, 2) for r in rates]} images/s; crop {cfg.crop_size}, batch "
          f"{cfg.batch_size}, TF32 off)", flush=True)
    return {"wall_s": wall_s, "counts": counts, "selections": [len(s) for s in sel],
            "weak": len(weak), "rounds": [history[f] for f in sorted(history)],
            "query_s": query_s, "query_runs_s": runs,
            "query_images_per_s": len(paths) / query_s}


# ----------------------------------------- MC-noise, core-set, max-subset, oracle

# mode -> (the sweeps of one scoring batch, the selector's entry point)
NOISE_MODES = {
    "noise_image": (("input",), "get_vote_entropy_for_images_with_input_noise"),
    "noise_feature": (("feature",), "get_vote_entropy_for_images_with_feature_noise"),
    "noise_variance": (("feature", "dropout"),
                       "get_vote_entropy_for_batch_with_noise_and_vote_entropy"),
}
# timed runs of each noise query over the pool (median and spread)
NOISE_QUERY_RUNS = 3
# greedy selection at the canonical sizes: k-center over the 2975 Cityscapes
# train images' pooled decoder features at 513² (3 x 3 x 304: a 129² map
# pooled 64 / 32), 150 labeled and 150 picked; max-subset over the
# 2975 x 16 region-grid tiles (129² regions on the 129² map: 32-cell
# tiles, 4 x 4) x 304 against the doubled candidates of a 60-image budget
# (ceil(60 * 513² / 129²) = 949 boxes, 1898 candidates), picking 949
KCENTER_N, KCENTER_D, KCENTER_SEEDS, KCENTER_PICKS = 2975, 3 * 3 * 304, 150, 150
MAXREP_M, MAXREP_K, MAXREP_D, MAXREP_PICKS = 2975 * 16, 2 * 949, 304, 949
# max-subset picks held against the CPU (a greedy prefix; the CPU run of all
# 949 would take minutes); two candidates whose scores sit this close may
# swap between the card's and the CPU's f32 sums
MAXREP_CHECKED, GREEDY_SCORE_RTOL = 64, 1e-5
GREEDY_RUNS = 3
# the file a k-center split between the card and the CPU is dumped to
# (features, seed mask, both pick lists) before the near-tie check reads
# it: beside the --out file, or in the repo's root without one
KCENTER_DUMP = "kcenter_mismatch.npz"


def noise_query_phase(torch, seed: int, arch: str, store, paths, modes):
    """Each MC-noise query of ``modes`` through its selector's entry point
    (PATHS geometry, fresh weights from ``seed``), timed NOISE_QUERY_RUNS
    times with the launch counts set to 0 just before each and read just
    after: the path's kernel 20 launches per scoring batch and sweep, the
    other none; the same picks every run; finite scores whose top 5 is
    the pick; batch 0 re-scored with the kernel's plain version in its
    place under the same generator states (B1: equal bit for bit; B2:
    >= 99.5% of the entropy pixels equal, the vote bar); the device
    kernels of one batch's sweep."""
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.ops.entropy import mean_over_pixels
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)
    from deep_active_semantic_segmentation_torch.selection.base import (
        rank_descending)

    cfg = PATHS[arch]
    crop, batch_size, kernel = cfg["crop"], cfg["batch"], cfg["kernel"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = build_model(arch, NUM_CLASSES, device=DEVICE, generator=gen, **cfg["build"])
    bundle = ModelBundle(model, torch.device(DEVICE))
    n_batches = -(-len(paths) // batch_size)
    out = {}
    for mode in modes:
        sweeps, entry = NOISE_MODES[mode]
        sel = get_active_selection_class(mode, NUM_CLASSES, store, crop, batch_size,
                                         device=DEVICE)
        query = getattr(sel, entry)
        query(bundle, paths[:batch_size], 1, seed=1)       # warm-up
        torch.cuda.synchronize()
        runs, counts, tops = [], [], []
        for _ in range(NOISE_QUERY_RUNS):
            reset_counts()
            t0 = time.perf_counter()
            tops.append(query(bundle, paths, 5, seed=0))
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            counts.append(read_counts())
        expected = constants.MC_STEPS * n_batches * len(sweeps)
        rates = sorted(len(paths) / r for r in runs)
        print(f"{arch} {mode} query: {len(paths)} images, median of {NOISE_QUERY_RUNS} "
              f"{float(np.median(runs)):.3f} s ({rates[len(rates) // 2]:.2f} images/s; "
              f"min {rates[0]:.2f}, max {rates[-1]:.2f}); launches per run "
              f"{json.dumps(counts)} on {card_line()}", flush=True)
        for c in counts:
            check(c[kernel] == expected, f"{arch} {mode}: {kernel} launched "
                                         f"{c[kernel]} times, expected {expected}")
            check(all(n == 0 for name, n in c.items() if name != kernel),
                  f"{arch} {mode}: no other kernel launched: {c}")
        check(all(t == tops[0] for t in tops) and len(set(tops[0])) == 5,
              f"{arch} {mode}: 5 distinct picks, the same every run")

        scorer = sel._scorer(bundle, 0, sweeps)
        scores = sel._collect_scores(paths, lambda b: mean_over_pixels(scorer(b)),
                                     include_labels=True, labels_as_mask=NUM_CLASSES)
        check(len(scores) == len(paths) and bool(np.isfinite(scores).all())
              and rank_descending(scores, list(paths), 5) == tops[0],
              f"{arch} {mode}: finite scores whose top 5 is the pick")

        batch = next(iter(sel._paths_loader(paths[:batch_size], include_labels=True,
                                            labels_as_mask=NUM_CLASSES)))
        fused = sel._scorer(bundle, 0, sweeps)(batch)
        with plain_kernels():
            plain = sel._scorer(bundle, 0, sweeps)(batch)
        check(tuple(fused.shape) == (batch_size, crop, crop)
              and bool(torch.isfinite(fused).all()), f"{arch} {mode}: entropy maps")
        equal = (fused == plain).float().mean().item()
        mean_abs = (fused - plain).abs().mean().item()
        print(f"{arch} {mode}: batch 0 re-scored with the plain {kernel}: equal "
              f"{equal:.6f}, mean |d| {mean_abs:.3e}", flush=True)
        if arch == "deeplab":
            check(torch.equal(fused, plain), f"{mode}: B1 and its plain version give "
                                             "the same entropy maps bit for bit")
        else:
            check(equal >= 0.995 and mean_abs < 0.02,
                  f"{mode}: B2 and its plain version agree under the vote bar")
        out[mode] = {
            "sweeps": len(sweeps), "launches": counts[0][kernel], "counts": counts,
            "query_runs_s": runs, "images_per_s": len(paths) / float(np.median(runs)),
            "images_per_s_min_max": [rates[0], rates[-1]],
            "plain_rescore": {"equal": equal, "mean_abs": mean_abs},
            "profile": profile_sweep(torch, lambda: sel._scorer(bundle, 0, sweeps)(batch),
                                     f"one {arch} {mode} batch ({len(sweeps)} sweep(s))"),
            "top5": [p.decode() for p in tops[0]]}
    return out


def representative_rounds_phase(torch, seed: int, root: Path, paths):
    """One round each of ``coreset`` and ``variance_representative`` on
    ``active_cityscapes_image`` through ``run_active_loop``, launch counts
    set to 0 just before and read just after: B1 only in the MC stage of
    ``variance_representative`` (20 per scoring batch), B2 never; the
    round's picks equal a re-run of the selectors on round 0's best.ckpt.
    ``variance_representative`` asks for 3 images (the config doubles it
    to 6 MC candidates; 5 would leave the 20-image pool a single round)."""
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.engine.active_loop import (
        run_active_loop)
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class, get_max_subset_active_selector)
    from deep_active_semantic_segmentation_torch.utils.checkpoint import load_checkpoint

    store = DirectoryStore(str(root / "cityscapes" / "train"))
    out = {}
    for mode, k in (("coreset", 5), ("variance_representative", 3)):
        cfg = parse_cli(ROUND_ARGV + ["--seed", str(seed), "--checkname", mode,
                                      "--active-selection-mode", mode,
                                      "--active-batch-size", str(k)]).finalize()
        reset_counts()
        t0 = time.perf_counter()
        history = run_active_loop(cfg, dataset_root=str(root),
                                  runs_root=str(root / "runs"), device=DEVICE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        exp = root / "runs" / cfg.dataset / mode
        sel = [[p for p, _ in rows] for rows in read_selections(exp).values()]
        rounds = [history[f]["seconds"] for f in sorted(history)]
        print(f"{mode} round through run_active_loop: {wall_s:.3f} s for 2 rounds; "
              f"selections {[len(x) for x in sel]}; launches {json.dumps(counts)}; "
              f"round 0 train / validate / select s: {rounds[0]['train']:.3f} / "
              f"{rounds[0]['validate']:.3f} / {rounds[0]['select']:.3f}", flush=True)
        new = sel[1][SEED_SET:]
        check(len(sel) == 2 and sel[1][:SEED_SET] == sel[0] and len(new) == k
              and len(set(sel[1])) == len(sel[1]), f"{mode}: selections 10 then {10 + k}")
        n_mc = -(-(POOL - SEED_SET) // cfg.batch_size) if mode != "coreset" else 0
        check(counts["upsample4_argmax"] == constants.MC_STEPS * n_mc
              and counts["tconv2x_argmax_parity_major"] == 0,
              f"{mode}: B1 {constants.MC_STEPS * n_mc} launches (MC stage only), no B2: "
              f"{counts}")

        model = build_model("deeplab", NUM_CLASSES, mc_dropout=cfg.mc_dropout,
                            device=DEVICE)
        load_checkpoint(str(sorted(exp.glob("run_*"))[0] / "best.ckpt"), model,
                        device=DEVICE)
        bundle = ModelBundle(model, torch.device(DEVICE))
        labeled = [p.encode() for p in sel[0]]
        remaining = [p for p in paths if p not in set(labeled)]
        selector = get_active_selection_class(mode, NUM_CLASSES, store, cfg.crop_size,
                                              cfg.batch_size, device=DEVICE)
        if mode == "coreset":
            again = selector.get_k_center_greedy_selections(k, bundle, remaining, labeled)
        else:
            candidates = selector.get_vote_entropy_for_images(
                bundle, remaining, cfg.active_batch_size, seed=cfg.seed + 0)
            again = get_max_subset_active_selector(
                store, cfg.crop_size, cfg.batch_size, device=DEVICE
            ).get_representative_images(bundle, list(store.keys()), candidates)
        check([p.decode() for p in again] == new,
              f"{mode}: the round's picks equal a re-run on best.ckpt")
        out[mode] = {"wall_s": wall_s, "counts": counts, "selections": [len(x) for x in sel],
                     "rounds": [history[f] for f in sorted(history)]}
    return out


def precision_state(torch) -> dict:
    """The process's float32 precision settings as this torch reports
    them: the legacy matmul precision, the per-backend ones (torch >=
    2.9), CPU autocast and its dtype, the intra-op threads and the CPU
    capability torch dispatches to."""
    out = {}
    try:
        out["float32_matmul_precision"] = torch.get_float32_matmul_precision()
    except RuntimeError as e:   # legacy and per-backend settings disagree
        out["float32_matmul_precision"] = f"unreadable: {str(e)[:160]}"
    for name in ("fp32_precision", "mkldnn.matmul.fp32_precision",
                 "mkldnn.conv.fp32_precision", "cuda.matmul.fp32_precision"):
        obj = torch.backends
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is not None:
            out[f"backends.{name}"] = obj
    out["cpu_autocast"] = torch.is_autocast_enabled("cpu")
    out["cpu_autocast_dtype"] = str(torch.get_autocast_dtype("cpu"))
    out["threads"] = torch.get_num_threads()
    out["cpu_capability"] = next(
        (line.split(":", 1)[1].strip() for line in torch.__config__.show().splitlines()
         if "CPU capability" in line), None)
    return out


@contextlib.contextmanager
def full_f32(torch):
    """Every float32 precision setting forced to full float32 for the
    ``with`` block (the generic and oneDNN per-backend settings at IEEE,
    cuBLAS TF32 off, CPU autocast off), each put back after it."""
    b = torch.backends
    owners = [o for o in (b, getattr(b.mkldnn, "matmul", None),
                          getattr(b.mkldnn, "conv", None))
              if hasattr(o, "fp32_precision")]
    saved = [o.fp32_precision for o in owners], b.cuda.matmul.allow_tf32
    for o in owners:
        o.fp32_precision = "ieee"
    b.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast("cpu", enabled=False):
            yield
    finally:
        for o, value in zip(owners, saved[0]):
            o.fp32_precision = value
        b.cuda.matmul.allow_tf32 = saved[1]


def kcenter_f64(torch, x, mask, picks: int) -> list:
    """The k-center greedy in f64 (exact distances, ``torch.cdist``) on the
    CPU: the reference both f32 runs are read against."""
    x = x.double()
    min_d = torch.cdist(x, x[mask]).min(dim=1).values
    min_d[mask] = 0
    out = []
    for _ in range(picks):
        out.append(int(min_d.argmax()))
        min_d = torch.minimum(min_d, torch.cdist(x, x[out[-1]:out[-1] + 1])[:, 0])
    return out


def kcenter_split(torch, distance, feats, mask, dev, cpu, dump: Path) -> dict:
    """What a k-center split between the card and the CPU shows: the
    features, seed mask and both pick lists saved to ``dump``, the
    process's precision state, and the first pick where each of the card,
    the CPU, the CPU once more on the same tensors and the CPU with every
    precision setting forced to full f32 (``full_f32``) parts from the f64
    greedy."""
    x, m = feats.cpu(), mask.cpu()
    dump.parent.mkdir(parents=True, exist_ok=True)
    np.savez(dump, feats=x.numpy(), mask=m.numpy(), card=np.asarray(dev),
             cpu=np.asarray(cpu))
    state = precision_state(torch)
    again = distance.kcenter_greedy(x, m, KCENTER_PICKS).tolist()
    with full_f32(torch):
        forced = distance.kcenter_greedy(x, m, KCENTER_PICKS).tolist()
    ref = kcenter_f64(torch, x, m, KCENTER_PICKS)

    def first(picks):
        return next((i for i, (a, b) in enumerate(zip(picks, ref)) if a != b), None)

    parts = {"card": first(dev), "cpu": first(cpu), "cpu_again": first(again),
             "cpu_full_f32": first(forced)}
    print(f"k-center split dumped to {dump}; precision state "
          f"{json.dumps(state)}; first pick apart from the f64 greedy: "
          f"{json.dumps(parts)}", flush=True)
    return {"dump": str(dump), "precision_state": state,
            "first_apart_from_f64": parts}


def greedy_phase(torch, seed: int, dump_dir: Path = REPO):
    """k-center greedy and max-representative alone at the canonical sizes
    on seeded features (clustered and non-negative, as decoder features
    are), TF32 off as the selectors run them: ms (median of GREEDY_RUNS,
    with the runs), peak memory above the start, and the picks against the
    same function on the CPU: all of them for k-center, the first
    MAXREP_CHECKED for max-subset. The process's precision state is
    printed first. A k-center split is dumped to KCENTER_DUMP in
    ``dump_dir`` and read (``kcenter_split``) before the check. A mismatch fails unless the two candidates' scores
    at that step (recomputed in f64) are within GREEDY_SCORE_RTOL of each
    other; then that case is printed and the comparison stops there (the
    greedy paths part)."""
    from deep_active_semantic_segmentation_torch.ops import distance
    from deep_active_semantic_segmentation_torch.selection.kernels import (
        _deterministic_precision)

    state = precision_state(torch)
    print(f"greedy: precision state {json.dumps(state)}", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def features(n, d, clusters=64):
        centers = torch.rand(clusters, d, generator=gen, device=DEVICE) * 2
        idx = torch.randint(0, clusters, (n,), generator=gen, device=DEVICE)
        return torch.relu(centers[idx] + torch.randn(n, d, generator=gen, device=DEVICE))

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs = []
        for _ in range(GREEDY_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            picked = fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return picked, runs, torch.cuda.max_memory_allocated() - base

    def first_mismatch(dev, cpu):
        return next((i for i, (a, b) in enumerate(zip(dev, cpu)) if a != b), None)

    out = {}
    with _deterministic_precision():
        feats = features(KCENTER_N, KCENTER_D)
        mask = torch.zeros(KCENTER_N, dtype=torch.bool, device=DEVICE)
        mask[torch.randperm(KCENTER_N, generator=gen, device=DEVICE)[:KCENTER_SEEDS]] = True
        dev, runs, peak = timed(lambda: distance.kcenter_greedy(feats, mask, KCENTER_PICKS))
        dev = dev.tolist()
        t0 = time.perf_counter()
        cpu = distance.kcenter_greedy(feats.cpu(), mask.cpu(), KCENTER_PICKS).tolist()
        cpu_s = time.perf_counter() - t0
        i = first_mismatch(dev, cpu)
        near = split = None
        if i is not None:
            split = kcenter_split(torch, distance, feats, mask, dev, cpu,
                                  dump_dir / KCENTER_DUMP)
            x = feats.cpu().double()
            centers = x[mask.cpu() | torch.isin(torch.arange(KCENTER_N),
                                                torch.tensor(dev[:i], dtype=torch.long))]
            a, b = (torch.cdist(x[j:j + 1], centers).min().item() for j in (dev[i], cpu[i]))
            near = {"step": i, "device": dev[i], "cpu": cpu[i], "scores": [a, b]}
            print(f"k-center: pick {i} differs (card {dev[i]}, CPU {cpu[i]}); min "
                  f"distances {a!r} / {b!r}", flush=True)
            check(abs(a - b) <= GREEDY_SCORE_RTOL * max(a, b),
                  "k-center: a differing pick is a near-tie")
        print(f"k-center greedy, ({KCENTER_N}, {KCENTER_D}) f32, {KCENTER_SEEDS} seeds, "
              f"{KCENTER_PICKS} picks: median {float(np.median(runs)):.3f} ms (runs "
              f"{[round(r, 3) for r in runs]}), peak memory above the start "
              f"{peak / 2**20:.1f} MiB; picks equal the CPU's: "
              f"{'all' if i is None else i}; CPU run {cpu_s:.3f} s on {card_line()}",
              flush=True)
        out["kcenter"] = {"shape": [KCENTER_N, KCENTER_D], "ms_runs": runs,
                          "ms": float(np.median(runs)), "peak_bytes": peak,
                          "cpu_s": cpu_s, "near_tie": near, "split": split}
        del feats, mask

        pool = features(MAXREP_M, MAXREP_D)
        cand = features(MAXREP_K, MAXREP_D)
        dev, runs, peak = timed(lambda: distance.max_representative(pool, cand,
                                                                    MAXREP_PICKS))
        dev = dev.tolist()
        check(len(set(dev)) == MAXREP_PICKS, "max-subset: distinct picks")
        t0 = time.perf_counter()
        cpu = distance.max_representative(pool.cpu(), cand.cpu(), MAXREP_CHECKED).tolist()
        cpu_s = time.perf_counter() - t0
        i = first_mismatch(dev[:MAXREP_CHECKED], cpu)
        near = None
        if i is not None:
            x, c = pool.cpu().double(), cand.cpu().double()
            min_d = (torch.cdist(x, c[dev[:i]]).min(dim=1).values if i
                     else torch.full((MAXREP_M,), float("inf"), dtype=torch.float64))
            a, b = (torch.minimum(min_d, torch.cdist(x, c[j:j + 1])[:, 0]).sum().item()
                    for j in (dev[i], cpu[i]))
            near = {"step": i, "device": dev[i], "cpu": cpu[i], "scores": [a, b]}
            print(f"max-subset: pick {i} differs (card {dev[i]}, CPU {cpu[i]}); "
                  f"scores {a!r} / {b!r}", flush=True)
            check(abs(a - b) <= GREEDY_SCORE_RTOL * max(a, b),
                  "max-subset: a differing pick is a near-tie")
        print(f"max-representative, M {MAXREP_M} x K {MAXREP_K} x {MAXREP_D} f32, "
              f"{MAXREP_PICKS} picks: median {float(np.median(runs)):.3f} ms (runs "
              f"{[round(r, 3) for r in runs]}), peak memory above the start "
              f"{peak / 2**30:.3f} GiB; first {MAXREP_CHECKED} picks equal the CPU's: "
              f"{'all' if i is None else i}; CPU run of {MAXREP_CHECKED} {cpu_s:.3f} s",
              flush=True)
        out["max_representative"] = {"shape": [MAXREP_M, MAXREP_K, MAXREP_D],
                                     "ms_runs": runs, "ms": float(np.median(runs)),
                                     "peak_bytes": peak, "cpu_s": cpu_s,
                                     "near_tie": near}
    out["precision_state"] = state
    return out


def oracle_phase(torch, seed: int, root: Path, paths):
    """The oracle modes on the AL-round phase's run: an ``accuracy_labels``
    query over the pool at 513² on its round 0 best.ckpt (launch counts
    set to 0 just before, read just after: no B1 or B2), its counts equal
    to a recount from the argmax of re-scored logits and its pick their
    top 5; then one ``accuracy_eval`` consumer round through
    ``run_active_loop`` watching that run's selections.txt (no launch),
    its selections equal to the producer's, round by round."""
    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.engine.active_loop import (
        run_active_loop)
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)
    from deep_active_semantic_segmentation_torch.selection import kernels
    from deep_active_semantic_segmentation_torch.selection.base import rank_descending
    from deep_active_semantic_segmentation_torch.utils.checkpoint import load_checkpoint

    cfg = parse_cli(ROUND_ARGV + ["--seed", str(seed), "--checkname", "consumer",
                                  "--active-selection-mode", "accuracy_eval",
                                  "--monitor-directory", "round"]).finalize()
    runs_root = root / "runs"
    producer = runs_root / cfg.dataset / "round"
    model = build_model("deeplab", NUM_CLASSES, mc_dropout=True, device=DEVICE)
    load_checkpoint(str(sorted(producer.glob("run_*"))[0] / "best.ckpt"), model,
                    device=DEVICE)
    bundle = ModelBundle(model, torch.device(DEVICE))
    store = DirectoryStore(str(root / "cityscapes" / "train"))
    sel = get_active_selection_class("accuracy_labels", NUM_CLASSES, store,
                                     cfg.crop_size, cfg.batch_size, device=DEVICE)
    sel.get_least_accurate_sample_using_labels(bundle, paths[:cfg.batch_size], 1)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    top = sel.get_least_accurate_sample_using_labels(bundle, paths, 5)
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    counts = read_counts()
    check(all(n == 0 for n in counts.values()), f"no B1 or B2 launch in accuracy_labels: "
                                                f"{counts}")
    recount, counted = [], []
    for batch in sel._paths_loader(paths, include_labels=True):
        with torch.inference_mode(), kernels._deterministic_precision():
            pred = model(kernels.normalize_on_device(batch["image"])).argmax(dim=1)
        label = batch["label"].long()
        wrong = (label < NUM_CLASSES) & (pred != label)
        recount.extend(wrong.sum(dim=(1, 2))[:batch["nvalid"]].tolist())
        counted.extend(kernels.misprediction_counts(
            model, batch["image"], batch["label"], NUM_CLASSES)[:batch["nvalid"]].tolist())
    print(f"accuracy_labels query: {len(paths)} images in {query_s:.3f} s "
          f"({len(paths) / query_s:.2f} images/s, TF32 off); launches "
          f"{json.dumps(counts)}; counts {[int(c) for c in counted]}", flush=True)
    check(counted == [float(c) for c in recount],
          "misprediction counts equal a recount from the argmax of re-scored logits")
    check(rank_descending(recount, list(paths), 5) == top,
          "accuracy_labels picks the top 5 of the recount")

    reset_counts()
    t0 = time.perf_counter()
    run_active_loop(cfg, dataset_root=str(root), runs_root=str(runs_root), device=DEVICE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    eval_counts = read_counts()
    produced = read_selections(producer)
    consumed = read_selections(runs_root / cfg.dataset / "consumer")
    print(f"accuracy_eval consumer: {wall_s:.3f} s for 2 rounds; run dirs "
          f"{list(consumed)}; launches {json.dumps(eval_counts)}", flush=True)
    check(all(n == 0 for n in eval_counts.values()),
          f"no B1 or B2 launch in accuracy_eval: {eval_counts}")
    check(consumed == produced and len(consumed) == 2,
          "the accuracy_eval consumer replays the producer's selections.txt")
    return {"labels_query_s": query_s, "labels_counts": counts,
            "eval_wall_s": wall_s, "eval_counts": eval_counts}


# ---------------------------------------------------- the accuracy predictor

# pa_experiments_07t.sh / 17t.sh (accuracy_predictor_train.py, `accuracy`):
# Pascal at the 512 letterbox (crop -1), 21 classes, batch 5, lr 0.007 step
# schedule, balanced weights, the error head's loss weight 0.30 and
# wrong-class weight 0.75, bf16; cut to the Pascal phase's 20 records, a
# 10-image seed set, 1 epoch and 2 rounds
ACC_ARGV = ["--backbone", "mobilenet", "--lr", "0.007", "--epochs", "1",
            "--batch-size", "5", "--eval-interval", "1", "--base-size", "512",
            "--crop-size", "-1", "--use-lr-scheduler", "--lr-scheduler", "step",
            "--max-iterations", "2", "--active-batch-size", "5",
            "--use-balanced-weights", "--workers", "0", "--memory-hog",
            "--no-early-stop", "--active-selection-mode", "accuracy",
            "--weight-unet", "0.30", "--weight-wrong-label-unet", "0.75"]
ACC_BASE = 512
# the weights of an end-to-end epoch: (1 - weight_unet, weight_unet)
ACC_WEIGHTS = (0.7, 0.3)
ACC_QUERY_RUNS = 3
# the five image queries of accuracy_predictor_train.py (the accuracy mode
# with either --accuracy-selection) and the score each ranks by
ACC_QUERIES = ("accuracy_softmax", "accuracy_argmax", "uncertain", "gradient",
               "uncertain_gradient")


def accuracy_train_phase(torch, seed: int, root: Path):
    """The two-headed model at the scripts' geometry (the 512 letterbox,
    batch 5, 21 classes): the dual step on a device-resident batch in bf16
    then f32 (TF32 on), ms per step, peak memory, every loss finite and the
    total falling over the steps on that one batch, and a profile of one
    bf16 step; the dual eval step's segmentation and error confusions
    against host bincounts of the same predictions; an epoch of dual
    training through the port's Loader (images/s) and a validation with
    its error-head accuracy."""
    import accuracy_predictor_train_torch as driver
    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.engine.trainer import Trainer
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import make_schedule
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_dual_eval_step, make_dual_train_step)
    from deep_active_semantic_segmentation_torch.utils.class_weights import (
        calculate_weights_labels)

    cfg = driver.parse_args(ACC_ARGV + ["--dataset", "active_pascal_image",
                                        "--seed", str(seed), "--seed_set",
                                        "set_all.txt", "--epochs", "150"])
    _, train_loader, val_loader, _, nclass = make_dataloader(
        cfg.dataset, cfg.base_size, cfg.crop_size, cfg.batch_size,
        init_set=cfg.seed_set, dataset_root=str(root), seed=seed,
        rng=random.Random(seed), device=DEVICE)
    host_batch = next(iter(train_loader))
    cw = torch.as_tensor(calculate_weights_labels(train_loader, nclass),
                         dtype=torch.float32, device=DEVICE)
    unet_w = torch.tensor([cfg.weight_wrong_label_unet,
                           1 - cfg.weight_wrong_label_unet], device=DEVICE)
    batch = {k: torch.from_numpy(host_batch[k]).to(DEVICE) for k in ("image", "label")}
    B, side = cfg.batch_size, host_batch["image"].shape[1]
    check(tuple(host_batch["image"].shape) == (B, ACC_BASE, ACC_BASE, 3),
          f"letterboxed batch {host_batch['image'].shape}")
    out = {"batch": B, "side": side}
    for dtype in ("bfloat16", "float32"):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        model = build_model("accuracy_predictor", nclass, backbone="mobilenet",
                            device=DEVICE, generator=gen).train()
        opt = build_optimizer("SGD", param_groups(model, "accuracy_predictor"), cfg)
        step = make_dual_train_step(
            model, opt, build_loss("ce", class_weights=cw),
            build_loss("ce", class_weights=unet_w),
            make_schedule("step", cfg.lr, cfg.epochs, len(train_loader)),
            compute_dtype=dtype, generator=gen)
        metrics = [step(batch, i, *ACC_WEIGHTS) for i in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
            metrics.append(step(batch, i, *ACC_WEIGHTS))
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated()
        losses = {k: torch.stack([m[k] for m in metrics]).tolist()
                  for k in ("loss", "loss_dl", "loss_un")}
        print(f"dual train step {dtype}: {step_ms:.3f} ms per step of {B} at "
              f"{side}² ({B / step_ms * 1e3:.2f} images/s on a device-resident "
              f"batch), peak memory {peak / 2**30:.3f} GiB, loss "
              f"{losses['loss'][0]:.4f} -> {losses['loss'][-1]:.4f} (seg "
              f"{losses['loss_dl'][0]:.4f} -> {losses['loss_dl'][-1]:.4f}, error "
              f"{losses['loss_un'][0]:.4f} -> {losses['loss_un'][-1]:.4f})", flush=True)
        check(all(np.isfinite(v).all() for v in losses.values()),
              f"{dtype} dual losses finite")
        check(losses["loss"][-1] < losses["loss"][0],
              f"{dtype} dual loss falls over {len(metrics)} steps on one batch")
        out[dtype] = {"step_ms": step_ms, "images_per_s": B / step_ms * 1e3,
                      "peak_bytes": peak, "losses": losses}
        if dtype == "bfloat16":
            out["profile_bf16_step"] = profile_sweep(
                torch, lambda: step(batch, 0, *ACC_WEIGHTS), "one bf16 dual step")

    eval_step = make_dual_eval_step(
        model, nclass, build_loss("ce", class_weights=cw, batch_average=False),
        build_loss("ce", class_weights=unet_w, batch_average=False))
    ev = eval_step(batch, B, *ACC_WEIGHTS)
    for key, gt, pred, n in (("confusion", host_batch["label"], ev["pred"], nclass),
                             ("unet_confusion", ev["unet_target"], ev["err_pred"], 2)):
        gt = np.asarray(gt.cpu() if hasattr(gt, "cpu") else gt).astype(np.int64)
        pred = pred.cpu().numpy()
        valid = gt < n
        host = np.bincount(n * gt[valid] + pred[valid], minlength=n * n).reshape(n, n)
        check(np.array_equal(ev[key].cpu().numpy(), host),
              f"dual eval {key} equals a host bincount")
    eval_ms = cuda_ms(lambda: eval_step(batch, B, *ACC_WEIGHTS), 20)
    out["eval"] = {"step_ms": eval_ms, "images_per_s": B / eval_ms * 1e3}
    print(f"dual eval step: {eval_ms:.3f} ms per batch of {B} "
          f"({B / eval_ms * 1e3:.2f} images/s); both confusions exact", flush=True)

    trainer = Trainer(cfg, train_loader, val_loader, nclass, device=DEVICE,
                      dual_head=True, rng=random.Random(seed))
    trainer.initialize()
    epochs = []
    for epoch in range(2):   # the first one warms the pinned-memory pool
        t0 = time.perf_counter()
        trainer.training(epoch, *ACC_WEIGHTS)
        epochs.append(len(train_loader.pool) / (time.perf_counter() - t0))
    t0 = time.perf_counter()
    test_loss, miou = trainer.validation(1, *ACC_WEIGHTS)[:2]
    val_s = time.perf_counter() - t0
    unet_acc = trainer.unet_evaluator.Pixel_Accuracy()
    check(np.isfinite(test_loss) and 0 <= miou <= 1 and 0 <= unet_acc <= 1,
          f"dual validation: loss {test_loss}, mIoU {miou}, UNetAcc {unet_acc}")
    out.update(loader_epoch_images_per_s=epochs[-1], validation_s=val_s,
               val_unet_acc=unet_acc, val_miou=miou)
    print(f"dual train epoch through the Loader: {epochs[-1]:.2f} images/s "
          f"({len(train_loader.pool)} images, bf16, host geometry included); "
          f"validation {val_s:.3f} s, mIoU {miou:.4f}, UNetAcc {unet_acc:.4f}",
          flush=True)
    return out


def accuracy_card_vs_cpu_phase(torch, seed: int):
    """One f32 dual step at 65 px, batch 2, from the same weights on the
    card and on the CPU, TF32 off, dropout off, BN at running statistics:
    loss, loss_dl and loss_un within CPU_LOSS_RTOL; the updated parameters'
    largest difference within CPU_PARAM_RTOL of the largest weight (as
    ``card_vs_cpu_phase`` holds the one-headed step)."""
    import copy

    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import make_schedule
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_dual_train_step)
    from deep_active_semantic_segmentation_torch.selection.kernels import (
        _deterministic_precision)

    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (2, 65, 65, 3), dtype=np.uint8)
    label = rng.randint(0, PASCAL_CLASSES, (2, 65, 65)).astype(np.uint8)
    label[:, :6] = 255
    cw = rng.uniform(0.5, 2.0, PASCAL_CLASSES).astype(np.float32)
    cpu_model = build_model("accuracy_predictor", PASCAL_CLASSES, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    models = {"cpu": cpu_model, DEVICE: copy.deepcopy(cpu_model).to(DEVICE)}
    metrics = {}
    with _deterministic_precision():
        for dev, model in models.items():
            freeze_bn(model)
            opt = build_optimizer("SGD", param_groups(model, "accuracy_predictor"))
            step = make_dual_train_step(
                model, opt, build_loss("ce", class_weights=torch.from_numpy(cw).to(dev)),
                build_loss("ce", class_weights=torch.tensor([0.75, 0.25], device=dev)),
                make_schedule("step", 0.007, 150, 4))
            out = step({"image": torch.from_numpy(image).to(dev),
                        "label": torch.from_numpy(label).to(dev)}, 0, *ACC_WEIGHTS)
            metrics[dev] = {k: float(out[k]) for k in ("loss", "loss_dl", "loss_un")}
    rel = {k: abs(metrics[DEVICE][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
           for k in metrics["cpu"]}
    card = dict(models[DEVICE].named_parameters())
    model_rel = max((card[n].detach().cpu() - p.detach()).abs().max().item()
                    for n, p in models["cpu"].named_parameters()) / max(
        p.detach().abs().max().item() for p in models["cpu"].parameters())
    print(f"card vs CPU, one f32 dual step at 65 px: {metrics[DEVICE]} vs "
          f"{metrics['cpu']} (rel {json.dumps(rel)}, bar {CPU_LOSS_RTOL}); parameters: "
          f"largest difference {model_rel:.2e} of the largest weight (bar "
          f"{CPU_PARAM_RTOL})", flush=True)
    check(max(rel.values()) <= CPU_LOSS_RTOL, "card and CPU dual step losses agree")
    check(model_rel <= CPU_PARAM_RTOL, "card and CPU dual step parameters agree")
    return {"card": metrics[DEVICE], "cpu": metrics["cpu"], "loss_rel": rel,
            "model_rel": model_rel}


def accuracy_driver_phase(torch, seed: int, root: Path):
    """One 2-round ``accuracy_predictor_train_torch.main`` on
    active_pascal_image and one on active_pascal_region (region 129), the
    launch counts set to 0 just before each and read just after: no B1 or
    B2 launch; selections 10 then 15 images, or the seed images' whole
    512² boxes then new 129² boxes; round 0's best.ckpt reloads bit for
    bit; the image run's pick is the top 5 of the pool's P(wrong) sums
    re-scored on that checkpoint."""
    import accuracy_predictor_train_torch as driver
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection import ActiveSelectionAccuracy
    from deep_active_semantic_segmentation_torch.selection.base import rank_descending
    from deep_active_semantic_segmentation_torch.utils.checkpoint import load_checkpoint

    out = {}
    requested = math.ceil(5 * ACC_BASE ** 2 / REGION ** 2)
    for dataset in ("active_pascal_image", "active_pascal_region"):
        argv = ACC_ARGV + ["--dataset", dataset, "--seed", str(seed),
                           "--checkname", "acc", "--active-region-size", str(REGION)]
        reset_counts()
        t0 = time.perf_counter()
        history = driver.main(argv, device=DEVICE, dataset_root=str(root),
                              runs_root=str(root / "runs"))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        exp = root / "runs" / dataset / "acc"
        sel = list(read_selections(exp).values())
        print(f"accuracy_predictor_train_torch on {dataset}: {wall_s:.3f} s for 2 "
              f"rounds; selections {[len(r) for r in sel]} images, "
              f"{[sum(len(b) for _, b in r) for r in sel]} boxes; launches "
              f"{json.dumps(counts)}; best mIoU {[h['mIoU'] for h in history.values()]}",
              flush=True)
        check(all(n == 0 for n in counts.values()),
              f"no B1 or B2 launch in the accuracy-predictor driver: {counts}")
        check(len(sel) == 2 and len(sel[0]) == SEED_SET
              and [p for p, _ in sel[1][:SEED_SET]] == [p for p, _ in sel[0]],
              "round 1 keeps round 0's labeled images first")
        if dataset.endswith("_image"):
            check(len(sel[1]) == SEED_SET + 5, "the image round picked 5 images")
        else:
            new = sum(len(b) for _, b in sel[1]) - sum(len(b) for _, b in sel[0])
            check(sel[0] == [(p, [(0, 0, ACC_BASE, ACC_BASE)]) for p, _ in sel[0]]
                  and 1 <= new <= requested
                  and all(b[2:] == (REGION, REGION) for _, boxes in sel[1]
                          for b in boxes if b != (0, 0, ACC_BASE, ACC_BASE)),
                  f"region round: seed boxes whole, {new} new 129² boxes of {requested}")

        ckpt = sorted(exp.glob("run_*"))[0] / "best.ckpt"
        model = build_model("accuracy_predictor", PASCAL_CLASSES, device=DEVICE)
        payload = load_checkpoint(str(ckpt), model, device=DEVICE)
        on_file = torch.load(str(ckpt), map_location="cpu", weights_only=True)["state_dict"]
        check(all(torch.equal(model.state_dict()[k].cpu(), v) for k, v in on_file.items())
              and payload["state_dict"].keys() == model.state_dict().keys(),
              f"{dataset}: best.ckpt reloads to the same tensors bit for bit")
        out[dataset] = {"wall_s": wall_s, "counts": counts, "history": history,
                        "selections": [len(r) for r in sel], "checkpoint": str(ckpt)}
        if dataset.endswith("_image"):
            store = DirectoryStore(str(root / "pascal" / "train"))
            labeled = {p for p, _ in sel[0]}
            remaining = [p for p in store.keys() if p.decode() not in labeled]
            scores, _ = error_head_pass(
                torch, model, ActiveSelectionAccuracy(
                    PASCAL_CLASSES, store, -1, 5, device=DEVICE), remaining)
            check([p.decode() for p in rank_descending(scores["softmax"], remaining, 5)]
                  == [p for p, _ in sel[1][SEED_SET:]],
                  "the image round picked the top 5 of its re-scored P(wrong) sums")
    return out


def error_head_pass(torch, model, selector, paths):
    """A re-score of ``paths`` through ``selector``'s loader, TF32 off: one
    forward per batch gives each image's softmax (summed P(wrong)), argmax
    (predicted-wrong count) and unsure (mean 4p - 4p^2) scores and the
    batch's P(wrong) maps (pad rows included, as the region pipeline takes
    them), in the selectors' formulas; the input-gradient norms through
    ``kernels.input_gradient_norms``. Returns ({score: [per image]}, [maps
    per batch])."""
    from deep_active_semantic_segmentation_torch.ops.entropy import unpack_mask
    from deep_active_semantic_segmentation_torch.selection import kernels

    model = model.eval()
    scores = {m: [] for m in ("softmax", "argmax", "unsure", "gradient")}
    maps = []
    for batch in selector._paths_loader(paths, include_labels=True,
                                        labels_as_mask=PASCAL_CLASSES):
        n, images, packed = batch["nvalid"], batch["image"], batch["label"]
        with torch.inference_mode(), kernels._deterministic_precision():
            _, err = model(kernels.normalize_on_device(images))
            valid = unpack_mask(packed, images.shape[2])
            prob = torch.softmax(err, dim=1)
            p_wrong = torch.where(valid, prob[:, 0], 0.0)
            wrong = torch.where(valid, 1.0 - err.argmax(dim=1).to(torch.float32), 0.0)
            p = prob[:, 1]
            unsure = (torch.where(valid, 4.0 * p - 4.0 * p * p, 0.0).sum(dim=(1, 2))
                      / valid.sum(dim=(1, 2)).clamp_min(1))
        for name, v in (("softmax", p_wrong.sum(dim=(1, 2))),
                        ("argmax", wrong.sum(dim=(1, 2))), ("unsure", unsure),
                        ("gradient", kernels.input_gradient_norms(
                            model, images, packed, PASCAL_CLASSES,
                            labels_packed=True))):
            scores[name] += v[:n].tolist()
        maps.append(p_wrong)
    return scores, maps


def accuracy_picks(scores, paths, k: int = 5):
    """Each query's picks derived from ``error_head_pass`` scores, as the
    selectors rank (stable descending); ``uncertain_2k`` is the first
    stage of ``uncertain_gradient``."""
    from deep_active_semantic_segmentation_torch.selection.base import rank_descending

    picks = {name: rank_descending(scores[score], paths, k) for name, score in (
        ("accuracy_softmax", "softmax"), ("accuracy_argmax", "argmax"),
        ("uncertain", "unsure"), ("gradient", "gradient"))}
    picks["uncertain_2k"] = rank_descending(scores["unsure"], paths, 2 * k)
    index = {p: i for i, p in enumerate(paths)}
    picks["uncertain_gradient"] = rank_descending(
        [scores["gradient"][index[p]] for p in picks["uncertain_2k"]],
        picks["uncertain_2k"], k)
    return picks


@contextlib.contextmanager
def conv_settings(torch, tf32: bool, cudnn: bool):
    """cuDNN / matmul TF32 and cuDNN itself set for a ``with`` block, then
    restored."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.enabled)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = tf32
    b.cudnn.enabled = cudnn
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.enabled = saved


def conv_settings_phase(torch, kernels, score_args):
    """One batch's error-head forward (``error_head_scores``) and input
    gradient, in device ms (CUDA events, after a warm call) and peak memory
    above the start: as the port runs them (TF32 off, cuDNN's own
    algorithm choice), then with TF32 on, then with TF32 off and cuDNN off
    (PyTorch's own convolution), the scorers' precision scope swapped for
    the measurement and restored after it."""
    b = torch.backends
    flags = lambda: (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.enabled)
    before, saved = flags(), kernels._deterministic_precision
    settings = {"port (TF32 off)": (False, True), "TF32 on": (True, True),
                "TF32 off, cuDNN off": (False, False)}
    out = {}
    try:
        for label, (tf32, cudnn) in settings.items():
            kernels._deterministic_precision = (
                lambda tf32=tf32, cudnn=cudnn: conv_settings(torch, tf32, cudnn))
            for name, fn in (("error_head_scores", lambda: kernels.error_head_scores(
                                 *score_args, "softmax", labels_packed=True)),
                             ("input_gradient_norms", lambda: kernels.input_gradient_norms(
                                 *score_args, labels_packed=True))):
                fn()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                fn()
                end.record()
                end.synchronize()
                out[f"{name}, {label}"] = {
                    "ms": start.elapsed_time(end),
                    "peak_bytes": torch.cuda.max_memory_allocated() - base}
    finally:
        kernels._deterministic_precision = saved
    check(flags() == before, "conv settings restored")
    for key, v in out.items():
        print(f"one batch of {score_args[1].shape[0]}, {key}: {v['ms']:.3f} ms, peak "
              f"{v['peak_bytes'] / 2**30:.3f} GiB above the start", flush=True)
    return out


def accuracy_query_phase(torch, seed: int, root: Path, ckpt: str):
    """The accuracy predictor's queries through the selector a user calls,
    on the driver phase's round 0 best.ckpt, over the Pascal phase's 20
    records at the 512 letterbox: ``accuracy`` (softmax and argmax),
    ``uncertain``, ``gradient`` and ``uncertain_gradient`` on images, each
    timed ACC_QUERY_RUNS times (images/s, median), and the ``accuracy``
    region maps (region 129, the first 10 images labeled), each run with
    the launch counts set to 0 just before and read just after (no B1 or
    B2); the gradient query's peak memory. Checks: the same picks every
    run; finite scores; every pick equal to a re-score's on the card; the
    card's picks and boxes equal to the CPU's on the same weights (TF32
    off on both), where a differing pick must be a near-tie (the two
    images' CPU scores within GREEDY_SCORE_RTOL), printed."""
    import copy

    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.ops import region as region_ops
    from deep_active_semantic_segmentation_torch.selection import (
        ActiveSelectionAccuracy, ModelBundle)
    from deep_active_semantic_segmentation_torch.selection.region_pipeline import (
        region_score_maps)
    from deep_active_semantic_segmentation_torch.utils.checkpoint import load_checkpoint

    store = DirectoryStore(str(root / "pascal" / "train"))
    paths = list(store.keys())
    model = build_model("accuracy_predictor", PASCAL_CLASSES, device=DEVICE)
    load_checkpoint(ckpt, model, device=DEVICE)
    bundle = ModelBundle(model, torch.device(DEVICE))
    sel = ActiveSelectionAccuracy(PASCAL_CLASSES, store, -1, 5, device=DEVICE)
    k = 5
    queries = {
        "accuracy_softmax": lambda: sel.get_least_accurate_samples(bundle, paths, k),
        "accuracy_argmax": lambda: sel.get_least_accurate_samples(bundle, paths, k,
                                                                  "argmax"),
        "uncertain": lambda: sel.get_unsure_samples(bundle, paths, k),
        "gradient": lambda: sel.get_adversarially_vulnarable_samples(bundle, paths, k),
        "uncertain_gradient": lambda: sel.get_adversarially_vulnarable_samples(
            bundle, sel.get_unsure_samples(bundle, paths, 2 * k), k),
    }
    existing = [[(0, 0, ACC_BASE, ACC_BASE)] if i < SEED_SET else []
                for i in range(len(paths))]
    queries["accuracy_region"] = lambda: sel.get_least_accurate_region_maps(
        bundle, paths, existing, REGION, k)
    out = {}
    for name, query in queries.items():
        query()   # warm: cuDNN's algorithm choice, the pinned-memory pool
        runs, picks, counts = [], [], []
        for r in range(ACC_QUERY_RUNS):
            torch.cuda.synchronize()
            if name == "gradient" and r == 0:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            picks.append(query())
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            counts.append(read_counts())
        rate = [len(paths) / t for t in runs]
        out[name] = {"query_s": runs, "images_per_s": float(np.median(rate)),
                     "counts": counts[0], "picks": picks[0]}
        if name == "gradient":
            out[name]["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(f"{name} query: {len(paths)} images, median {np.median(rate):.2f} "
              f"images/s (runs {[round(x, 2) for x in rate]}); launches "
              f"{json.dumps(counts[0])}"
              + (f"; peak memory {out[name]['peak_bytes'] / 2**30:.3f} GiB"
                 if name == "gradient" else ""), flush=True)
        check(all(all(n == 0 for n in c.values()) for c in counts),
              f"no B1 or B2 launch in the {name} query: {counts}")
        check(all(p == picks[0] for p in picks), f"{name}: the same picks every run")

    # the device side of one batch: the error head's forward (what the
    # softmax / argmax / unsure / region queries run) and the input
    # gradient, profiled; the gradient's peak memory alone
    from deep_active_semantic_segmentation_torch.selection import kernels

    batch = next(iter(sel._paths_loader(paths[:k], include_labels=True,
                                        labels_as_mask=PASCAL_CLASSES)))
    score_args = (model, batch["image"], batch["label"], PASCAL_CLASSES)
    out["profile_error_head_batch"] = profile_sweep(
        torch, lambda: kernels.error_head_scores(*score_args, "softmax",
                                                 labels_packed=True),
        "one batch's error-head scores (TF32 off)")
    out["profile_input_gradient_batch"] = profile_sweep(
        torch, lambda: kernels.input_gradient_norms(*score_args, labels_packed=True),
        "one batch's input-gradient norms (TF32 off)")
    out["conv_settings"] = conv_settings_phase(torch, kernels, score_args)

    card_scores, card_maps = error_head_pass(torch, model, sel, paths)
    check(all(np.isfinite(v).all() and len(v) == len(paths)
              for v in card_scores.values()), "accuracy scores finite")
    card = accuracy_picks(card_scores, paths, k)
    for name in ACC_QUERIES:
        check(card[name] == out[name]["picks"],
              f"{name}: the query's picks equal a re-score's")
    def normalized(selector, maps):
        return region_score_maps(lambda b, it=iter(maps): next(it),
                                 selector._paths_loader(paths, include_labels=True,
                                                        labels_as_mask=PASCAL_CLASSES),
                                 existing, REGION)

    def ordered_boxes(norm):
        """The NMS's (image, r, c) boxes in pick order, ``norm`` kept."""
        boxes, n = region_ops.square_nms_device(norm.clone(), REGION, requested)
        return [tuple(b) for b in boxes[:int(n)].tolist()]

    requested = math.ceil(k * ACC_BASE ** 2 / REGION ** 2)
    card_norm = normalized(sel, card_maps)
    card_boxes = ordered_boxes(card_norm)
    (dev, dev_count), (host, host_count), _ = nms_device_vs_host(
        torch, card_norm, REGION, requested)
    regions, count = out["accuracy_region"]["picks"]
    check(dev == host and region_ops.regions_to_dict(paths, dev) == regions
          and dev_count == count == len(card_boxes),
          "accuracy regions: the query's boxes equal the re-scored device and host "
          "NMS's")

    # the CPU on the same weights
    cpu_model = copy.deepcopy(model).cpu()
    cpu_sel = ActiveSelectionAccuracy(PASCAL_CLASSES, store, -1, 5, device="cpu")
    t0 = time.perf_counter()
    cpu_scores, cpu_maps = error_head_pass(torch, cpu_model, cpu_sel, paths)
    cpu_s = time.perf_counter() - t0
    cpu = accuracy_picks(cpu_scores, paths, k)
    index = {p: i for i, p in enumerate(paths)}
    near = {}
    for name, score in (("accuracy_softmax", "softmax"), ("accuracy_argmax", "argmax"),
                        ("uncertain", "unsure"), ("gradient", "gradient"),
                        ("uncertain_2k", "unsure"), ("uncertain_gradient", "gradient")):
        i = next((j for j, (a, b) in enumerate(zip(card[name], cpu[name])) if a != b),
                 None)
        if i is None:
            continue
        a, b = (cpu_scores[score][index[p]] for p in (card[name][i], cpu[name][i]))
        near[name] = {"position": i, "scores": [a, b]}
        print(f"{name}: pick {i} differs between the card and the CPU; CPU scores "
              f"{a!r} / {b!r}", flush=True)
        check(abs(a - b) <= GREEDY_SCORE_RTOL * max(abs(a), abs(b)),
              f"{name}: a pick that differs from the CPU's is a near-tie")
    cpu_norm = normalized(cpu_sel, cpu_maps)
    cpu_boxes = ordered_boxes(cpu_norm)
    i = next((j for j, (a, b) in enumerate(zip(card_boxes, cpu_boxes)) if a != b),
             None)
    if i is None and len(card_boxes) != len(cpu_boxes):
        i = min(len(card_boxes), len(cpu_boxes))
    if i is not None:
        # the CPU's normalized box sums at the two boxes; past the shorter
        # list, the 0.01 stop decided, so the other list's box sits there
        vals = [float(cpu_norm[b[i]]) if i < len(b) else 0.01
                for b in (card_boxes, cpu_boxes)]
        near["accuracy_region"] = {"position": i, "scores": vals}
        print(f"accuracy regions: box {i} differs between the card and the CPU; CPU "
              f"normalized box sums {vals}", flush=True)
        check(abs(vals[0] - vals[1]) <= GREEDY_SCORE_RTOL * max(map(abs, vals)),
              "accuracy regions: a box that differs from the CPU's is a near-tie")
    gaps = {m: float(np.max(np.abs(np.subtract(card_scores[m], cpu_scores[m]))
                            / np.maximum(np.abs(cpu_scores[m]), 1e-30)))
            for m in card_scores}
    print(f"accuracy queries, card vs CPU (TF32 off): largest relative score gap "
          f"{json.dumps(gaps)}; picks equal "
          f"{[n for n in ACC_QUERIES if card[n] == cpu[n]]}; boxes equal "
          f"{card_boxes == cpu_boxes}; near-ties {json.dumps(near)}; CPU pass {cpu_s:.3f} s",
          flush=True)
    for name in queries:
        out[name].pop("picks")
    out["card_vs_cpu"] = {"score_rel": gaps, "near_ties": near, "cpu_s": cpu_s,
                          "boxes": dev_count}
    return out



# ------------------------------------------- slice 8: train.py and the zoo

# train.py's passive run at full width (the JAX package's train.py): the
# CLI's default backbone (ResNet-50, os16), 19 classes, crop 513, batch 4
# (the automatic batch on one card), SGD poly at lr 0.01, over PASSIVE_TRAIN
# train and PASSIVE_VAL val records
PASSIVE_CROP = 513
PASSIVE_ARGV = ["--dataset", "cityscapes", "--base-size", str(PASSIVE_CROP),
                "--crop-size", str(PASSIVE_CROP), "--batch-size", "4", "--lr", "0.01",
                "--use-lr-scheduler", "--eval-interval", "1", "--epochs", "2",
                "--workers", "0"]
PASSIVE_TRAIN, PASSIVE_VAL = 12, 4
# the zoo's train steps at full width: name -> (flags, crop). ENet halves
# its input three times and unpools it back, and FastSCNN adds a 1/8 map to
# a 4x-upsampled 1/32 one, so both need a crop that 8 (FastSCNN: 32)
# divides: 512, as the JAX package runs ENet
ZOO = {"deeplab_resnet50": (["--backbone", "resnet"], 513),
       "enet": (["--architecture", "enet", "--optimizer", "Adam", "--lr", "5e-4"], 512),
       "fastscnn": (["--architecture", "fastscnn"], 512)}
# the ENet-headed accuracy predictor's dual step at Pascal's 512 letterbox
ENET_DUAL_BATCH = 5


def timed_steps(torch, step, batch, *args):
    """TRAIN_WARMUP, then TRAIN_STEPS timed calls of ``step(batch, i,
    *args)`` on one device-resident batch: (device ms per step, peak bytes
    over the timed calls, every call's result)."""
    outs = [step(batch, i, *args) for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        outs.append(step(batch, i, *args))
    end.record()
    end.synchronize()
    return (start.elapsed_time(end) / TRAIN_STEPS,
            torch.cuda.max_memory_allocated(), outs)


def write_passive_dataset(root: Path, seed: int):
    """train.py's layout: ``root/cityscapes/{train,val}`` with PASSIVE_TRAIN
    and PASSIVE_VAL Cityscapes-sized records."""
    store, paths = write_store(root / "cityscapes" / "train", seed + 10,
                               n=PASSIVE_TRAIN)
    write_store(root / "cityscapes" / "val", seed + 11, n=PASSIVE_VAL, split="val")
    return store, paths


@contextlib.contextmanager
def pil_resizes():
    """The transforms' native resizes replaced by their plain version (the
    PIL call) for the length of a ``with`` block: the host geometry as it
    ran before the native resampler, on the same records."""
    from deep_active_semantic_segmentation_torch.data import transforms as tr

    saved = tr.imresize, tr.imresize_crop
    tr.imresize = tr.imresize_plain
    tr.imresize_crop = (lambda a, oh, ow, x1, y1, crop, interp="bilinear":
                        tr.imresize_plain(a, (oh, ow), interp)[y1:y1 + crop, x1:x1 + crop])
    try:
        yield
    finally:
        tr.imresize, tr.imresize_crop = saved


def native_phase(torch, seed: int, store, paths):
    """The native resampler on the Cityscapes-sized records: its bilinear
    and nearest resizes, and FixScaleCrop's crop-window form, byte-equal
    to PIL's; the host geometry of one train batch (crop 513, batch 4)
    natively on one thread and on every core, and through PIL (one
    thread); then, in turns (PIL, native, native, PIL), the passive train
    Loader's epoch (flips and blurs included) on the host and the
    canonical DeepLab-MobileNetV2 dropout query over the 20 records."""
    from deep_active_semantic_segmentation_torch.data import native, pools
    from deep_active_semantic_segmentation_torch.data import transforms as tr
    from deep_active_semantic_segmentation_torch.data.loader import Loader
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)

    records = [np.asarray(store.get(p)) for p in paths[:4]]
    for rec in records[:2]:
        img, lab = rec[..., :3], rec[..., 3]
        for size in ((513, 1026), (256, 512), (1100, 2200)):
            check(np.array_equal(tr.imresize(img, size), tr.imresize_plain(img, size)),
                  f"bilinear resize to {size} equals PIL")
            check(np.array_equal(tr.imresize(lab, size, "nearest"),
                                 tr.imresize_plain(lab, size, "nearest")),
                  f"nearest resize to {size} equals PIL")
        out = tr.FixScaleCrop(513)({"image": img, "label": lab})
        x1, y1 = tr._center_crop_origin(513, 1026, 513)
        check(np.array_equal(out["image"], tr.imresize_plain(img, (513, 1026))
                             [y1:y1 + 513, x1:x1 + 513]),
              "FixScaleCrop's window equals PIL's resize then crop")
        check(np.array_equal(out["label"], tr.imresize_plain(lab, (513, 1026), "nearest")
                             [y1:y1 + 513, x1:x1 + 513]),
              "FixScaleCrop's label window equals PIL's")

    def geometry(resize_crop):
        t0 = time.perf_counter()
        for rec in records:
            resize_crop(rec[..., :3], "bilinear")
            resize_crop(rec[..., 3], "nearest")
        return time.perf_counter() - t0

    x1, y1 = tr._center_crop_origin(513, 1026, 513)

    def plain(a, interp):
        return tr.imresize_plain(a, (513, 1026), interp)[y1:y1 + 513, x1:x1 + 513]

    def fused(a, interp):
        return tr.imresize_crop(a, 513, 1026, x1, y1, 513, interp)

    saved = native.get_num_threads()
    try:
        native.set_num_threads(1)
        geometry(fused)
        times = {"native_one_thread_s": min(geometry(fused) for _ in range(3)),
                 "pil_one_thread_s": min(geometry(plain) for _ in range(3))}
        native.set_num_threads(None)
        geometry(fused)
        times["native_all_threads_s"] = min(geometry(fused) for _ in range(3))
    finally:
        native.set_num_threads(saved)
    print(f"host geometry of one batch of 4 at crop 513 (1024x2048 records, image "
          f"and label): native {times['native_one_thread_s']:.4f} s on one thread, "
          f"PIL {times['pil_one_thread_s']:.4f} s on one thread "
          f"({times['pil_one_thread_s'] / times['native_one_thread_s']:.2f}x), native "
          f"{times['native_all_threads_s']:.4f} s on every core", flush=True)
    check(times["native_one_thread_s"] < times["pil_one_thread_s"],
          "the native geometry is faster than PIL's on one thread")

    pool = pools.PassivePool(pools.CITYSCAPES, store, 513, 513, "train",
                             rng=random.Random(seed))
    loader = Loader(pool, 4, shuffle=True, seed=seed, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    bundle = ModelBundle(build_model("deeplab", NUM_CLASSES, mc_dropout=True,
                                     device=DEVICE, generator=gen), torch.device(DEVICE))
    sel = get_active_selection_class("variance", NUM_CLASSES, store, 513, 5,
                                     device=DEVICE)
    sum(b["nvalid"] for b in loader)   # warms the page cache
    sel.get_vote_entropy_for_images(bundle, paths[:5], 1, seed=1)
    turns = {"native": {"loader": [], "query": [], "top": []},
             "pil": {"loader": [], "query": [], "top": []}}
    for how in ("pil", "native", "native", "pil"):
        with pil_resizes() if how == "pil" else contextlib.nullcontext():
            t0 = time.perf_counter()
            n = sum(b["nvalid"] for b in loader)
            turns[how]["loader"].append(n / (time.perf_counter() - t0))
            t0 = time.perf_counter()
            top = sel.get_vote_entropy_for_images(bundle, paths, 5, seed=0)
            torch.cuda.synchronize()
            turns[how]["query"].append(len(paths) / (time.perf_counter() - t0))
            turns[how]["top"].append(top)
    check(all(t == turns["native"]["top"][0] for how in turns for t in turns[how]["top"]),
          "the query picks the same with either resampler")
    t0 = time.perf_counter()
    n = sum(b["nvalid"] for b in loader.device_batches())
    torch.cuda.synchronize()
    onto_card = n / (time.perf_counter() - t0)
    result = {**times, "loader_onto_card_images_per_s": onto_card}
    for how in turns:
        result[f"loader_epoch_images_per_s_{how}"] = turns[how]["loader"]
        result[f"mobilenet_query_images_per_s_{how}"] = turns[how]["query"]
    print(f"passive train Loader epoch at crop 513, batch 4 ({len(pool)} records, "
          f"flips and blurs), images/s on the host: native "
          f"{turns['native']['loader']}, PIL {turns['pil']['loader']}; onto the "
          f"card (native) {onto_card:.2f}. DeepLab-MobileNetV2 dropout query "
          f"(20 images, batch 5), images/s: native {turns['native']['query']}, "
          f"PIL {turns['pil']['query']}", flush=True)
    return result


def zoo_train_phase(torch, seed: int, root: Path, name: str):
    """ZOO[name]'s train step at full width on a device-resident batch from
    the passive Loader, in bf16 then f32 (TF32 on): ms per step, peak
    memory, every loss finite and falling over the steps on that one
    batch; the eval step's confusion against a host bincount."""
    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import make_schedule
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_eval_step, make_train_step)

    flags, crop = ZOO[name]
    cfg = parse_cli(PASSIVE_ARGV + flags + ["--crop-size", str(crop), "--base-size",
                                            str(crop), "--seed", str(seed),
                                            "--epochs", "200"]).finalize()
    _, train_loader, _, _, nclass = make_dataloader(
        cfg.dataset, cfg.base_size, cfg.crop_size, cfg.batch_size,
        dataset_root=str(root), seed=seed, rng=random.Random(seed), device=DEVICE)
    t0 = time.perf_counter()
    host_batch = next(iter(train_loader))
    host_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(host_batch[k]).to(DEVICE) for k in ("image", "label")}
    B = cfg.batch_size
    out = {"arch": cfg.architecture, "backbone": cfg.backbone, "crop": crop,
           "batch": B, "optimizer": cfg.optimizer, "lr": cfg.lr,
           "host_geometry_s_per_batch": host_s}
    for dtype in ("bfloat16", "float32"):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        model = build_model(cfg.architecture, nclass, backbone=cfg.backbone,
                            device=DEVICE, generator=gen).train()
        opt = build_optimizer(cfg.optimizer, param_groups(model, cfg.architecture), cfg)
        step = make_train_step(model, opt, build_loss("ce"),
                               make_schedule("poly", cfg.lr, cfg.epochs,
                                             len(train_loader)),
                               compute_dtype=dtype, generator=gen)
        step_ms, peak, outs = timed_steps(torch, step, batch)
        losses = torch.stack([o["loss"] for o in outs]).tolist()
        print(f"{name} train step {dtype}: {step_ms:.3f} ms per step of {B} at "
              f"{crop}² ({B / step_ms * 1e3:.2f} images/s on a device-resident "
              f"batch), peak memory {peak / 2**30:.3f} GiB, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
        check(bool(np.isfinite(losses).all()), f"{name} {dtype} losses finite")
        check(losses[-1] < losses[0], f"{name} {dtype} loss falls over "
                                      f"{len(losses)} steps on one batch")
        out[dtype] = {"step_ms": step_ms, "images_per_s": B / step_ms * 1e3,
                      "peak_bytes": peak, "losses": losses}
    ev = make_eval_step(model, nclass, build_loss("ce", batch_average=False))(batch, B)
    pred, lab = ev["pred"].cpu().numpy(), host_batch["label"].astype(np.int64)
    valid = lab < nclass
    host = np.bincount(nclass * lab[valid] + pred[valid],
                       minlength=nclass * nclass).reshape(nclass, nclass)
    check(np.array_equal(ev["confusion"].cpu().numpy(), host),
          f"{name} eval confusion equals a host bincount")
    return out


def train_main_phase(torch, seed: int, root: Path):
    """``train_torch.main`` with train.py's flags (the default ResNet-50
    DeepLab) over the passive dataset, twice, then a resume of
    experiment_0 to 3 epochs: experiment_0..2, best_pred.txt (the best
    mIoU, then its epoch) per run, model_best.ckpt holding the best of the
    runs (each run that beat every earlier run's best promoted its
    checkpoint), the resume starting at its checkpoint's epoch with its
    best mIoU, and one train grid per epoch."""
    import contextlib
    import io

    import train_torch
    from deep_active_semantic_segmentation_torch.utils.summaries import (
        TensorboardSummary)

    runs = root / "passive_runs"
    exp = runs / "cityscapes" / "passive"
    grids = []
    original = TensorboardSummary.visualize_image

    def counting(self, writer, dataset, image, target, output, step, prefix="val"):
        grids.append((prefix, step, tuple(image.shape)))
        return original(self, writer, dataset, image, target, output, step, prefix)

    argv = PASSIVE_ARGV + ["--seed", str(seed), "--checkname", "passive"]
    resume = exp / "experiment_0" / "checkpoint.ckpt"
    runs_out = []
    TensorboardSummary.visualize_image = counting
    try:
        for i, extra in enumerate(([], [], ["--epochs", "3", "--resume-checkpoint",
                                            str(resume)])):
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                trainer = train_torch.main(argv + extra, dataset_root=str(root),
                                           runs_root=str(runs), device=DEVICE)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            start = int(text.getvalue().split("Starting Epoch:")[1].split()[0])
            runs_out.append({"wall_s": wall_s, "start_epoch": start,
                             "best_pred": trainer.best_pred, "steps": trainer.step})
            print(f"train_torch.main run {i}: {wall_s:.3f} s, start epoch {start}, "
                  f"best mIoU {trainer.best_pred:.6f}, {trainer.step} steps", flush=True)
    finally:
        TensorboardSummary.visualize_image = original
    dirs = sorted(d.name for d in exp.iterdir() if d.is_dir())
    check(dirs == ["experiment_0", "experiment_1", "experiment_2"],
          f"three experiment directories: {dirs}")
    payload = torch.load(str(resume), map_location="cpu", weights_only=True)
    check([r["start_epoch"] for r in runs_out] == [0, 0, payload["epoch"]] and
          payload["epoch"] == 2, "the resume starts at its checkpoint's epoch")
    check(runs_out[2]["best_pred"] >= runs_out[0]["best_pred"],
          "the resume carries its checkpoint's best mIoU on")
    bests = []
    for d, r in zip(dirs, runs_out):
        path = exp / d / "best_pred.txt"
        if not path.exists():
            check(d == "experiment_2" and r["best_pred"] == runs_out[0]["best_pred"],
                  f"{d} wrote best_pred.txt")
            continue
        value, epoch = path.read_text().split("\n")
        check(float(value) == r["best_pred"] and 1 <= int(epoch) <= 3,
              f"{d}/best_pred.txt holds the run's best and its epoch")
        bests.append(float(value))
    best = torch.load(str(exp / "model_best.ckpt"), map_location="cpu",
                      weights_only=True)
    check(best["best_pred"] == max(bests), "model_best.ckpt holds the best run's "
                                           "checkpoint")
    check([g[:2] for g in grids] == [("train", 0), ("train", 1)] * 2 + [("train", 2)]
          and all(g[2] == (4, PASSIVE_CROP, PASSIVE_CROP, 3) for g in grids),
          f"one train grid per epoch: {grids}")
    return {"runs": runs_out, "experiments": dirs, "model_best_pred": best["best_pred"],
            "grids": len(grids)}


def transplant_phase(torch, seed: int, root: Path):
    """A ResNet-50 ``state_dict`` (bare keys, with the ImageNet ``fc``) and
    a MobileNetV2 one (under ``state_dict``, with ``features.18`` and the
    classifier), seeded, written to the run's directory: after a
    Trainer's ``initialize()`` on the card, its backbone holds the file's
    tensors and the rest of the model equals a Trainer's without the file;
    the next ``initialize()`` (the next round's fresh model) transplants
    again."""
    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data.loader import Loader
    from deep_active_semantic_segmentation_torch.engine.trainer import Trainer
    from deep_active_semantic_segmentation_torch.models.backbone import build_backbone

    gen = torch.Generator().manual_seed(seed)
    files, out = {}, {}
    for backbone, name in (("resnet", "resnet50.pth"),
                           ("mobilenet", "mobilenet_v2.pth.tar")):
        sd = {k: (torch.rand(v.shape, generator=gen) + 0.5 if k.endswith("running_var")
                  else torch.randn(v.shape, generator=gen)
                  if v.is_floating_point() else v)
              for k, v in build_backbone(backbone, 16).state_dict().items()
              if not k.startswith(("low_level_features.", "high_level_features."))}
        if backbone == "resnet":
            sd.update({"fc.weight": torch.randn(1000, 2048, generator=gen),
                       "fc.bias": torch.zeros(1000)})
            torch.save(sd, root / name)
        else:
            sd.update({"features.18.0.weight": torch.randn(1280, 320, 1, 1,
                                                           generator=gen),
                       "classifier.1.weight": torch.randn(1000, 1280, generator=gen)})
            torch.save({"state_dict": sd}, root / name)
        files[backbone] = sd
        argv = PASSIVE_ARGV + ["--backbone", backbone, "--seed", str(seed),
                               "--pretrained-weights", str(root / name)]
        loaders = (Loader([], 4, device=DEVICE), Loader([], 4, device=DEVICE))
        trainers = [Trainer(parse_cli(a).finalize(), *loaders, NUM_CLASSES, device=DEVICE)
                    for a in (argv, argv + ["--no-pretrained"])]
        times = []
        for t in trainers:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.initialize()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        want = {k: v for k, v in sd.items()
                if not k.startswith(("fc.", "features.18.", "classifier."))}

        def holds_file(model):
            got = model.backbone.state_dict()
            return all(torch.equal(got[k].cpu(), v) for k, v in want.items()
                       if not k.endswith("num_batches_tracked"))

        with_file, without = (t.model for t in trainers)
        check(holds_file(with_file), f"{backbone}: the backbone holds the file's tensors")
        other = without.state_dict()
        check(all(torch.equal(v, other[k]) for k, v in with_file.state_dict().items()
                  if not k.startswith("backbone.")),
              f"{backbone}: the head is the random init, untouched")
        with torch.no_grad():
            for p in with_file.backbone.parameters():
                p.add_(1.0)
        t0 = time.perf_counter()
        trainers[0].initialize()
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t0
        check(holds_file(trainers[0].model),
              f"{backbone}: the next initialize() transplants again")
        out[backbone] = {"initialize_s": times[0], "initialize_without_s": times[1],
                         "initialize_again_s": again_s, "tensors": len(want)}
        print(f"transplant {backbone}: {len(want)} tensors; initialize() "
              f"{times[0]:.3f} s with the file (read once), {times[1]:.3f} s "
              f"without, {again_s:.3f} s the next round", flush=True)
    return out


def enet_dual_phase(torch, seed: int, root: Path):
    """The ENet-headed accuracy predictor's dual step at Pascal's 512
    letterbox (21 classes, batch 5) on a device-resident batch, bf16 then
    f32: ms per step, peak memory, losses finite and falling."""
    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import make_schedule
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_dual_train_step)

    _, train_loader, _, _, nclass = make_dataloader(
        "active_pascal_image", ACC_BASE, -1, ENET_DUAL_BATCH, init_set="set_all.txt",
        dataset_root=str(root), seed=seed, rng=random.Random(seed), device=DEVICE)
    host_batch = next(iter(train_loader))
    batch = {k: torch.from_numpy(host_batch[k]).to(DEVICE) for k in ("image", "label")}
    out = {"batch": ENET_DUAL_BATCH, "side": ACC_BASE}
    for dtype in ("bfloat16", "float32"):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        model = build_model("accuracy_predictor", nclass, device=DEVICE,
                            generator=gen, enet_head=True).train()
        check(model.deeplab.model_name == "enet", "the segmentation head is an ENet")
        opt = build_optimizer("SGD", param_groups(model, "accuracy_predictor"))
        step = make_dual_train_step(
            model, opt, build_loss("ce"),
            build_loss("ce", class_weights=torch.tensor([0.75, 0.25], device=DEVICE)),
            make_schedule("step", 0.007, 150, len(train_loader)),
            compute_dtype=dtype, generator=gen)
        step_ms, peak, outs = timed_steps(torch, step, batch, *ACC_WEIGHTS)
        losses = {k: torch.stack([o[k] for o in outs]).tolist()
                  for k in ("loss", "loss_dl", "loss_un")}
        print(f"ENet-headed dual step {dtype}: {step_ms:.3f} ms per step of "
              f"{ENET_DUAL_BATCH} at {ACC_BASE}² "
              f"({ENET_DUAL_BATCH / step_ms * 1e3:.2f} images/s), peak memory "
              f"{peak / 2**30:.3f} GiB, loss {losses['loss'][0]:.4f} -> "
              f"{losses['loss'][-1]:.4f}", flush=True)
        check(all(np.isfinite(v).all() for v in losses.values()),
              f"ENet-headed {dtype} dual losses finite")
        check(losses["loss"][-1] < losses["loss"][0],
              f"ENet-headed {dtype} dual loss falls on one batch")
        out[dtype] = {"step_ms": step_ms, "peak_bytes": peak,
                      "images_per_s": ENET_DUAL_BATCH / step_ms * 1e3,
                      "losses": losses}
    return out


# ------------------------------------------- slice 9: replay and the tools

# the SEM trainer's phase: unet_train.py's width (UNet(1, 2), crop 512,
# batch 2, RMSprop lr 0.001) over SEM_TRAIN + SEM_VAL synthetic grayscale
# PNGs of SEM_HW (short side above 512, so FixScaleCrop resizes), for
# SEM_EPOCHS epochs: 5, the first epoch that prints the validation line
SEM_HW, SEM_TRAIN, SEM_VAL, SEM_EPOCHS = (768, 1024), 8, 2, 5
SEM_CROP, SEM_BATCH, SEM_LR = 512, 2, 0.001
# the SEM UNet's card-vs-CPU gradient bar, as a share of the largest
# gradient: the f32 gradients measured 1.3e-6 apart (f64 4.1e-8), and a
# normalize 1 ulp off the host's put them 5.9e-4 apart
UNET_GRAD_RTOL = 1e-5
# the converter's phase: Cityscapes-sized leftImg8bit PNGs with gtFine
# labelIds, and VOC-sized JPEGs with SegmentationClassRaw PNGs
CONVERT_SPLITS = {"train": 6, "val": 2}
# the flags ACC_ARGV adds for accuracy_predictor_train.py alone
ACC_CLI_FLAGS = ("--active-selection-mode", "--weight-unet", "--weight-wrong-label-unet")


def replay_trainer(argv, root: Path, dual_head: bool = False):
    """The Trainer that visualize_torch / eval_series_torch build from
    ``argv`` (``engine.evaluation.eval_trainer`` on the card), so that
    ``evaluate_checkpoint`` is timed apart from the drivers."""
    from deep_active_semantic_segmentation_torch.config import (
        add_common_flags, config_from_args)
    from deep_active_semantic_segmentation_torch.engine.evaluation import eval_trainer

    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    cfg = config_from_args(parser.parse_known_args(argv)[0]).finalize(n_devices=1)
    return eval_trainer(cfg, str(root), DEVICE, dual_head=dual_head)


def same_metrics(a: dict, b: dict) -> bool:
    """Two evaluations' metrics agree: the same keys and epoch, the loss
    within 1e-6 relative (the card's loss reductions may add in another
    order), every confusion-derived metric within 1e-9."""
    return a.keys() == b.keys() and a["epoch"] == b["epoch"] and all(
        abs(a[k] - b[k]) <= (1e-6 * abs(b[k]) if k == "loss" else 1e-9)
        for k in b if k != "epoch")


def timed_evaluation(torch, trainer, ckpt: Path, vis_folder=None):
    """(metrics, seconds) of one ``evaluate_checkpoint``, the card
    synchronized at both ends."""
    from deep_active_semantic_segmentation_torch.engine.evaluation import (
        evaluate_checkpoint)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = evaluate_checkpoint(trainer, str(ckpt), vis_folder=vis_folder)
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def logged_miou(run_dir: Path) -> float:
    return float((run_dir / "best_pred.txt").read_text().split("\n")[0])


def visualize_phase(torch, seed: int, root: Path):
    """``visualize_torch.main`` on the AL-round phase's round 0 best.ckpt
    (DeepLab-v3+/MobileNetV2, os16, 19 classes, crop 513, batch 5, the 5
    val records of 1024x2048): the replayed mIoU equals the run's
    best_pred.txt to 1e-9, one img/tgt/prd PNG triple per val image; eval
    images/s over one more ``evaluate_checkpoint`` of that checkpoint on
    the driver's Trainer, after the driver's (checkpoint read and PNGs
    included), which gives the same metrics."""
    import visualize_torch

    run = sorted((root / "runs" / "active_cityscapes_image" / "round").glob("run_*"))[0]
    argv = ROUND_ARGV + ["--seed", str(seed), "--checkname", "round",
                         "--checkpoint", str(run / "best.ckpt")]
    t0 = time.perf_counter()
    m = visualize_torch.main(argv, dataset_root=str(root), device=DEVICE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    logged = logged_miou(run)
    pngs = sorted(p.name for p in (run / "visualizations").iterdir())
    again, eval_s = timed_evaluation(torch, replay_trainer(argv, root), run / "best.ckpt",
                                     vis_folder=str(run / "visualizations"))
    print(f"visualize_torch on {run.name}/best.ckpt: mIoU {m['mIoU']!r} vs logged "
          f"{logged!r}; {len(pngs)} PNGs; phase {wall_s:.3f} s; evaluate_checkpoint "
          f"again: eval {VAL / eval_s:.2f} images/s ({eval_s:.3f} s for {VAL} images, "
          f"PNGs included) on {card_line()}", flush=True)
    check(abs(m["mIoU"] - logged) <= 1e-9, "the replayed mIoU equals best_pred.txt")
    check(pngs == sorted(f"{kind}_0000_{i:02d}.png" for kind in ("img", "tgt", "prd")
                         for i in range(VAL)),
          f"one img/tgt/prd triple per val image: {pngs}")
    check(same_metrics(again, m), f"evaluate_checkpoint again gives the driver's "
          f"metrics: {again} vs {m}")
    return {"run": run.name, "metrics": m, "logged_miou": logged,
            "eval_s": eval_s, "eval_images_per_s": VAL / eval_s, "wall_s": wall_s}


def eval_series_phase(torch, seed: int, root: Path):
    """``eval_series_torch.main`` over the AL-round phase's run_* directories,
    then with ``--dual-head`` over the accuracy_predictor_train_torch
    active_pascal_image run (the 512 letterbox): every row's mIoU equals
    its best_pred.txt to 1e-9, validation_mIoUs.txt holds one row per
    round, the dual rows carry UNetAcc / UNetmIoU."""
    import eval_series_torch

    runs = root / "runs"
    acc_argv = [a for i, a in enumerate(ACC_ARGV) if a not in ACC_CLI_FLAGS
                and (i == 0 or ACC_ARGV[i - 1] not in ACC_CLI_FLAGS)]
    out = {}
    for name, dataset, argv in (
            ("image", "active_cityscapes_image",
             ROUND_ARGV + ["--seed", str(seed), "--checkname", "round"]),
            ("dual_head", "active_pascal_image",
             acc_argv + ["--dataset", "active_pascal_image", "--seed", str(seed),
                         "--checkname", "acc", "--dual-head"])):
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            series = eval_series_torch.main(argv, dataset_root=str(root),
                                            runs_root=str(runs), device=DEVICE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        exp = runs / dataset / ("round" if name == "image" else "acc")
        rows = (exp / "validation_mIoUs.txt").read_text().splitlines()
        print(text.getvalue(), end="", flush=True)
        trainer = replay_trainer(argv, root, dual_head=name == "dual_head")
        seconds = []
        for pct, m in series.items():
            again, s = timed_evaluation(torch, trainer, exp / f"run_{pct:04d}" / "best.ckpt")
            check(same_metrics(again, m), f"{name} run_{pct:04d}: evaluate_checkpoint "
                  f"again gives the series' metrics: {again} vs {m}")
            seconds.append(s)
        print(f"eval_series_torch ({name}): {len(series)} rounds in {wall_s:.3f} s "
              f"(evaluate_checkpoint again, per round: {[round(s, 3) for s in seconds]} s)",
              flush=True)
        check(len(rows) == len(series) == len(list(exp.glob("run_*"))) >= 1,
              f"{name}: validation_mIoUs.txt has one row per round")
        for pct, m in series.items():
            logged = logged_miou(exp / f"run_{pct:04d}")
            check(abs(m["mIoU"] - logged) <= 1e-9,
                  f"{name} run_{pct:04d}: mIoU {m['mIoU']!r} equals best_pred.txt {logged!r}")
            check(("UNetAcc" in m) == (name == "dual_head"),
                  f"{name}: UNet metrics only on the dual head")
        check(all(r.startswith("run_") and " mIoU:" in r for r in rows),
              f"{name}: the rows' format")
        out[name] = {"series": series, "evaluation_s": seconds, "wall_s": wall_s}
    return out


def write_sem(root: Path, seed: int, hw=SEM_HW, counts=(SEM_TRAIN, SEM_VAL)):
    """``root/sem/{train,val}/{images,masks}``: ``counts`` grayscale PNGs
    of ``hw`` (a multiple of 32) from ``seed`` (smoothed noise) with
    blocky 0/255 masks."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for split, n in zip(("train", "val"), counts):
        for sub in ("images", "masks"):
            (root / "sem" / split / sub).mkdir(parents=True)
        for i in range(n):
            img = np.kron(rng.randint(0, 256, (hw[0] // 8, hw[1] // 8)),
                          np.ones((8, 8), np.int64))
            img = np.clip(img + rng.randint(-12, 13, hw), 0, 255).astype(np.uint8)
            mask = np.kron(rng.rand(hw[0] // 32, hw[1] // 32) > 0.5,
                           np.ones((32, 32), bool)).astype(np.uint8) * 255
            Image.fromarray(img).save(root / "sem" / split / "images" / f"{i:03d}.png")
            Image.fromarray(mask).save(root / "sem" / split / "masks" / f"{i:03d}.png")


def unet_train_phase(torch, seed: int, root: Path):
    """unet_train.py's path at its own width: ``unet_train_torch.main`` (UNet(1,
    2), crop 512, batch 2, RMSprop lr 0.001) for SEM_EPOCHS epochs over
    the synthetic SEM folders, its train lines and its validation line
    printed with finite numbers; the f32 train step (TF32 on) timed on a
    device-resident Loader batch with its peak memory; one f32 step (TF32
    off, BN at running statistics) against the same step on the CPU (see
    ``unet_card_vs_cpu``)."""
    import unet_train_torch
    from deep_active_semantic_segmentation_torch.data import sem
    from deep_active_semantic_segmentation_torch.data.loader import Loader

    sem_root = root / "sem_root"
    t0 = time.perf_counter()
    write_sem(sem_root, seed)
    write_s = time.perf_counter() - t0
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        model, _ = unet_train_torch.main(
            ["--epochs", str(SEM_EPOCHS), "--crop-size", str(SEM_CROP),
             "--batch-size", str(SEM_BATCH)], dataset_root=str(sem_root), device=DEVICE)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    lines = text.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    numbers = []
    for token in " ".join(lines[1:]).split():
        with contextlib.suppress(ValueError):
            numbers.append(float(token))
    check(lines[0] == "Initializing Training!"
          and [line.split()[0] for line in lines[1:]] == ["Epoch"] * 5 + ["Val"]
          and lines[-1].startswith("Val loss:") and len(numbers) == 2 * 6 + 5
          and bool(np.isfinite(numbers).all()),
          f"unet_train_torch prints its train lines and validation line: {lines}")
    check(next(model.parameters()).device.type == "cuda", "the UNet trained on the card")

    # the train step alone, on one device-resident batch of the Loader
    pool = sem.SEMData(SEM_CROP, "train", dataset_root=str(sem_root),
                       rng=random.Random(seed))
    batch = next(iter(Loader(pool, SEM_BATCH, shuffle=True, seed=0,
                             device=DEVICE).device_batches()))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model, _, train_step, _ = unet_train_torch.build_unet_training(SEM_LR, DEVICE, gen)
    model.train()
    step_ms, peak, outs = timed_steps(torch, train_step, batch)
    losses = torch.stack([o["loss"] for o in outs]).tolist()
    print(f"UNet(1, 2) f32 train step (TF32 on): {step_ms:.3f} ms per step of "
          f"{SEM_BATCH} at {SEM_CROP} ({SEM_BATCH / step_ms * 1e3:.2f} images/s), "
          f"peak memory {peak / 2**30:.3f} GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"unet_train_torch.main {SEM_EPOCHS} epochs {main_s:.3f} s; SEM PNGs written "
          f"in {write_s:.3f} s; on {card_line()}", flush=True)
    check(bool(np.isfinite(losses).all()), "UNet train losses finite")
    return {"main_s": main_s, "lines": lines, "step_ms": step_ms,
            "images_per_s": SEM_BATCH / step_ms * 1e3, "peak_bytes": peak,
            "losses": losses, "card_vs_cpu": unet_card_vs_cpu(torch, seed)}


def unet_card_vs_cpu(torch, seed: int, side: int = 64):
    """One train step of the SEM trainer's UNet(1, 2) (RMSprop lr 0.001, CE
    summed over the batch), batch 2 at ``side`` px, from the same weights
    on the card and on the CPU, TF32 off, BN at running statistics; in f32
    (the uint8 wire, SEM's normalize on the device), then with f64 weights
    and a host-normalized f64 image, as card_vs_cpu_phase does. The loss
    within CPU_LOSS_RTOL and the gradients within UNET_GRAD_RTOL of the
    largest, in both. The updated parameters: in f64 every tensor within
    CPU_PARAM_RTOL of its own largest element; in f32, card_vs_cpu_phase's
    bar (the largest difference within CPU_PARAM_RTOL of the largest
    weight) over the elements whose gradient exceeds UNET_GRAD_RTOL of the
    largest. RMSprop's first step is lr * g / (0.1 |g| + 1e-8), about 10
    lr sign(g), so an element whose gradient is within the two devices'
    f32 rounding of 0 may take the other sign on the other device, a move
    of 20 lr: those elements are counted and printed, not held. Only the
    f32 pass runs SEM's normalize on the device.
    """
    import copy

    import unet_train_torch
    from deep_active_semantic_segmentation_torch.data import sem

    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (2, side, side, 1), dtype=np.uint8)
    label = (rng.rand(2, side, side) > 0.5).astype(np.uint8)
    label[:, :5] = 255
    images = {"float32": image,
              "float64": (image / 255.0 - sem.MEAN[0]) / sem.STD[0]}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dtype in ("float32", "float64"):
            models, losses, init = {}, {}, None
            for dev in ("cpu", DEVICE):
                model, _, step, _ = unet_train_torch.build_unet_training(
                    SEM_LR, dev, torch.Generator(device=dev).manual_seed(seed))
                model.to(getattr(torch, dtype))
                if init is None:   # the card starts from the CPU's weights
                    init = copy.deepcopy(model.state_dict())
                model.load_state_dict(init)
                freeze_bn(model)
                batch = {"image": torch.from_numpy(images[dtype]).to(dev),
                         "label": torch.from_numpy(label).to(dev)}
                losses[dev] = float(step(batch, 0)["loss"])
                models[dev] = model
            loss_rel = abs(losses[DEVICE] - losses["cpu"]) / abs(losses["cpu"])
            card = dict(models[DEVICE].named_parameters())
            cpu = dict(models["cpu"].named_parameters())
            g_max = max(p.grad.abs().max().item() for p in cpu.values())
            grad_rel = max((card[k].grad.cpu() - p.grad).abs().max().item()
                           for k, p in cpu.items()) / g_max
            diffs = {k: (card[k].detach().cpu() - p.detach()).abs() for k, p in cpu.items()}
            w_max = max(p.detach().abs().max().item() for p in cpu.values())
            per_tensor = max((diffs[k].max() / p.detach().abs().max().clamp_min(1e-30)).item()
                             for k, p in cpu.items())
            model_rel = max(d.max().item() for d in diffs.values()) / w_max
            real = {k: p.grad.abs() > UNET_GRAD_RTOL * g_max for k, p in cpu.items()}
            real_rel = max(diffs[k][real[k]].max().item() if real[k].any() else 0.0
                           for k in cpu) / w_max
            small = sum(int((~m).sum()) for m in real.values())
            worst = per_tensor if dtype == "float64" else real_rel
            print(f"card vs CPU, one {dtype} UNet(1, 2) RMSprop step at {side} px (BN at "
                  f"running statistics, TF32 off): loss {losses[DEVICE]:.9f} vs "
                  f"{losses['cpu']:.9f} (rel {loss_rel:.2e}, bar {CPU_LOSS_RTOL}); "
                  f"gradients {grad_rel:.2e} of the largest (bar {UNET_GRAD_RTOL}); "
                  f"parameters: largest difference {model_rel:.2e} of the largest weight, "
                  f"{real_rel:.2e} where |g| > {UNET_GRAD_RTOL} of the largest "
                  f"({small} elements below), worst tensor {per_tensor:.2e} of "
                  f"its own; held: "
                  + (f"worst tensor (bar {CPU_PARAM_RTOL})" if dtype == "float64" else
                     f"|g| above {UNET_GRAD_RTOL} (bar {CPU_PARAM_RTOL})"), flush=True)
            check(loss_rel <= CPU_LOSS_RTOL, f"card and CPU {dtype} UNet step losses agree")
            check(grad_rel <= UNET_GRAD_RTOL, f"card and CPU {dtype} UNet gradients agree")
            check(worst <= CPU_PARAM_RTOL, f"card and CPU {dtype} UNet updated parameters agree")
            out[dtype] = {"loss_card": losses[DEVICE], "loss_cpu": losses["cpu"],
                          "loss_rel": loss_rel, "grad_rel": grad_rel,
                          "model_rel": model_rel, "real_grad_model_rel": real_rel,
                          "small_grad_elements": small, "worst_tensor_rel": per_tensor}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return out


def write_raw_datasets(root: Path, seed: int):
    """The converters' input layouts under ``root``: Cityscapes
    (``leftImg8bit/<split>/<city>/*_leftImg8bit.png``, 1024x2048 RGB, and
    ``gtFine_trainvaltest/gtFine/<split>/<city>/*_gtFine_labelIds.png``,
    labelIds 0-33 in blocks with a void band) and Pascal VOC
    (``JPEGImages/*.jpg`` of 375x500, ``SegmentationClassRaw/*.png``,
    ``ImageSets/Segmentation/<split>.txt``), CONVERT_SPLITS records per
    split. Images are blocky with noise, so they compress as photos do."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    cs, voc = root / "cityscapes_raw", root / "voc_raw"
    for sub in ("JPEGImages", "SegmentationClassRaw", "ImageSets/Segmentation"):
        (voc / sub).mkdir(parents=True)

    def photo(hw):
        img = np.kron(rng.randint(0, 256, (-(-hw[0] // 16), -(-hw[1] // 16), 3)),
                      np.ones((16, 16, 1), np.int64))[:hw[0], :hw[1]]
        return np.clip(img + rng.randint(-6, 7, img.shape), 0, 255).astype(np.uint8)

    for split, n in CONVERT_SPLITS.items():
        names = []
        for i in range(n):
            city = ("aachen", "bremen")[i % 2]
            stem = f"{city}_{i:06d}_000019"
            for sub in ("leftImg8bit", "gtFine_trainvaltest/gtFine"):
                (cs / sub / split / city).mkdir(parents=True, exist_ok=True)
            Image.fromarray(photo((1024, 2048))).save(
                cs / "leftImg8bit" / split / city / f"{stem}_leftImg8bit.png",
                compress_level=1)
            ids = np.kron(rng.randint(0, 34, (16, 32)), np.ones((64, 64), np.int64))
            ids[:rng.randint(40, 120)] = 0
            Image.fromarray(ids.astype(np.uint8)).save(
                cs / "gtFine_trainvaltest/gtFine" / split / city
                / f"{stem}_gtFine_labelIds.png")
            name = f"2008_{split}{i:04d}"
            Image.fromarray(photo((375, 500))).save(voc / "JPEGImages" / f"{name}.jpg",
                                                    quality=90)
            cls = np.kron(rng.randint(0, PASCAL_CLASSES, (15, 20)),
                          np.ones((25, 25), np.int64))
            cls[:, :6] = 255
            Image.fromarray(cls.astype(np.uint8)).save(
                voc / "SegmentationClassRaw" / f"{name}.png")
            names.append(name)
        (voc / "ImageSets/Segmentation" / f"{split}.txt").write_text(
            "".join(x + "\n" for x in names))
    return cs, voc


def convert_phase(torch, seed: int, root: Path):
    """``data/convert.main`` on synthetic Cityscapes and Pascal VOC folders,
    both splits: every record equals its image and the 34 -> 19 remap of
    its labelIds (Pascal: its raw class PNG), each train split emits its
    seed set (SEED_SET keys of the store), and the converted stores are
    read back through the port's Loader onto the card (train.py's
    ``cityscapes`` at crop 513 and ``pascal`` at the 512 letterbox);
    records/s of each conversion."""
    from PIL import Image

    from deep_active_semantic_segmentation_torch.data import convert
    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore

    t0 = time.perf_counter()
    sources = dict(zip(("cityscapes", "pascal"), write_raw_datasets(root / "raw", seed)))
    write_s = time.perf_counter() - t0
    out_root = root / "converted"
    table = convert.cityscapes_class_map()
    rates = {}
    for family, src in sources.items():
        for split, n in CONVERT_SPLITS.items():
            out = out_root / family / split
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                keys = convert.main([family, str(src), split, str(out),
                                     "--seed-set-count", str(SEED_SET // 2),
                                     "--seed-set-seed", str(seed)])
            seconds = time.perf_counter() - t0
            rates[f"{family} {split}"] = n / seconds
            store = DirectoryStore(str(out))
            check(store.keys() == keys and len(keys) == n, f"{family} {split}: {n} records")
            for key in keys:
                rec = np.asarray(store.get(key))
                if family == "cityscapes":
                    path = src / key.decode().lstrip("/")
                    lab_path = (src / "gtFine_trainvaltest/gtFine" / split / path.parent.name
                                / path.name.replace("leftImg8bit.png", "gtFine_labelIds.png"))
                    want = np.dstack((np.array(Image.open(path).convert("RGB")),
                                      table[np.array(Image.open(lab_path))]))
                else:
                    name = key.decode()
                    want = np.dstack((
                        np.array(Image.open(src / "JPEGImages" / f"{name}.jpg").convert("RGB")),
                        np.array(Image.open(src / "SegmentationClassRaw" / f"{name}.png"))))
                check(rec.dtype == np.uint8 and np.array_equal(rec, want),
                      f"{family} {key!r}: the record is the image and its remapped labels")
        seeds = (out_root / family / "seed_sets" / "set_0.txt").read_text().splitlines()
        train_keys = {k.decode() for k in DirectoryStore(str(out_root / family / "train")).keys()}
        check(len(seeds) == min(SEED_SET // 2, CONVERT_SPLITS["train"])
              and set(seeds) <= train_keys, f"{family}: the seed set is emitted")
        check(family != "cityscapes" or set(np.unique(np.asarray(store.get(keys[0]))[..., 3]))
              <= set(range(NUM_CLASSES)) | {255}, "cityscapes labels are trainIds")

    loaded = {}
    for family, crop in (("cityscapes", 513), ("pascal", -1)):
        base = 513 if crop != -1 else 512
        _, _, val_loader, _, nclass = make_dataloader(
            family, base, crop, 2, dataset_root=str(out_root), seed=seed, device=DEVICE)
        host = list(val_loader)
        card = list(val_loader.device_batches())
        side = crop if crop != -1 else base
        check(len(card) == 1 and card[0]["image"].device.type == "cuda"
              and tuple(card[0]["image"].shape) == (2, side, side, 3)
              and torch.equal(card[0]["image"].cpu(), torch.from_numpy(host[0]["image"]))
              and torch.equal(card[0]["label"].cpu(), torch.from_numpy(host[0]["label"])),
              f"{family}: the converted val split reaches the card through the Loader")
        loaded[family] = {"classes": nclass, "shape": list(card[0]["image"].shape)}
    print(f"convert: records/s {json.dumps({k: round(v, 3) for k, v in rates.items()})}; "
          f"raw folders written in {write_s:.3f} s; converted stores read back onto the "
          f"card {json.dumps(loaded)}", flush=True)
    return {"records_per_s": rates, "raw_write_s": write_s, "loaded": loaded}


def compare_selections_phase(root: Path):
    """``compare_selections`` of the AL-round phase's experiment against the
    ``accuracy_eval`` consumer round that replays it: every common round
    N/N."""
    from deep_active_semantic_segmentation_torch.utils.compare_selections import (
        compare_selections)

    exp = root / "runs" / "active_cityscapes_image"
    results = compare_selections(str(exp / "round"), str(exp / "consumer"))
    check(len(results) == 2 and all(n == total > 0 for n, total in results.values()),
          f"every common round agrees N/N: {results}")
    return {"rounds": results}


def profiling_phase(torch, seed: int, store, paths, root: Path):
    """``utils/profiling.trace`` around one batch of the canonical DeepLab
    dropout query (DeepLab-v3+/MobileNetV2, 513², batch 5, 20 MC steps:
    the selector's scorer on one device batch), launch counts set to 0
    just before and read just after: B1 20 launches, the written trace
    names B1's kernel 20 times, and ``Throughput`` (host clock, marked
    with the scorer's CUDA result) agrees with the phase's CUDA events
    within 10%."""
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)
    from deep_active_semantic_segmentation_torch.utils.profiling import Throughput, trace

    cfg = PATHS["deeplab"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = build_model("deeplab", NUM_CLASSES, device=DEVICE, generator=gen, **cfg["build"])
    sel = get_active_selection_class("variance", NUM_CLASSES, store, cfg["crop"],
                                     cfg["batch"], device=DEVICE)
    bundle = ModelBundle(model, torch.device(DEVICE))
    batch = next(iter(sel._paths_loader(paths[:cfg["batch"]], include_labels=True,
                                        labels_as_mask=NUM_CLASSES)))
    sel._scorer(bundle, 1)(batch)   # warm-up: cuDNN's set-up outside the trace
    torch.cuda.synchronize()
    scorer = sel._scorer(bundle, 0)
    log_dir = root / "trace"
    meter = Throughput()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reset_counts()
    t0 = time.perf_counter()
    with trace(str(log_dir)):
        meter.start()
        start.record()
        maps = scorer(batch)
        end.record()
        meter.mark(cfg["batch"], maps)
    trace_s = time.perf_counter() - t0
    counts = read_counts()
    event_s = start.elapsed_time(end) / 1e3
    files = list(log_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"one trace written: {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    b1 = [e for e in events if e.get("cat") == "kernel"
          and "upsample4_argmax_kernel" in e.get("name", "")]
    per_s = meter.items_per_sec
    print(f"profiling: trace of one canonical dropout batch: {len(b1)} B1 kernels named "
          f"in {files[0].name} ({files[0].stat().st_size / 2**20:.1f} MiB, "
          f"{len(events)} events); launches {json.dumps(counts)}; Throughput "
          f"{meter.summary('images')} vs CUDA events {cfg['batch'] / event_s:.2f} images/s "
          f"({event_s * 1e3:.3f} ms); traced region {trace_s:.3f} s", flush=True)
    check(counts == {"upsample4_argmax": constants.MC_STEPS,
                     "tconv2x_argmax_parity_major": 0},
          f"B1 launched once per MC step in the traced batch: {counts}")
    check(len(b1) == constants.MC_STEPS, f"the trace names B1's kernel 20 times: {len(b1)}")
    check(abs(per_s * event_s / cfg["batch"] - 1) <= 0.10,
          "Throughput agrees with the CUDA events within 10%")
    check(tuple(maps.shape) == (cfg["batch"], cfg["crop"], cfg["crop"])
          and bool(torch.isfinite(maps).all()), "the traced batch's maps are finite")
    return {"counts": counts, "trace_b1_kernels": len(b1), "events": len(events),
            "throughput_images_per_s": per_s, "event_images_per_s": cfg["batch"] / event_s,
            "trace_bytes": files[0].stat().st_size, "traced_s": trace_s}



# ------------------------------------------- slice 10: data-parallel ranks

# two ranks: on the driver's one card they share it over gloo (NCCL refuses
# two ranks on one device), so their times are the cost of the collectives
# through the host, not a scaling result
MR_WORLD = 2
MR_PER_RANK = 4            # the ResNet-50 step's rows per rank (train.py's 4)
MR_TIMED_STEPS = 3         # timed bf16 steps per rank after the compared one
MR_BF16_RTOL = 2e-2        # a bf16 loss against the one-process bf16 loss
MR_JOIN_S = 600            # a spawn's limit
MR_GROUP_S = 300           # a collective's limit inside the ranks
# the canonical AL round on 2 ranks: the cut size of the AL-round phase, a
# global batch of 8 (4 per rank: the scripts' 5 does not divide)
MR_ROUND_ARGV = ROUND_ARGV + ["--batch-size", str(MR_WORLD * MR_PER_RANK),
                              "--num-devices", str(MR_WORLD)]
# train.py's default model at its crop: 9 x 9 label blocks of 57 px
MR_STEP_BACKBONE, MR_STEP_BLOCKS, MR_STEP_BLOCK = "resnet", 9, 57
# the queries: (architecture, crop, scoring batch, the kernel its votes use)
MR_QUERIES = [("deeplab", 513, 5, "upsample4_argmax"),
              ("enet", 512, 8, "tconv2x_argmax_parity_major")]
# where two ranks share a card (over gloo)
MR_SHARED_DEVICE = "cuda:0"


def _device_ms(torch, device, fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` calls, waiting for the device."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def _mr_step(torch, state, batch, dtype: str, device, mesh=None, freeze=False,
             spatial=False, generator=None, remat=False):
    """One SGD step (lr 0.01; dropout from ``generator``, off without one;
    ``remat``: the step's activation recompute) of a model loaded from
    ``state`` (DeepLab with ``state['backbone']``, or ``state['arch']``
    built with ``state['build']``, ``state['classes']`` classes, its
    images normalized with ``state['norm']``, ImageNet's by default) on
    ``batch`` (this rank's rows with ``mesh``; with ``spatial``, its band
    of them): in bf16 or f32 on the uint8 wire, or with f64 weights and
    the image normalized in f64 (the loss stays f32): (model, step
    function, the step's loss)."""
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        convert_cross_replica_bn)
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import make_train_step

    arch = state.get("arch", "deeplab")
    build = (state["build"] if "build" in state
             else dict(backbone=state["backbone"], mc_dropout=True))
    model = build_model(arch, state.get("classes", NUM_CLASSES), device=device, **build)
    model.load_state_dict(state["weights"])
    convert_cross_replica_bn(model.train(), mesh)
    if freeze:
        freeze_bn(model)
    norm = state.get("norm")
    if dtype == "float64":
        model.double()
        mean, std = norm or ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
        mean = torch.tensor(mean, dtype=torch.float64, device=device)
        std = torch.tensor(std, dtype=torch.float64, device=device)
        batch = dict(batch, image=(batch["image"].double() / 255.0 - mean) / std)
    step = make_train_step(model, build_optimizer("SGD", param_groups(model, arch)),
                           build_loss("ce", mesh=mesh), constant_schedule(0.01),
                           compute_dtype="float32" if dtype == "float64" else dtype,
                           norm=norm, mesh=mesh, spatial=spatial, generator=generator,
                           remat=remat)
    return model, step, float(step(batch, 0)["loss"])


def _off_the_kinks(torch, model, gen):
    """``model`` with every BN bias drawn ~0.1 N(0, 1) from ``gen``. At
    init (bias 0) a channel that is 0 but for rounding-level values puts
    BN outputs exactly on the ReLU / ReLU6 kink in one BN's arithmetic and
    1e-17 off it in another's (cuDNN's against the cross-replica BN's f64
    sums), and the two steps then take different subgradients there
    (ROADMAP C); the tests' models are drawn so too."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    return model


def _state(model) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _param_gaps(got: dict, ref: dict):
    """(largest difference over the model of the largest |weight|, worst
    tensor's difference of its own largest element)."""
    floats = [k for k, v in ref.items() if v.is_floating_point()]
    scale = max(ref[k].abs().max().item() for k in floats)
    diffs = {k: (got[k] - ref[k]).abs().max().item() for k in floats}
    return (max(diffs.values()) / scale,
            max(d / max(ref[k].abs().max().item(), 1e-30) for k, d in diffs.items()))


def _mr_query(torch, sel, model, paths, kernel: str, warm):
    """A variance query through the selector (launch counts set to 0 just
    before it and read just after), then its scores re-scored: (top 5,
    scores, counts, seconds)."""
    from deep_active_semantic_segmentation_torch.ops.entropy import mean_over_pixels
    from deep_active_semantic_segmentation_torch.selection import ModelBundle

    bundle = ModelBundle(model, sel.device)
    sel.get_vote_entropy_for_images(bundle, warm, 1, seed=1)   # cuDNN set-up
    sync = torch.cuda.synchronize if sel.device.type == "cuda" else (lambda: None)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    top = sel.get_vote_entropy_for_images(bundle, paths, 5, seed=0)
    sync()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    scorer = sel._scorer(bundle, 0)
    scores = sel._collect_scores(paths, lambda b: mean_over_pixels(scorer(b)),
                                 include_labels=True, labels_as_mask=NUM_CLASSES)
    return top, scores, counts, seconds


def multi_rank_worker(mesh, setup_path: str, out_dir: str) -> None:
    """One rank of the multi-rank phase (``parallel.mesh.launch``): the
    ResNet-50 steps on its rows (f32 compared, bf16 compared and timed),
    the gradient all-reduce's time, and the MobileNetV2 and ENet queries
    sharded over the ranks. Saves ``rank<r>.pt`` in ``out_dir``."""
    import torch

    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection import (
        get_active_selection_class)

    setup = torch.load(setup_path, weights_only=False)
    device = mesh.device
    per = setup["image"].shape[0] // mesh.world
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    batch = {k: torch.from_numpy(setup[k][rows]).to(device) for k in ("image", "label")}
    out = {"rank": mesh.rank, "device": str(device)}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype in ("float64", "float32"):
            model, _, out[f"{dtype}_loss"] = _mr_step(torch, setup["resnet"], batch,
                                                      dtype, device, mesh)
            out[f"{dtype}_state"] = _state(model)
            del model
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    model, step, out["bf16_loss"] = _mr_step(torch, setup["resnet"], batch,
                                             "bfloat16", device, mesh)
    it = iter(range(1, 1 + MR_TIMED_STEPS))
    out["bf16_step_ms"] = _device_ms(torch, device, lambda: step(batch, next(it)),
                                     MR_TIMED_STEPS)
    flat = torch.zeros(sum(p.numel() for p in model.parameters()), device=device)
    mesh.all_reduce(flat)
    out["allreduce_ms"] = _device_ms(torch, device, lambda: mesh.all_reduce(flat), 3)
    out["allreduce_bytes"] = flat.numel() * 4
    del model, step, flat
    store = DirectoryStore(setup["store"])
    paths = setup["paths"]
    for arch, crop, batch_size, kernel in setup["queries"]:
        model = build_model(arch, NUM_CLASSES, backbone="mobilenet", mc_dropout=True,
                            device=device)
        model.load_state_dict(setup[arch])
        sel = get_active_selection_class("variance", NUM_CLASSES, store, crop,
                                         batch_size, mesh=mesh)
        out[arch] = dict(zip(("top", "scores", "counts", "seconds"), _mr_query(
            torch, sel, model.eval(), paths, kernel,
            paths[:mesh.world * batch_size])))
    torch.save(out, str(Path(out_dir) / f"rank{mesh.rank}.pt"))


def multi_rank_phase(torch, seed: int, root: Path, store_root: Path, paths):
    """Slice 10: the data-parallel path. (a) Two ranks sharing the card over
    gloo (and, where the machine shows two cards, one rank per card over
    NCCL): the ResNet-50 step on 4 rows per rank against the one-process
    step on the same 8 images, the canonical MobileNetV2 and the ENet
    dropout queries sharded over the ranks against the one-process
    queries and one 2-rank `variance` round through active_train_torch.main
    (``dryrun_multichip`` runs in the spatial phase). (b) The NCCL route at
    world 1: make_mesh with NCCL, one DDP step with cross-replica BN
    against the plain step."""
    import active_train_torch
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
    from deep_active_semantic_segmentation_torch.selection import (
        get_active_selection_class)

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    n = MR_WORLD * MR_PER_RANK
    blocks, block = MR_STEP_BLOCKS, MR_STEP_BLOCK
    label = np.kron(rng.randint(0, NUM_CLASSES, (n, blocks, blocks)),
                    np.ones((1, block, block), np.int64)).astype(np.uint8)
    label[:, :rng.randint(block // 3, block)] = 255
    image = rng.randint(0, 256, label.shape + (3,), dtype=np.uint8)
    setup = {"image": image, "label": label, "store": str(store_root),
             "paths": paths,
             "queries": MR_QUERIES}
    gen = torch.Generator(device=dev).manual_seed(seed)
    resnet = _off_the_kinks(torch, build_model(
        "deeplab", NUM_CLASSES, backbone=MR_STEP_BACKBONE, mc_dropout=True,
        device=dev, generator=gen), gen)
    setup["resnet"] = {"backbone": MR_STEP_BACKBONE, "weights": {
        k: v.cpu() for k, v in resnet.state_dict().items()}}
    del resnet
    for arch in ("deeplab", "enet"):
        setup[arch] = _state(_off_the_kinks(torch, build_model(
            arch, NUM_CLASSES, backbone="mobilenet", mc_dropout=True, device=dev,
            generator=gen), gen))
    out = {}

    # the one-process references on the same card
    batch = {"image": torch.from_numpy(image).to(dev),
             "label": torch.from_numpy(label).to(dev)}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    ref = {}
    try:
        for dtype in ("float64", "float32"):
            model, _, loss = _mr_step(torch, setup["resnet"], batch, dtype, dev)
            ref[dtype] = (loss, _state(model))
            del model
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    model, step, ref_bf16 = _mr_step(torch, setup["resnet"], batch, "bfloat16", dev)
    it = iter(range(1, 1 + MR_TIMED_STEPS))
    one_ms = _device_ms(torch, dev, lambda: step(batch, next(it)), MR_TIMED_STEPS)
    del model, step, batch
    store = DirectoryStore(str(store_root))
    ref_queries = {}
    for arch, crop, batch_size, kernel in setup["queries"]:
        model = build_model(arch, NUM_CLASSES, backbone="mobilenet", mc_dropout=True,
                            device=dev)
        model.load_state_dict(setup[arch])
        sel = get_active_selection_class("variance", NUM_CLASSES, store, crop,
                                         batch_size, device=DEVICE)
        ref_queries[arch] = dict(zip(("top", "scores", "counts", "seconds"), _mr_query(
            torch, sel, model.eval(), paths, kernel, paths[:MR_WORLD * batch_size])))
        del model
    torch.cuda.empty_cache()
    out["one_process"] = {"float64_loss": ref["float64"][0],
                          "float32_loss": ref["float32"][0], "bf16_loss": ref_bf16,
                          "bf16_step_ms": one_ms,
                          "queries": {a: {k: v for k, v in q.items() if k != "scores"}
                                      for a, q in ref_queries.items()}}
    setup_path = root / "multi_rank_setup.pt"
    torch.save(setup, str(setup_path))
    routes = [("gloo", MR_SHARED_DEVICE)]
    if torch.cuda.device_count() >= MR_WORLD:
        routes.append(("nccl", None))
    for backend, device in routes:
        out_dir = root / f"multi_rank_{backend}"
        out_dir.mkdir()
        t0 = time.perf_counter()
        pt_mesh.launch(multi_rank_worker, (str(setup_path), str(out_dir)),
                       num_devices=MR_WORLD, device=device, backend=backend,
                       timeout=MR_GROUP_S, join_timeout=MR_JOIN_S)
        wall = time.perf_counter() - t0
        ranks = [torch.load(str(out_dir / f"rank{r}.pt"), weights_only=False)
                 for r in range(MR_WORLD)]
        route = out[f"{backend}_ranks"] = {"wall_s": wall, "ranks": []}
        gaps = {}
        for dtype in ("float64", "float32"):
            loss, state = ref[dtype]
            gaps[dtype] = (abs(ranks[0][f"{dtype}_loss"] - loss) / abs(loss),
                           *_param_gaps(ranks[0][f"{dtype}_state"], state))
            same = all(torch.equal(ranks[0][f"{dtype}_state"][k],
                                   ranks[1][f"{dtype}_state"][k]) for k in state)
            print(f"multi-rank ({backend}, {MR_WORLD} ranks on "
                  f"{'one card: collectives through the host, not scaling' if device else 'one card each'}): DeepLab-"
                  f"{MR_STEP_BACKBONE} {dtype} step, train-mode BN, on {MR_PER_RANK} rows "
                  f"per rank vs one process on {n}: loss rel {gaps[dtype][0]:.2e}; "
                  f"parameters {gaps[dtype][1]:.2e} of the largest weight, worst "
                  f"tensor {gaps[dtype][2]:.2e} of its own; ranks' tensors (BN buffers "
                  f"included) equal: {same}", flush=True)
            check(same, f"{backend} {dtype}: both ranks hold the same weights and "
                        "BN buffers")
            check(gaps[dtype][0] <= CPU_LOSS_RTOL,
                  f"{backend}: the 2-rank {dtype} loss equals one process's")
        # PR 8's bars: f32 over the model of its largest weight, f64 per tensor
        check(gaps["float32"][1] <= CPU_PARAM_RTOL and gaps["float64"][2] <= CPU_PARAM_RTOL,
              f"{backend}: the 2-rank updated parameters equal one process's")
        route["gaps"] = gaps
        bf16_rel = abs(ranks[0]["bf16_loss"] - ref_bf16) / abs(ref_bf16)
        print(f"  bf16 loss rel {bf16_rel:.2e} (bar {MR_BF16_RTOL})", flush=True)
        check(ranks[0]["bf16_loss"] == ranks[1]["bf16_loss"] and bf16_rel <= MR_BF16_RTOL,
              f"{backend}: the bf16 loss is the global batch's on both ranks")
        for r in ranks:
            route["ranks"].append({k: v for k, v in r.items() if not k.endswith("_state")})
            print(f"  rank {r['rank']} ({r['device']}): bf16 step "
                  f"{r['bf16_step_ms']:.1f} ms (one process on {n} images: {one_ms:.1f} ms);"
                  f" gradient all-reduce {r['allreduce_ms']:.1f} ms for "
                  f"{r['allreduce_bytes'] / 2**20:.1f} MiB", flush=True)
        for arch, _, _, kernel in setup["queries"]:
            one = ref_queries[arch]
            counts = [r[arch]["counts"][kernel] for r in ranks]
            rate = len(paths) / max(r[arch]["seconds"] for r in ranks)
            print(f"  {arch} query over {len(paths)} records: {rate:.2f} images/s on "
                  f"{MR_WORLD} ranks (one process: {len(paths) / one['seconds']:.2f}); "
                  f"{kernel} launches per rank {counts} (one process "
                  f"{one['counts'][kernel]}); picks equal: "
                  f"{all(r[arch]['top'] == one['top'] for r in ranks)}", flush=True)
            check(all(r[arch]["top"] == one["top"] and r[arch]["scores"] == one["scores"]
                      for r in ranks),
                  f"{backend}: the {arch} query's scores and picks equal one process's")
            check(sum(counts) == one["counts"][kernel] and all(c > 0 for c in counts),
                  f"{backend}: {kernel} launches per rank {counts} sum to "
                  f"{one['counts'][kernel]}")
            route[f"{arch}_query_images_per_s"] = rate
            route[f"{arch}_launches_per_rank"] = counts

    # one 2-rank variance round through the driver, ranks sharing the card
    runs = root / "runs_multi_rank"
    argv = MR_ROUND_ARGV + ["--seed", str(seed), "--checkname", "round_2ranks"]
    t0 = time.perf_counter()
    active_train_torch.main(argv, device=MR_SHARED_DEVICE, backend="gloo",
                            dataset_root=str(root), runs_root=str(runs))
    round_s = time.perf_counter() - t0
    exp = runs / "active_cityscapes_image" / "round_2ranks"
    run_dirs = sorted(d for d in exp.iterdir() if d.name.startswith("run_"))
    lines = [len((d / "selections.txt").read_text().splitlines()) for d in run_dirs]
    keys = torch.load(str(run_dirs[0] / "best.ckpt"), map_location="cpu",
                      weights_only=True)["state_dict"].keys()
    print(f"2-rank variance round through active_train_torch.main: {round_s:.3f} s; "
          f"selections {lines}; best.ckpt keys with 'module.': "
          f"{sum(k.startswith('module.') for k in keys)}", flush=True)
    check(lines == [SEED_SET, SEED_SET + 5], f"the 2-rank round's selections {lines}")
    check(not any(k.startswith("module.") for k in keys),
          "the 2-rank best.ckpt keeps the reference key names")
    check(len(list(exp.glob("run_*/selections.txt"))) == len(run_dirs),
          "one selections.txt per round")
    out["round"] = {"seconds": round_s, "selections": lines}

    # (b) the NCCL route at world 1: the production route builds and runs
    mesh = pt_mesh.make_mesh(device=DEVICE, backend="nccl", timeout=MR_GROUP_S)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        batch = {k: torch.from_numpy(v[:MR_PER_RANK]).to(dev)
                 for k, v in (("image", image), ("label", label))}
        nccl = {}
        for freeze in (True, False):
            results = []
            for m in (mesh, None):
                model, step, loss = _mr_step(torch, {"backbone": "mobilenet",
                                                     "weights": setup["deeplab"]},
                                             batch, "float32", dev, m, freeze)
                results.append((loss, {k: v.detach().clone()
                                       for k, v in model.state_dict().items()},
                                _device_ms(torch, dev, lambda: step(batch, 1), 3)))
            (l_ddp, s_ddp, ms_ddp), (l_one, s_one, ms_one) = results
            scale = max(v.abs().max().item() for v in s_one.values()
                        if v.is_floating_point())
            rel = max((s_ddp[k] - v).abs().max().item() for k, v in s_one.items()
                      if v.is_floating_point()) / scale
            bar = 1e-6 if freeze else CPU_PARAM_RTOL
            name = "BN frozen" if freeze else "train-mode BN"
            print(f"NCCL route, world 1 ({name}): DDP + cross-replica BN step loss "
                  f"{l_ddp:.9f} vs plain {l_one:.9f}; parameters {rel:.2e} of the "
                  f"largest weight (bar {bar}); step {ms_ddp:.2f} ms vs {ms_one:.2f} ms",
                  flush=True)
            check(abs(l_ddp - l_one) <= (1e-6 if freeze else CPU_LOSS_RTOL) * abs(l_one),
                  f"NCCL world-1 {name} loss equals the plain step's")
            check(rel <= bar, f"NCCL world-1 {name} parameters equal the plain step's")
            nccl[name] = {"loss_ddp": l_ddp, "loss_plain": l_one, "param_rel": rel,
                          "ddp_ms": ms_ddp, "plain_ms": ms_one}
        out["nccl_world1"] = nccl
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        mesh.close()
    return out


# ------------------------------------------- slice 11: the drivers on N ranks

# the accuracy predictor's run on 2 ranks (accuracy_predictor_train.py's
# flags as ACC_ARGV, at the canonical 513² over the round's 20 Cityscapes
# records, a global batch of 4: 2 rows per rank)
MRD_ROWS = 2
MRD_CROP = 513
MRD_ACC_ARGV = ["--dataset", "active_cityscapes_image", "--backbone", "mobilenet",
                "--crop-size", str(MRD_CROP), "--base-size", str(MRD_CROP),
                "--batch-size", str(MR_WORLD * MRD_ROWS), "--lr", "0.007", "--epochs", "1",
                "--eval-interval", "1", "--use-lr-scheduler", "--lr-scheduler", "step",
                "--max-iterations", "2", "--active-batch-size", "5",
                "--use-balanced-weights", "--workers", "0", "--no-early-stop",
                "--active-selection-mode", "accuracy", "--weight-unet", "0.30",
                "--weight-wrong-label-unet", "0.75"]
# a two-headed f32 step (TF32 off) against one process, of the largest
# weight: every f32 train-mode step of the predictor rounds ~1e-4 of the
# largest weight away from the exact (f64) step in its first layers (the
# CPU tests measured the 2-rank port 1.1e-4, JAX on a 2-device mesh
# 9.4e-5), so the bar sits above that rounding; f64 is held to 1e-12
MRD_F32_RTOL = 5e-4
MRD_F64_RTOL = 1e-12
MRD_BF16_RTOL = 1e-2
# the SEM run on 2 ranks against one process, relative (in f64: see
# f64_models)
MRD_SEM_RTOL = 1e-4
MRD_SEM_HW, MRD_SEM_COUNTS = (576, 640), (4, 3)


@contextlib.contextmanager
def stdout_to(path: Path):
    """This process's fd 1, and so the stdout of every process it spawns
    meanwhile (rank 0 of a launch prints there), into ``path``."""
    import os

    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "wb") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


@contextlib.contextmanager
def f64_models():
    """The port's ``build_model`` builds f64 models for the length of the
    block (weights drawn as before, then cast; the f32 network input cast
    on entry; the losses stay f32). The SEM trainer's RMSprop turns the
    rounding noise of gradients that are 0 in exact arithmetic (the conv
    biases ahead of train-mode BN) into steps of ~10 lr of either sign,
    so two f32 runs part from their first step whatever their ranks; in
    f64 that noise is far below RMSprop's eps."""
    import torch

    from deep_active_semantic_segmentation_torch.models import factory

    build = factory.build_model

    def build_f64(*args, **kwargs):
        model = build(*args, **kwargs).double()
        model.register_forward_pre_hook(lambda _, inputs: tuple(
            x.double() if torch.is_tensor(x) else x for x in inputs))
        return model

    factory.build_model = build_f64
    try:
        yield
    finally:
        factory.build_model = build


def _mrd_step(torch, state, batch, dtype: str, device, mesh=None):
    """One two-headed SGD step (lr 0.01, dropout off, train-mode BN) of
    the predictor loaded from ``state``, at the end-to-end weights
    ACC_WEIGHTS, the error classes weighted [0.75, 0.25], on ``batch``
    (this rank's rows with ``mesh``): in bf16 or f32 on the uint8 wire, or
    with f64 weights and the image normalized in f64: (model, step, loss)."""
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        convert_cross_replica_bn)
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_dual_train_step)

    model = build_model("accuracy_predictor", NUM_CLASSES, device=device)
    model.load_state_dict(state)
    convert_cross_replica_bn(model.train(), mesh)
    if dtype == "float64":
        model.double()
        mean = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float64, device=device)
        std = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float64, device=device)
        batch = dict(batch, image=(batch["image"].double() / 255.0 - mean) / std)
    w_wrong = torch.tensor([0.75, 0.25], device=device)
    step = make_dual_train_step(
        model, build_optimizer("SGD", param_groups(model, "accuracy_predictor")),
        build_loss("ce", mesh=mesh), build_loss("ce", class_weights=w_wrong, mesh=mesh),
        constant_schedule(0.01), compute_dtype="float32" if dtype == "float64" else dtype,
        mesh=mesh)
    return model, step, float(step(batch, 0, *ACC_WEIGHTS)["loss"])


def _mrd_picks(torch, state, store, paths, crop: int, device, mesh=None) -> dict:
    """The four accuracy_predictor_train.py modes' 5 picks over ``paths``
    at ``crop`` with the predictor loaded from ``state`` (scoring batches
    of 4, each rank its share with ``mesh``)."""
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.selection import (
        ActiveSelectionAccuracy, ModelBundle)

    model = build_model("accuracy_predictor", NUM_CLASSES, device=device)
    model.load_state_dict(state)
    bundle = ModelBundle(model.eval(), torch.device(device))
    sel = ActiveSelectionAccuracy(NUM_CLASSES, store, crop, MR_WORLD * MRD_ROWS,
                                  device=device, mesh=mesh)
    return {"accuracy": sel.get_least_accurate_samples(bundle, paths, 5),
            "gradient": sel.get_adversarially_vulnarable_samples(bundle, paths, 5),
            "uncertain": sel.get_unsure_samples(bundle, paths, 5),
            "uncertain_gradient": sel.get_adversarially_vulnarable_samples(
                bundle, sel.get_unsure_samples(bundle, paths, 10), 5)}


def _mrd_sem(mesh, sem_root: str, argv):
    """The SEM trainer's rank body (``unet_train_torch.train``) with
    ``argv`` in f64: its printed numbers per epoch."""
    import unet_train_torch

    text = io.StringIO()
    with f64_models(), contextlib.redirect_stdout(text):
        return unet_train_torch.train(mesh, unet_train_torch.parse_args(argv),
                                      sem_root)[2]


def multi_rank_drivers_worker(mesh, setup_path: str, out_dir: str) -> None:
    """One rank of the multi_rank_drivers phase: the two-headed step on
    its rows (f64 and f32 compared, bf16 compared and timed), the four
    modes' picks from one checkpoint sharded over the ranks, and the SEM
    trainer's f64 run. Saves ``rank<r>.pt`` in ``out_dir``."""
    import torch

    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore

    setup = torch.load(setup_path, weights_only=False)
    device = mesh.device
    reset_counts()
    rows = slice(mesh.rank * MRD_ROWS, (mesh.rank + 1) * MRD_ROWS)
    batch = {k: torch.from_numpy(setup[k][rows]).to(device) for k in ("image", "label")}
    out = {"rank": mesh.rank, "device": str(device)}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype in ("float64", "float32"):
            model, _, out[f"{dtype}_loss"] = _mrd_step(torch, setup["predictor"], batch,
                                                       dtype, device, mesh)
            out[f"{dtype}_state"] = _state(model)
            del model
        out["picks"] = _mrd_picks(torch, setup["predictor"], DirectoryStore(setup["store"]),
                                  setup["pool"], setup["crop"], device, mesh)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    model, step, out["bf16_loss"] = _mrd_step(torch, setup["predictor"], batch,
                                              "bfloat16", device, mesh)
    it = iter(range(1, 1 + MR_TIMED_STEPS))
    out["bf16_step_ms"] = _device_ms(
        torch, device, lambda: step(batch, next(it), *ACC_WEIGHTS), MR_TIMED_STEPS)
    del model, step
    torch.cuda.empty_cache()
    out["sem"] = _mrd_sem(mesh, setup["sem_root"], setup["sem_argv"])
    out["counts"] = read_counts()
    torch.save(out, str(Path(out_dir) / f"rank{mesh.rank}.pt"))


def _printed_metrics(text: str) -> str:
    """visualize's metrics line in ``text``."""
    return next(line for line in text.splitlines() if line.startswith("Acc:"))


def multi_rank_drivers_phase(torch, seed: int, root: Path, paths):
    """Slice 11: the four drivers that run on N ranks since this slice, two
    gloo ranks sharing the card (and, for (a), (b)'s picks and (d)'s f64
    run, one rank per card over NCCL where the machine shows two cards).
    (a) One two-headed step (DeepLab-v3+/MobileNetV2 with the UNet error
    head, 513², 19 classes, train-mode cross-replica BN, 2 rows per rank)
    against one process on the same 4 images: f64, f32 (TF32 off), bf16,
    and its ms per rank. (b) One 2-round accuracy_predictor_train_torch.main
    on the round's 20 records (accuracy mode, 1 epoch, global batch 4) that
    writes its selections; and the four modes' picks from one fixed
    checkpoint, sharded, equal to one process's. (c) visualize_torch.main
    (a DeepLab checkpoint the phase writes) and eval_series_torch.main
    --dual-head (the run of (b)) on 2 ranks: the metrics, the PNGs and
    validation_mIoUs.txt equal a one-rank replay's whose forwards see the
    same rows. (d) The SEM trainer's rank body at 512², batch 2, 5 epochs
    (its batch-1 validation included) in f64 against one process, and
    unet_train_torch.main on 2 ranks in f32. (e) Whether the lmdb binding
    imports, and where it does a converted LMDB store through the
    factory."""
    import accuracy_predictor_train_torch
    import eval_series_torch
    import unet_train_torch
    import visualize_torch
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed + 11)
    n = MR_WORLD * MRD_ROWS
    blocks, block = MR_STEP_BLOCKS, MR_STEP_BLOCK
    label = np.kron(rng.randint(0, NUM_CLASSES, (n, blocks, blocks)),
                    np.ones((1, block, block), np.int64)).astype(np.uint8)
    label[:, :rng.randint(block // 3, block)] = 255
    image = rng.randint(0, 256, label.shape + (3,), dtype=np.uint8)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    predictor = _state(_off_the_kinks(torch, build_model(
        "accuracy_predictor", NUM_CLASSES, device=dev, generator=gen), gen))
    sem_root = root / "sem_multi_rank"
    write_sem(sem_root, seed + 11, MRD_SEM_HW, MRD_SEM_COUNTS)
    store_root = root / "cityscapes" / "train"
    pool = list(paths[SEED_SET:])
    sem_argv = ["--epochs", str(SEM_EPOCHS), "--crop-size", str(SEM_CROP), "--batch-size",
                str(SEM_BATCH)]
    setup = {"image": image, "label": label, "predictor": predictor, "crop": MRD_CROP,
             "store": str(store_root), "pool": pool, "sem_root": str(sem_root),
             "sem_argv": sem_argv}
    out = {}

    # (a, b, d) the one-process references on the same card
    batch = {"image": torch.from_numpy(image).to(dev),
             "label": torch.from_numpy(label).to(dev)}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    ref = {}
    try:
        for dtype in ("float64", "float32"):
            model, _, loss = _mrd_step(torch, predictor, batch, dtype, dev)
            ref[dtype] = (loss, _state(model))
            del model
        t0 = time.perf_counter()
        ref_picks = _mrd_picks(torch, predictor, DirectoryStore(str(store_root)), pool,
                               MRD_CROP, DEVICE)
        picks_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    model, step, ref_bf16 = _mrd_step(torch, predictor, batch, "bfloat16", dev)
    it = iter(range(1, 1 + MR_TIMED_STEPS))
    one_ms = _device_ms(torch, dev, lambda: step(batch, next(it), *ACC_WEIGHTS),
                        MR_TIMED_STEPS)
    del model, step, batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref_sem = _mrd_sem(pt_mesh.make_mesh(device=DEVICE), str(sem_root), sem_argv)
    sem_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    setup_path = root / "multi_rank_drivers_setup.pt"
    torch.save(setup, str(setup_path))
    routes = [("gloo", MR_SHARED_DEVICE)]
    if torch.cuda.device_count() >= MR_WORLD:
        routes.append(("nccl", None))
    rank_counts = []
    for backend, device in routes:
        where = ("one card: collectives through the host, not scaling" if device
                 else "one card each")
        out_dir = root / f"multi_rank_drivers_{backend}"
        out_dir.mkdir()
        t0 = time.perf_counter()
        pt_mesh.launch(multi_rank_drivers_worker, (str(setup_path), str(out_dir)),
                       num_devices=MR_WORLD, device=device, backend=backend,
                       timeout=MR_GROUP_S, join_timeout=MR_JOIN_S)
        worker_s = time.perf_counter() - t0
        ranks = [torch.load(str(out_dir / f"rank{r}.pt"), weights_only=False)
                 for r in range(MR_WORLD)]
        gaps = {}
        for dtype, bar in (("float64", MRD_F64_RTOL), ("float32", MRD_F32_RTOL)):
            loss, state = ref[dtype]
            gaps[dtype] = (abs(ranks[0][f"{dtype}_loss"] - loss) / abs(loss),
                           *_param_gaps(ranks[0][f"{dtype}_state"], state))
            same = all(torch.equal(ranks[0][f"{dtype}_state"][k],
                                   ranks[1][f"{dtype}_state"][k]) for k in state)
            print(f"multi-rank drivers ({backend}, {MR_WORLD} ranks on {where}): "
                  f"two-headed {dtype} step (DeepLab-MobileNetV2 + UNet error head, 513², "
                  f"train-mode BN) on {MRD_ROWS} rows per rank vs one process on {n}: loss "
                  f"rel {gaps[dtype][0]:.2e}; parameters {gaps[dtype][1]:.2e} of the "
                  f"largest weight (bar {bar}), worst tensor {gaps[dtype][2]:.2e} of its "
                  f"own; ranks' tensors equal: {same}", flush=True)
            check(same, f"{backend} two-headed {dtype}: both ranks hold the same weights "
                        "and BN buffers")
            check(gaps[dtype][0] <= CPU_LOSS_RTOL and gaps[dtype][1] <= bar,
                  f"{backend}: the 2-rank two-headed {dtype} step equals one process's")
        bf16_rel = abs(ranks[0]["bf16_loss"] - ref_bf16) / abs(ref_bf16)
        step_ms = [r["bf16_step_ms"] for r in ranks]
        print(f"  bf16 loss rel {bf16_rel:.2e} (bar {MRD_BF16_RTOL}); bf16 step per rank "
              f"{[round(x, 1) for x in step_ms]} ms (one process on {n} images: "
              f"{one_ms:.1f} ms); on {card_line()}", flush=True)
        check(ranks[0]["bf16_loss"] == ranks[1]["bf16_loss"] and bf16_rel <= MRD_BF16_RTOL,
              f"{backend}: the two-headed bf16 loss is the global batch's on both ranks")
        same_picks = all(r["picks"] == ref_picks for r in ranks)
        print(f"  the four modes' picks over {len(pool)} records from one checkpoint, "
              f"sharded over {MR_WORLD} ranks, equal one process's: {same_picks} "
              f"(one process: {picks_s:.3f} s)", flush=True)
        check(same_picks, f"{backend}: the four modes' 2-rank picks equal one process's: "
                          f"{[r['picks'] for r in ranks]} vs {ref_picks}")
        sem_rel = max(abs(x - y) / abs(y) for r in ranks
                      for row, ref_row in zip(r["sem"], ref_sem)
                      for x, y in zip(row[1:], ref_row[1:]) if y is not None)
        print(f"  SEM trainer (UNet(1, 2), 512², batch 2, {SEM_EPOCHS} epochs, f64) on "
              f"{MR_WORLD} ranks vs one process: largest relative gap of its printed "
              f"numbers {sem_rel:.2e} (bar {MRD_SEM_RTOL}); validation {ref_sem[-1][3:]}; "
              f"one process {sem_s:.3f} s; the worker spawn {worker_s:.3f} s", flush=True)
        check(all([row[0] for row in r["sem"]] == [row[0] for row in ref_sem]
                  for r in ranks)
              and ref_sem[-1][3] is not None and sem_rel <= MRD_SEM_RTOL,
              f"{backend}: the 2-rank SEM run equals one process's")
        out[f"{backend}_ranks"] = dict(
            gaps=gaps, bf16_rel=bf16_rel, bf16_step_ms_per_rank=step_ms,
            sem_rel=sem_rel, worker_s=worker_s)
        rank_counts += [r["counts"] for r in ranks]
    out.update(one_process_bf16_step_ms=one_ms, picks=ref_picks, rank_counts=rank_counts)

    # (b) one 2-round run through the driver on 2 ranks
    runs = root / "runs_multi_rank_drivers"
    argv = MRD_ACC_ARGV + ["--seed", str(seed), "--checkname", "acc_2ranks"]
    t0 = time.perf_counter()
    with stdout_to(root / "acc_2ranks.out"):
        accuracy_predictor_train_torch.main(argv + ["--num-devices", str(MR_WORLD)],
                                            device=MR_SHARED_DEVICE, backend="gloo",
                                            dataset_root=str(root), runs_root=str(runs))
    acc_s = time.perf_counter() - t0
    exp = runs / "active_cityscapes_image" / "acc_2ranks"
    lines = [len(rows) for rows in read_selections(exp).values()]
    print(f"2-rank accuracy_predictor_train_torch.main (accuracy, 2 rounds, global batch "
          f"{n}): {acc_s:.3f} s; selections {lines}", flush=True)
    check(lines == [SEED_SET, SEED_SET + 5], f"the 2-rank accuracy run's selections {lines}")

    # (c) replays on 2 ranks against one rank: a DeepLab checkpoint the
    # phase writes (random weights) and the run of (b). On the card a
    # forward's rounding depends on its batch size (cuDNN picks other
    # kernels), so the 2-rank replay at a global batch of 4 (2 rows per
    # rank) is held against one rank at a batch of 2, the rows each
    # forward sees; one rank at a batch of 4 is printed beside them
    from deep_active_semantic_segmentation_torch.utils.checkpoint import save_checkpoint

    deeplab = _off_the_kinks(torch, build_model("deeplab", NUM_CLASSES, backbone="mobilenet",
                                                device=dev, generator=gen), gen)
    replays = {"ranks": (MR_WORLD, n), "one": (1, MRD_ROWS), "one_batch4": (1, n)}
    for name in replays:
        (root / f"replay_{name}").mkdir()
        save_checkpoint(str(root / f"replay_{name}" / "best.ckpt"), deeplab, None, 1, 0.0)
        shutil.copytree(exp, root / f"replay_{name}" / "acc")
    del deeplab
    vis_argv = ["--dataset", "active_cityscapes_image", "--backbone", "mobilenet",
                "--crop-size", str(MRD_CROP), "--base-size", str(MRD_CROP), "--workers",
                "0", "--seed", str(seed)]
    series_argv = [a for i, a in enumerate(MRD_ACC_ARGV) if a not in ACC_CLI_FLAGS
                   and (i == 0 or MRD_ACC_ARGV[i - 1] not in ACC_CLI_FLAGS)] + [
        "--seed", str(seed), "--dual-head"]
    replay = {}
    for name, (world, batch_size) in replays.items():
        where = root / f"replay_{name}"
        flags = ["--num-devices", str(world), "--batch-size", str(batch_size)]
        kwargs = dict(device=MR_SHARED_DEVICE, backend="gloo" if world > 1 else None)
        t0 = time.perf_counter()
        with stdout_to(where / "visualize.out"):
            visualize_torch.main(vis_argv + flags + ["--checkpoint", str(where / "best.ckpt")],
                                 dataset_root=str(root), **kwargs)
            vis_s = time.perf_counter() - t0
            eval_series_torch.main(series_argv + flags + ["--experiment-dir",
                                                          str(where / "acc")],
                                   dataset_root=str(root), **kwargs)
        folder = where / "visualizations"
        # each PNG under its name at a batch of MRD_ROWS (image g of the
        # split is img_{g // rows}_{g % rows})
        pngs = {}
        for png in folder.iterdir():
            kind, b, i = png.stem.split("_")
            g = int(b) * batch_size + int(i)
            pngs[f"{kind}_{g // MRD_ROWS:04d}_{g % MRD_ROWS:02d}.png"] = png.read_bytes()
        replay[name] = {"visualize_s": vis_s,
                        "eval_series_s": time.perf_counter() - t0 - vis_s,
                        "metrics": _printed_metrics((where / "visualize.out").read_text()),
                        "table": (where / "acc" / "validation_mIoUs.txt").read_bytes(),
                        "pngs": pngs}
    ranks_, one, batch4 = replay["ranks"], replay["one"], replay["one_batch4"]
    same_pngs = ranks_["pngs"] == one["pngs"] and len(one["pngs"]) == 3 * VAL
    differ4 = sorted(k for k in one["pngs"] if one["pngs"][k] != batch4["pngs"].get(k))
    print(f"2-rank replays (global batch {n}, {MRD_ROWS} rows per rank) vs one rank at "
          f"batch {MRD_ROWS}: visualize_torch {ranks_['visualize_s']:.3f} s (one rank "
          f"{one['visualize_s']:.3f} s), {len(ranks_['pngs'])} PNGs byte-equal: "
          f"{same_pngs}; metrics equal: {ranks_['metrics'] == one['metrics']}; "
          f"eval_series_torch --dual-head {ranks_['eval_series_s']:.3f} s (one rank "
          f"{one['eval_series_s']:.3f} s), validation_mIoUs.txt equal: "
          f"{ranks_['table'] == one['table']}. One rank at batch {n} against batch "
          f"{MRD_ROWS}: {len(differ4)} PNGs differ ({differ4[:4]}...), metrics equal: "
          f"{batch4['metrics'] == one['metrics']}, table equal: "
          f"{batch4['table'] == one['table']}", flush=True)
    check(same_pngs, f"the 2-rank PNGs equal one rank's: {sorted(ranks_['pngs'])} vs "
                     f"{sorted(one['pngs'])}")
    check(ranks_["metrics"] == one["metrics"],
          f"the 2-rank replay's metrics equal one rank's: {ranks_['metrics']} vs "
          f"{one['metrics']}")
    check(ranks_["table"] == one["table"] and len(one["table"].splitlines()) == 2,
          "the 2-rank validation_mIoUs.txt equals one rank's")
    out["replay"] = {k: {m: v for m, v in r.items() if m not in ("table", "pngs")}
                     for k, r in replay.items()}
    out["replay"]["batch4_pngs_differing"] = len(differ4)

    # (d) the SEM trainer's entry point on 2 ranks, f32
    t0 = time.perf_counter()
    with stdout_to(root / "unet_2ranks.out"):
        unet_train_torch.main(sem_argv + ["--num-devices", str(MR_WORLD)],
                              dataset_root=str(sem_root), device=MR_SHARED_DEVICE,
                              backend="gloo")
    unet_s = time.perf_counter() - t0
    lines = (root / "unet_2ranks.out").read_text().splitlines()
    numbers = []
    for token in " ".join(lines[1:]).split():
        with contextlib.suppress(ValueError):
            numbers.append(float(token))
    print(f"2-rank unet_train_torch.main (f32): {unet_s:.3f} s; {lines[-1]}", flush=True)
    check(lines[0] == "Initializing Training!" and len(lines) == SEM_EPOCHS + 2
          and lines[-1].startswith("Val loss:") and len(numbers) == 2 * 6 + SEM_EPOCHS
          and bool(np.isfinite(numbers).all()),
          f"the 2-rank unet_train_torch prints its lines: {lines}")

    # (e) the lmdb binding
    from deep_active_semantic_segmentation_torch.data import store as pt_store

    print(f"lmdb binding imports: {pt_store.HAVE_LMDB}", flush=True)
    out["lmdb"] = {"binding": pt_store.HAVE_LMDB}
    if pt_store.HAVE_LMDB:
        from deep_active_semantic_segmentation_torch.data import convert as pt_convert
        from deep_active_semantic_segmentation_torch.data.factory import make_dataloader

        sources = write_raw_datasets(root / "lmdb_raw", seed)
        lmdb_root = root / "lmdb_datasets"
        (lmdb_root / "cityscapes").mkdir(parents=True)
        for split in ("train", "val"):
            pt_convert.main(["cityscapes", str(sources[0]), split,
                             str(lmdb_root / "cityscapes" / f"{split}.db"), "--lmdb",
                             "--seed-set-count", "2"])
        train_set, _, val_loader, _, _ = make_dataloader(
            "active_cityscapes_image", 513, 513, 2, dataset_root=str(lmdb_root),
            device=DEVICE)
        batches = list(val_loader)
        check(isinstance(train_set.store, pt_store.LmdbStore) and len(batches) >= 1,
              "a converted LMDB store loads through the factory")
        out["lmdb"]["val_batches"] = len(batches)
    out.update(accuracy_main_s=acc_s, unet_main_s=unet_s)
    return out

# ------------------------------- slices 12-13: the spatial (height) axis

# every model JAX's spatial step takes, at full width: slice 12's
# DeepLab-MobileNetV2 os16 and slice 13's DeepLab-ResNet-101 os16 (the
# heaviest configuration), ENet and FastSCNN at Cityscapes' full frame
# (what the spatial axis is for: JAX's steps.py:100-101, "used for
# full-resolution inputs"), 19 classes, and the UNet as
# unet_train_torch.py builds it (1 input channel, 2 classes, SEM's
# normalization) at the SEM frame; two gloo ranks sharing the card as a
# (1x2) mesh, each holding half the rows
SP_HW = (1024, 2048)
SP_MODELS = {
    "deeplab_mobilenet": dict(label="DeepLab-MobileNetV2 os16", arch="deeplab",
                              build=dict(backbone="mobilenet", output_stride=16,
                                         mc_dropout=True)),
    # f32 bar: the JAX package's own f32 spatial step parts from its
    # unsharded one by 4.7e-2 of the largest weight on DeepLab-ResNet-50
    # (CPU, side 64, train-mode BN: ASPP's pool-branch BN normalizes two
    # near-equal values per channel, one per image, and rounds them apart)
    "deeplab_resnet101": dict(label="DeepLab-ResNet-101 os16", arch="deeplab",
                              build=dict(backbone="resnet101", output_stride=16,
                                         mc_dropout=True), f32_rtol=5e-3),
    "enet": dict(label="ENet", arch="enet", build={}),
    "fastscnn": dict(label="FastSCNN", arch="fastscnn", build={}),
    "unet": dict(label="UNet (SEM, 1 channel, 2 classes)", arch="unet",
                 build=dict(input_channels=1), hw=SEM_HW, classes=2, channels=1),
}
SP_IMAGES = 2              # the f32 and bf16 steps' images (f64: 1)
SP_TIMED_STEPS = 3         # timed bf16 steps after the compared one
SP_BLOCK = 128             # label blocks of 128 px; the top fifth ignored
SP_JOIN_S = 900            # the spawn's limit: every model in turn on its ranks
# bars against one process: the f64 step's state (BN running statistics
# included) as the CPU tests hold it (1e-13-1e-12 measured at side 64);
# every port loss computes in f32, so an f64 step's loss is held to f32
# rounding; f32 (TF32 off) as JAX's own spatial step against its
# unsharded one for DeepLab-MobileNetV2 (2.9e-4 of the largest weight): a
# half-height band has cuDNN pick other kernels and round its sums in
# another order
SP_F64_RTOL, SP_F64_LOSS_RTOL = 1e-10, 1e-6
SP_F32_RTOL, SP_F32_LOSS_RTOL = 5e-4, 1e-5


def _sp_batch(torch, state, n: int, device, rows=slice(None)):
    return {k: torch.from_numpy(state[k][:n, rows]).to(device) for k in ("image", "label")}


def _sp_steps(torch, state, device, mesh=None) -> dict:
    """The f64 step on 1 image and the f32 step on SP_IMAGES (TF32 off),
    then the bf16 step on SP_IMAGES timed, with the peak memory the f64
    and the bf16 steps add to what the process held, of the model
    ``state`` describes (``SP_MODELS``, its weights and images; its
    ``remat``, the steps' activation recompute; ``f32`` False: no f32
    step): on the whole images (``mesh`` None) or on this rank's band
    (the spatial step)."""
    from deep_active_semantic_segmentation_torch.parallel.spatial import shard_rows

    rows = (slice(*shard_rows(state["image"].shape[1], mesh, state["row_multiple"]))
            if mesh is not None else slice(None))
    spatial = mesh is not None
    out = {}
    t0 = time.perf_counter()
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype, n in (("float64", 1), ("float32", SP_IMAGES))[
                :1 + state.get("f32", True)]:
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            model, _, out[f"{dtype}_loss"] = _mr_step(
                torch, state, _sp_batch(torch, state, n, device, rows),
                dtype, device, mesh, spatial=spatial, remat=state.get("remat", False))
            out[f"{dtype}_peak_gib"] = (torch.cuda.max_memory_allocated(device)
                                        - base) / 2**30
            out[f"{dtype}_state"] = _state(model)
            del model
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    batch = _sp_batch(torch, state, SP_IMAGES, device, rows)
    model, step, out["bf16_loss"] = _mr_step(torch, state, batch, "bfloat16",
                                             device, mesh, spatial=spatial,
                                             remat=state.get("remat", False))
    it = iter(range(1, 1 + SP_TIMED_STEPS))
    out["bf16_step_ms"] = _device_ms(torch, device, lambda: step(batch, next(it)),
                                     SP_TIMED_STEPS)
    out["bf16_peak_gib"] = (torch.cuda.max_memory_allocated(device) - base) / 2**30
    del model, step, batch
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def spatial_worker(mesh, setup_path: str, out_dir: str) -> None:
    """One rank of the spatial phase: ``_sp_steps`` on its band, for each
    model of the setup in turn. Saves ``rank<r>.pt`` in ``out_dir``."""
    import torch

    setup = torch.load(setup_path, weights_only=False)
    out = {name: _sp_steps(torch, state, mesh.device, mesh)
           for name, state in setup.items()}
    out.update(rank=mesh.rank, device=str(mesh.device))
    torch.save(out, str(Path(out_dir) / f"rank{mesh.rank}.pt"))


def _sp_setup(torch, seed: int, dev) -> dict:
    """Each of ``SP_MODELS`` with its weights (BN biases drawn off the
    ReLU kinks), its row multiple and its SP_IMAGES uint8 images and
    labels at its frame (label blocks of SP_BLOCK px, the top fifth of
    the rows ignored: all in rank 0's band)."""
    from deep_active_semantic_segmentation_torch.data import sem
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.parallel.spatial import row_multiple

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    setup = {}
    for name, spec in SP_MODELS.items():
        h, w = spec.get("hw", SP_HW)
        classes = spec.get("classes", NUM_CLASSES)
        label = np.kron(rng.randint(0, classes, (SP_IMAGES, h // SP_BLOCK, w // SP_BLOCK)),
                        np.ones((1, SP_BLOCK, SP_BLOCK), np.int64)).astype(np.uint8)
        label[:, :h // 5] = 255
        image = rng.randint(0, 256, label.shape + (spec.get("channels", 3),),
                            dtype=np.uint8)
        model = _off_the_kinks(torch, build_model(spec["arch"], classes, device=dev,
                                                  generator=gen, **spec["build"]), gen)
        setup[name] = dict(arch=spec["arch"], build=spec["build"], classes=classes,
                           norm=(sem.MEAN, sem.STD) if spec["arch"] == "unet" else None,
                           weights=_state(model), row_multiple=row_multiple(model),
                           image=image, label=label)
        del model
    return setup


def _dryrun_launches(line: str) -> list:
    """The per-rank B1 launches a dryrun_multichip line reports."""
    return json.loads(line.split("upsample4_argmax_launches=")[1].split("]")[0] + "]")


def spatial_phase(torch, seed: int, root: Path) -> dict:
    """Slices 12-13: (a) each model's height-sharded step (``SP_MODELS``:
    DeepLab-MobileNetV2 and DeepLab-ResNet-101 os16, ENet and FastSCNN at
    1024x2048, the SEM UNet at 768x1024) on two gloo ranks sharing the
    card as a (1x2) mesh (and one rank per card over NCCL where two cards
    are visible; one spawn runs every model) against one process on the
    whole images: f64 and f32 (TF32 off) gaps, BN running statistics,
    the bf16 step per rank and each rank's peak memory against one
    process's. (b) dryrun_multichip(2) in JAX's layout (1x2) and on the
    data-only (2x1) mesh, gloo ranks sharing the card, with each rank's
    B1 launches; dryrun_multichip(4) over NCCL as (2x2) where four cards
    are visible."""
    from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
    from deep_active_semantic_segmentation_torch.parallel.dryrun import (
        dryrun_multichip)

    dev = torch.device(DEVICE)
    setup = _sp_setup(torch, seed, dev)
    out, ref = {"models": {}}, {}
    for name, state in setup.items():
        ref[name] = _sp_steps(torch, state, dev)
        out["models"][name] = {"one_process": {k: v for k, v in ref[name].items()
                                               if not k.endswith("_state")}}
    setup_path = root / "spatial_setup.pt"
    torch.save(setup, str(setup_path))
    routes = [("gloo", MR_SHARED_DEVICE)]
    if torch.cuda.device_count() >= MR_WORLD:
        routes.append(("nccl", None))
    for backend, device in routes:
        out_dir = root / f"spatial_{backend}"
        out_dir.mkdir()
        t0 = time.perf_counter()
        pt_mesh.launch(spatial_worker, (str(setup_path), str(out_dir)),
                       num_devices=MR_WORLD, device=device, backend=backend,
                       timeout=MR_GROUP_S, join_timeout=SP_JOIN_S, spatial=MR_WORLD)
        ranks = [torch.load(str(out_dir / f"rank{r}.pt"), weights_only=False)
                 for r in range(MR_WORLD)]
        out[f"{backend}_wall_s"] = time.perf_counter() - t0
        where = ("two ranks sharing the card: collectives through the host"
                 if device else "one rank per card")
        for name, state in setup.items():
            label, (h, w) = SP_MODELS[name]["label"], state["image"].shape[1:3]
            route = out["models"][name][f"{backend}_ranks"] = {}
            one = ref[name]
            f32_bar = SP_MODELS[name].get("f32_rtol", SP_F32_RTOL)
            for dtype, n, bar, loss_bar in (("float64", 1, SP_F64_RTOL, SP_F64_LOSS_RTOL),
                                            ("float32", SP_IMAGES, f32_bar,
                                             SP_F32_LOSS_RTOL)):
                want = one[f"{dtype}_state"]
                got = ranks[0][name][f"{dtype}_state"]
                loss_rel = abs(ranks[0][name][f"{dtype}_loss"] - one[f"{dtype}_loss"]) / abs(
                    one[f"{dtype}_loss"])
                gap, worst = _param_gaps(got, want)
                worst_name = max((k for k in want if want[k].is_floating_point()),
                                 key=lambda k: (got[k] - want[k]).abs().max().item()
                                 / max(want[k].abs().max().item(), 1e-30))
                running = [k for k in want if "running_" in k]
                bn_gap = max((got[k] - want[k]).abs().max().item()
                             / want[k].abs().max().item() for k in running)
                same = all(torch.equal(got[k], ranks[1][name][f"{dtype}_state"][k])
                           for k in want)
                print(f"spatial ({backend}, (1x{MR_WORLD}) mesh, {where}): {label} "
                      f"{dtype} step at {h}x{w}, {n} image(s), {h // MR_WORLD} rows per "
                      f"rank, vs one process on the whole image(s): loss rel "
                      f"{loss_rel:.2e} (bar {loss_bar}); parameters {gap:.2e} of the "
                      f"largest weight (bar {bar}), worst tensor {worst:.2e} of its own "
                      f"({worst_name}); BN running statistics {bn_gap:.2e} of each "
                      f"buffer's largest; "
                      f"ranks equal: {same}", flush=True)
                check(same, f"spatial {backend} {name} {dtype}: both ranks hold the "
                            "same state")
                check(loss_rel <= loss_bar, f"spatial {backend} {name} {dtype}: the "
                                            "loss is one process's")
                check(gap <= bar, f"spatial {backend} {name} {dtype}: the updated state "
                                  "is one process's")
                route[dtype] = {"loss_rel": loss_rel, "param_rel": gap,
                                "worst_tensor": worst, "worst_tensor_name": worst_name,
                                "bn_running_rel": bn_gap}
            mine = [r[name] for r in ranks]
            bf16_rel = abs(mine[0]["bf16_loss"] - one["bf16_loss"]) / abs(one["bf16_loss"])
            route["bf16_loss_rel"] = bf16_rel
            route["ranks"] = [{k: v for k, v in r.items() if not k.endswith("_state")}
                              for r in mine]
            print(f"  {label}: bf16 loss rel {bf16_rel:.2e} (bar {MR_BF16_RTOL}); step "
                  f"per rank {[round(r['bf16_step_ms'], 1) for r in mine]} ms (one "
                  f"process on the whole images {one['bf16_step_ms']:.1f} ms); peak "
                  f"memory per rank {[round(r['bf16_peak_gib'], 3) for r in mine]} GiB "
                  f"(one process {one['bf16_peak_gib']:.3f} GiB; f64 step "
                  f"{[round(r['float64_peak_gib'], 3) for r in mine]}, one process "
                  f"{one['float64_peak_gib']:.3f} GiB); seconds one process "
                  f"{one['s']:.1f}, ranks {[round(r['s'], 1) for r in mine]}", flush=True)
            check(mine[0]["bf16_loss"] == mine[1]["bf16_loss"] and bf16_rel <= MR_BF16_RTOL,
                  f"spatial {backend} {name}: the bf16 loss is the whole images' on "
                  "both ranks")
            check(all(r["bf16_peak_gib"] < one["bf16_peak_gib"] for r in mine),
                  f"spatial {backend} {name}: each rank's peak memory is below one "
                  "process's")
            out["models"][name]["s"] = out["models"][name].get("s", one["s"]) + max(
                r["s"] for r in mine)

    # (b) the dry run in JAX's layout and on the data-only mesh
    dryruns = [(MR_WORLD, None, MR_SHARED_DEVICE, "gloo"),
               (MR_WORLD, 1, MR_SHARED_DEVICE, "gloo")]
    if torch.cuda.device_count() >= 4:
        dryruns.append((4, None, None, None))
    out["dryruns"] = []
    for n, spatial, device, backend in dryruns:
        t0 = time.perf_counter()
        line = dryrun_multichip(n, device=device, backend=backend,
                                join_timeout=MR_JOIN_S, spatial=spatial)
        launches = _dryrun_launches(line)
        s_axis = 2 if spatial is None else spatial
        out["dryruns"].append({"line": line, "s": time.perf_counter() - t0,
                               "launches_per_rank": launches})
        check(line.startswith(f"dryrun_multichip: n={n} mesh=({n // s_axis}x{s_axis})")
              and line.endswith("OK"), f"dryrun_multichip({n}) as ({n // s_axis}x{s_axis})")
        check(len(launches) == n and all(c > 0 for c in launches),
              f"B1 launched on every rank of the dry run: {launches}")
    return out


# ------------------------------------------------- slice 15: activation recompute

# --remat (parallel/remat.py): the spatial phase's one-headed models
# (SP_MODELS, the weights and images _sp_setup draws) at their full frames
# on SP_IMAGES images, and the two-headed step at the accuracy-predictor
# phases' geometry (Pascal's 512 letterbox, batch 5, 21 classes), in one
# process, plain against remat from one dropout generator seed
RM_TIMED_STEPS = 5         # timed bf16 steps after the compared one
RM_DUAL_BATCH = 5
# f32 (TF32 off, cuDNN deterministic) remat against plain after one step:
# the loss and BN running statistics (the forward's, deterministic) within
# this share of the largest, the parameters within it or within
# RM_F32_NOISE times a second plain step's own gap to the first, whichever
# is larger: the backward's atomic adds (the resizes' gradients) round in
# any order, and train-mode BN amplifies it (plain against plain 2.3e-6 of
# the largest weight on DeepLab-ResNet-101 at 1024x2048, 5.8e-8 on
# MobileNetV2: NVIDIA H100 80GB HBM3 at 700 W, this phase's first runs)
RM_F32_RTOL = 1e-6
RM_F32_NOISE = 10
# the model whose bf16 step is profiled each way (torch.profiler)
RM_PROFILED = "deeplab_resnet101"
RM_JOIN_S = 600            # the spawn's limit
# the (2x1) data-parallel f64 step's crop of each rank's image (rows,
# columns): what it checks is the order of the recompute's collectives
# beside DDP's, which does not depend on the size
RM_DATA_CROP = (512, 1024)


def _rm_dual_step(torch, state, batch, dtype: str, device, generator=None,
                  remat=False):
    """One SGD step (lr 0.01, class-free CE, error classes [0.75, 0.25],
    (w_dl, w_un) = ACC_WEIGHTS) of the two-headed model (DeepLab-v3+/
    MobileNetV2 and the UNet error head) loaded from ``state``, dropout
    from ``generator``: (model, step(batch, i), the step's loss), as
    ``_mr_step`` returns them."""
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_dual_train_step)

    model = build_model("accuracy_predictor", state["classes"], device=device,
                        **state["build"])
    model.load_state_dict(state["weights"])
    model.train()
    dual = make_dual_train_step(
        model, build_optimizer("SGD", param_groups(model, "accuracy_predictor")),
        build_loss("ce"), build_loss("ce", class_weights=torch.tensor(
            [0.75, 0.25], device=device)), constant_schedule(0.01),
        compute_dtype=dtype, generator=generator, remat=remat)

    def step(b, i):
        return dual(b, i, *ACC_WEIGHTS)

    return model, step, float(step(batch, 0)["loss"])


def _rm_run(torch, make, state, batch, dtype: str, device, seed: int, remat: bool,
            timed: int = 0, profile: str = None) -> dict:
    """One step of a fresh model (``make``: ``_mr_step`` or
    ``_rm_dual_step``), dropout from a generator on the card seeded with
    ``seed``, then ``timed`` more, timed: its loss, the generator's state
    after the first step, the model's state (untimed runs), ms per timed
    step and the peak memory above what the process held; with
    ``profile`` (a label), one more step's ``profile_sweep``."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model, step, loss = make(torch, state, batch, dtype, device, generator=gen,
                             remat=remat)
    out = {"loss": loss, "generator": gen.get_state()}
    if timed:
        it = iter(range(1, 1 + timed))
        out["step_ms"] = _device_ms(torch, device, lambda: step(batch, next(it)), timed)
    else:
        out["state"] = _state(model)
    out["peak_gib"] = (torch.cuda.max_memory_allocated(device) - base) / 2**30
    if profile:
        out["profile"] = profile_sweep(torch, lambda: step(batch, timed + 1), profile)
    del model, step
    torch.cuda.empty_cache()
    return out


def _rm_gap(got: dict, want: dict, running: bool) -> float:
    """The largest difference of ``got``'s parameters (``running``: BN
    running statistics) from ``want``'s over the largest of them."""
    keys = [k for k, v in want.items() if v.is_floating_point()
            and ("running_" in k) == running]
    scale = max(want[k].abs().max().item() for k in keys)
    return max((got[k] - want[k]).abs().max().item() for k in keys) / scale


def _rm_compare(torch, label: str, make, state, batch, device, seed: int,
                profile: bool = False) -> dict:
    """Plain against remat for one model: the bf16 step timed (ms, peak
    GiB) each way (``profile``: and profiled); then one f32 step each way
    and a second plain one (TF32 off, cuDNN deterministic): the loss,
    parameter and BN-statistics gaps, ``num_batches_tracked`` and the
    generators' states."""
    bf16 = {mode: _rm_run(torch, make, state, batch, "bfloat16", device, seed,
                          mode == "remat", timed=RM_TIMED_STEPS,
                          profile=f"one bf16 {mode} step, {label}" if profile else None)
            for mode in ("plain", "remat")}
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        plain, remat, again = (_rm_run(torch, make, state, batch, "float32", device,
                                       seed, r) for r in (False, True, False))
    finally:
        (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         cudnn.deterministic, cudnn.benchmark) = saved
    want = plain["state"]
    out = {"bf16": {m: {k: v for k, v in r.items() if k != "generator"}
                    for m, r in bf16.items()},
           "f32_loss_rel": abs(remat["loss"] - plain["loss"]) / abs(plain["loss"]),
           "f32_param_rel": _rm_gap(remat["state"], want, False),
           "f32_bn_running_rel": _rm_gap(remat["state"], want, True),
           "f32_plain_noise_param_rel": _rm_gap(again["state"], want, False),
           "num_batches_tracked_equal": all(
               torch.equal(remat["state"][k], v) for k, v in want.items()
               if not v.is_floating_point()),
           "generators_equal": torch.equal(remat["generator"], plain["generator"]),
           "f32_peak_gib": {"plain": plain["peak_gib"], "remat": remat["peak_gib"]}}
    p, r = bf16["plain"], bf16["remat"]
    bar = max(RM_F32_RTOL, RM_F32_NOISE * out["f32_plain_noise_param_rel"])
    out["f32_param_bar"] = bar
    print(f"remat: {label}, dropout on: bf16 step plain {p['step_ms']:.1f} ms, remat "
          f"{r['step_ms']:.1f} ms ({r['step_ms'] / p['step_ms']:.2f}x); peak plain "
          f"{p['peak_gib']:.3f} GiB, remat {r['peak_gib']:.3f} GiB "
          f"({100 * r['peak_gib'] / p['peak_gib']:.1f}%); bf16 loss plain "
          f"{p['loss']:.6f}, remat {r['loss']:.6f}; f32 (TF32 off, cuDNN "
          f"deterministic) remat vs plain: loss rel {out['f32_loss_rel']:.2e}, "
          f"parameters {out['f32_param_rel']:.2e} of the largest weight (plain vs "
          f"plain {out['f32_plain_noise_param_rel']:.2e}; bar {bar:.2e}), BN "
          f"running statistics {out['f32_bn_running_rel']:.2e}, num_batches_tracked "
          f"equal {out['num_batches_tracked_equal']}, generator states equal "
          f"{out['generators_equal']}; f32 peak plain {plain['peak_gib']:.3f} GiB, "
          f"remat {remat['peak_gib']:.3f} GiB", flush=True)
    check(np.isfinite([p["loss"], r["loss"]]).all(), f"remat {label}: bf16 losses finite")
    check(r["peak_gib"] < p["peak_gib"], f"remat {label}: the bf16 peak memory is "
                                         "below the plain step's")
    check(out["f32_param_rel"] <= bar and out["f32_bn_running_rel"] <= RM_F32_RTOL
          and out["f32_loss_rel"] <= RM_F32_RTOL,
          f"remat {label}: the f32 step is the plain step's")
    check(out["num_batches_tracked_equal"] and out["generators_equal"],
          f"remat {label}: BN counted once, the dropout generator where the plain "
          "step leaves it")
    return out


def remat_worker(mesh, setup_path: str, out_dir: str) -> None:
    """One rank of the remat phase's (1x2) spawn: ``_sp_steps`` of each
    setup entry (DeepLab-ResNet-101, plain and with ``remat``; f64 and
    bf16) on its band; then, on the (2x1) mesh of the same two ranks,
    each entry's data-parallel f64 step on its image's RM_DATA_CROP
    (TF32 off). Saves ``rank<r>.pt`` in ``out_dir``."""
    import dataclasses

    import torch

    setup = torch.load(setup_path, weights_only=False)
    device = mesh.device
    out = {name: _sp_steps(torch, state, device, mesh) for name, state in setup.items()}
    data = dataclasses.replace(mesh, spatial=1, spatial_group=None, data_group=None)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, state in setup.items():
            rows, cols = RM_DATA_CROP
            batch = {k: torch.from_numpy(state[k][data.rank:data.rank + 1, :rows, :cols])
                     .to(device) for k in ("image", "label")}
            model, _, loss = _mr_step(torch, state, batch, "float64", device, data,
                                      remat=state.get("remat", False))
            out[name]["data_float64_loss"] = loss
            out[name]["data_float64_state"] = _state(model)
            del model
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    out.update(rank=mesh.rank, device=str(device))
    torch.save(out, str(Path(out_dir) / f"rank{mesh.rank}.pt"))


def remat_phase(torch, seed: int, root: Path, plain_round: dict) -> dict:
    """Slice 15, ``--remat``: (a) each one-headed model of the spatial
    phase at its full frame (DeepLab-MobileNetV2 and DeepLab-ResNet-101
    os16, ENet, FastSCNN at 1024x2048, the SEM UNet at 768x1024; 2
    images) and (b) the two-headed step at Pascal's 512 letterbox (batch
    5), plain against remat in one process (``_rm_compare``); (c) one
    canonical `variance` round through ``active_train_torch.main
    --remat`` at the AL-round phase's cut (launch counts set to 0 just
    before and read just after: B1 as often as in that phase's plain
    round, ``plain_round``); (d) DeepLab-ResNet-101 on a (1x2) mesh of
    two gloo ranks sharing the card (and one rank per card over NCCL
    where two cards are visible), plain and with remat (``remat_worker``):
    the spatial step in f64 and bf16 and the data-parallel f64 step on
    the (2x1) mesh of the same ranks, remat against plain."""
    import active_train_torch
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh

    dev = torch.device(DEVICE)
    out = {"models": {}}
    reset_counts()
    setup = _sp_setup(torch, seed, dev)
    for name, state in setup.items():
        t0 = time.perf_counter()
        h, w = state["image"].shape[1:3]
        batch = _sp_batch(torch, state, SP_IMAGES, dev)
        out["models"][name] = _rm_compare(
            torch, f"{SP_MODELS[name]['label']} at {h}x{w}, {SP_IMAGES} images",
            _mr_step, state, batch, dev, seed, profile=name == RM_PROFILED)
        out["models"][name]["s"] = time.perf_counter() - t0

    # (b) the two-headed step
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dual = dict(classes=PASCAL_CLASSES, build=dict(backbone="mobilenet", mc_dropout=True))
    model = _off_the_kinks(torch, build_model("accuracy_predictor", PASCAL_CLASSES,
                                              device=dev, generator=gen,
                                              **dual["build"]), gen)
    dual["weights"] = _state(model)
    del model
    blocks = ACC_BASE // 32
    label = np.kron(rng.randint(0, PASCAL_CLASSES, (RM_DUAL_BATCH, blocks, blocks)),
                    np.ones((1, 32, 32), np.int64)).astype(np.uint8)
    label[:, :ACC_BASE // 8] = 255
    image = rng.randint(0, 256, label.shape + (3,), dtype=np.uint8)
    batch = {"image": torch.from_numpy(image).to(dev),
             "label": torch.from_numpy(label).to(dev)}
    out["dual"] = _rm_compare(torch, f"two-headed DeepLab-MobileNetV2 + UNet at "
                                     f"{ACC_BASE}x{ACC_BASE}, batch {RM_DUAL_BATCH}",
                              _rm_dual_step, dual, batch, dev, seed)
    out["dual"]["s"] = time.perf_counter() - t0

    check(not any(read_counts().values()),
          f"no B1 or B2 launch in the remat steps: {read_counts()}")

    # (c) the canonical round with --remat
    argv = ROUND_ARGV + ["--remat", "--num-devices", "1", "--seed", str(seed),
                         "--checkname", "round_remat"]
    reset_counts()
    t0 = time.perf_counter()
    history = active_train_torch.main(argv, device=DEVICE, dataset_root=str(root),
                                      runs_root=str(root / "runs"))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    exp = root / "runs" / "active_cityscapes_image"
    picks = {name: [(exp / name / d / "selections.txt").read_text().splitlines()
                    for d in sorted(p.name for p in (exp / name).iterdir()
                                    if p.name.startswith("run_"))]
             for name in ("round", "round_remat")}
    rounds = [history[k]["seconds"] for k in sorted(history)]
    out["round"] = {"wall_s": wall_s, "counts": counts,
                    "selections": [len(s) for s in picks["round_remat"]],
                    "picks_equal_plain": picks["round"] == picks["round_remat"],
                    "rounds": [history[k] for k in sorted(history)]}
    print(f"remat: variance round through active_train_torch.main --remat: "
          f"{wall_s:.3f} s for 2 rounds (plain round {plain_round['wall_s']:.3f} s); "
          f"round 0 train s {rounds[0]['train']:.3f} (plain "
          f"{plain_round['rounds'][0]['seconds']['train']:.3f}); selections "
          f"{out['round']['selections']}; picks equal the plain round's: "
          f"{out['round']['picks_equal_plain']}; launches {json.dumps(counts)} (plain "
          f"{json.dumps(plain_round['counts'])})", flush=True)
    check(out["round"]["selections"] == [SEED_SET, SEED_SET + 5],
          f"the remat round's selections: {out['round']['selections']}")
    check(counts == plain_round["counts"] and counts["upsample4_argmax"] > 0,
          f"the remat round selects through B1 as often as the plain round: "
          f"{counts} against {plain_round['counts']}")

    # (d) DeepLab-ResNet-101 on two ranks, plain and with remat
    rn101 = setup["deeplab_resnet101"]
    spawn_setup = {"plain": dict(rn101, f32=False),
                   "remat": dict(rn101, f32=False, remat=True)}
    setup_path = root / "remat_setup.pt"
    torch.save(spawn_setup, str(setup_path))
    del setup, spawn_setup
    routes = [("gloo", MR_SHARED_DEVICE)]
    if torch.cuda.device_count() >= MR_WORLD:
        routes.append(("nccl", None))
    h = rn101["image"].shape[1]
    for backend, device in routes:
        out_dir = root / f"remat_{backend}"
        out_dir.mkdir()
        t0 = time.perf_counter()
        pt_mesh.launch(remat_worker, (str(setup_path), str(out_dir)),
                       num_devices=MR_WORLD, device=device, backend=backend,
                       timeout=MR_GROUP_S, join_timeout=RM_JOIN_S, spatial=MR_WORLD)
        ranks = [torch.load(str(out_dir / f"rank{r}.pt"), weights_only=False)
                 for r in range(MR_WORLD)]
        route = out[f"resnet101_{backend}_ranks"] = {"s": time.perf_counter() - t0}
        for key in ("float64_state", "data_float64_state"):
            same = all(torch.equal(ranks[0]["remat"][key][k], ranks[1]["remat"][key][k])
                       for k in ranks[0]["remat"][key])
            gap, _ = _param_gaps(ranks[0]["remat"][key], ranks[0]["plain"][key])
            route[key.replace("_state", "")] = {"param_rel": gap, "ranks_equal": same}
            check(same, f"remat {backend} ResNet-101 {key}: both ranks hold one state")
        for r in ranks:
            for name in ("plain", "remat"):
                r[name] = {k: v for k, v in r[name].items() if not k.endswith("_state")}
        route["ranks"] = ranks
        where = ("two ranks sharing the card" if device else "one rank per card")
        print(f"remat ({backend}, {where}): DeepLab-ResNet-101 os16 at {h}x"
              f"{rn101['image'].shape[2]}, (1x{MR_WORLD}) mesh, {h // MR_WORLD} rows per "
              f"rank, remat vs plain: f64 parameters "
              f"{route['float64']['param_rel']:.2e} of the largest weight (bar "
              f"{SP_F64_RTOL}); the (2x1) data-parallel f64 step at "
              f"{RM_DATA_CROP[0]}x{RM_DATA_CROP[1]} {route['data_float64']['param_rel']:.2e}; bf16 "
              f"step per rank plain {[round(r['plain']['bf16_step_ms'], 1) for r in ranks]}"
              f" ms, remat {[round(r['remat']['bf16_step_ms'], 1) for r in ranks]} ms; "
              f"bf16 peak per rank plain "
              f"{[round(r['plain']['bf16_peak_gib'], 3) for r in ranks]} GiB, remat "
              f"{[round(r['remat']['bf16_peak_gib'], 3) for r in ranks]} GiB; "
              f"{route['s']:.1f} s", flush=True)
        check(route["float64"]["param_rel"] <= SP_F64_RTOL
              and route["data_float64"]["param_rel"] <= SP_F64_RTOL,
              f"remat {backend} ResNet-101: the f64 steps are the plain steps'")
        check(all(r["remat"]["bf16_peak_gib"] < r["plain"]["bf16_peak_gib"]
                  for r in ranks),
              f"remat {backend} ResNet-101: each rank's bf16 peak is below the plain "
              "step's")
    return out


# ------------------------------------------- slice 16: the per-op step tracer

# tools/trace_step_torch.py's modes at full width: (mode, side, batch); the
# JAX tool's 513 and batch 8, 512 for the models whose pools need it
# (FastSCNN raises at 513) and for ENet's MC scoring (its main path's crop)
TRACE_MODES = [("deeplab", 513, 8), ("dual", 513, 8), ("enet", 512, 8),
               ("enet_mc", 512, 8), ("fastscnn", 512, 8), ("unet", 512, 8)]
TRACE_WARMUP, TRACE_STEPS = 2, 3
# the kernels' symbols in a profile
KERNEL_SYMBOLS = {"upsample4_argmax": "upsample4_argmax_kernel",
                  "tconv2x_argmax_parity_major": "tconv2x_argmax_parity_major_kernel"}


def trace_phase(torch) -> dict:
    """``tools/trace_step_torch.trace`` of each TRACE_MODES mode on the
    card (TRACE_WARMUP steps, then TRACE_STEPS profiled), the launch counts
    set to 0 just before each mode and read just after: in ``enet_mc``
    B2's kernel named by its symbol in the table with MC_STEPS launches
    per step, as its counter says (MC_STEPS per step, warm-up included),
    no B1; in every train step's table neither kernel, and no launch;
    each table's device total positive and at most the step's wall time
    (CUDA events around the profiled steps). Prints each mode's device
    and wall ms per step and its top 5 ops."""
    from deep_active_semantic_segmentation_torch import constants
    from tools import trace_step_torch as tool

    out = {}
    for mode, side, batch in TRACE_MODES:
        t0 = time.perf_counter()
        reset_counts()
        table = tool.trace(mode, side, batch, DEVICE, steps=TRACE_STEPS,
                           warmup=TRACE_WARMUP, top=None)
        counts = read_counts()
        table["s"] = time.perf_counter() - t0
        table["counts"] = counts
        print(f"trace {mode} {side}^2 bs{batch}: device {table['total_ms']:.3f} ms/step "
              f"over {table['names']} op names, wall {table['wall_ms']:.3f} ms/step "
              f"(device share {table['total_ms'] / table['wall_ms']:.1%}); launches "
              f"{json.dumps(counts)}; {table['s']:.1f} s", flush=True)
        for op in table["ops"][:5]:
            print(f"  {op['ms']:9.3f} ms/step x{op['launches']:<6g} {op['name'][:110]}",
                  flush=True)
        hand = {name: [op for op in table["ops"] if symbol in op["name"]]
                for name, symbol in KERNEL_SYMBOLS.items()}
        table["hand_written"] = {name: [{"ms": op["ms"], "launches": op["launches"]}
                                        for op in ops] for name, ops in hand.items()}
        check(table["total_ms"] > 0 and table["total_ms"] <= table["wall_ms"],
              f"trace {mode}: device time {table['total_ms']} ms/step within the "
              f"wall {table['wall_ms']} ms/step")
        if mode == "enet_mc":
            b2 = hand["tconv2x_argmax_parity_major"]
            check(len(b2) == 1 and b2[0]["launches"] == constants.MC_STEPS,
                  f"trace enet_mc: B2's kernel {constants.MC_STEPS} times per step in "
                  f"the table: {table['hand_written']}")
            check(counts == {"upsample4_argmax": 0, "tconv2x_argmax_parity_major":
                             constants.MC_STEPS * (TRACE_WARMUP + TRACE_STEPS)},
                  f"trace enet_mc: B2 launched {constants.MC_STEPS} times per "
                  f"step: {counts}")
            print(f"  B2 {b2[0]['ms']:.4f} ms/step of {table['total_ms']:.3f} "
                  f"({b2[0]['ms'] / table['total_ms']:.2%})", flush=True)
        else:
            check(not any(hand.values()) and not any(counts.values()),
                  f"trace {mode}: no B1 or B2 kernel in a train step: "
                  f"{table['hand_written']}, {counts}")
        out[mode] = table
    return out


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
    from deep_active_semantic_segmentation_torch.data import native

    found = native.library_path().exists()
    t0 = time.perf_counter()
    native.get_lib()
    native_build_s = time.perf_counter() - t0
    print(f"native resampler {'load (already built)' if found else 'build (g++) and load'}"
          f": {native_build_s:.2f} s ({native.library_path().name}, "
          f"{native.get_lib().default_threads} OpenMP threads by default)", flush=True)
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
    phase_s = {}
    try:
        t0 = time.perf_counter()
        store, paths = write_dataset(tmp, args.seed)
        store_s = time.perf_counter() - t0
        paths_result = {}
        for arch in PATHS:
            t0 = time.perf_counter()
            paths_result[arch] = main_path_phase(torch, args.seed, arch, store, paths)
            phase_s[f"{arch}_query"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        training = train_phase(torch, args.seed, tmp)
        phase_s["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        training["card_vs_cpu"] = card_vs_cpu_phase(torch, args.seed)
        phase_s["card_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        al_round = al_round_phase(torch, args.seed, tmp, paths)
        phase_s["al_round"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        region = {"cityscapes": region_round_phase(torch, args.seed, tmp, paths)}
        phase_s["region_round"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        region["pascal"] = pascal_region_phase(torch, args.seed, tmp)
        phase_s["pascal_region"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        region["canonical_nms"] = canonical_nms_phase(torch, args.seed)
        phase_s["canonical_nms"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ceal = ceal_round_phase(torch, args.seed, tmp, paths)
        phase_s["ceal_round"] = time.perf_counter() - t0
        noise = {}
        for arch, modes in (("deeplab", list(NOISE_MODES)), ("enet", ["noise_feature"])):
            t0 = time.perf_counter()
            noise[arch] = noise_query_phase(torch, args.seed, arch, store, paths, modes)
            phase_s[f"{arch}_noise_queries"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        region["cityscapes_noise_variance"] = region_round_phase(
            torch, args.seed, tmp, paths, mode="noise_variance")
        phase_s["region_noise_variance_round"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        representative = representative_rounds_phase(torch, args.seed, tmp, paths)
        phase_s["coreset_and_representative_rounds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        greedy = greedy_phase(torch, args.seed,
                              Path(args.out).parent if args.out else REPO)
        phase_s["canonical_greedy"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        oracle = oracle_phase(torch, args.seed, tmp, paths)
        phase_s["oracle_modes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reset_counts()
        accuracy = {"train": accuracy_train_phase(torch, args.seed, tmp)}
        accuracy["train"]["counts"] = read_counts()
        phase_s["accuracy_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reset_counts()
        accuracy["card_vs_cpu"] = accuracy_card_vs_cpu_phase(torch, args.seed)
        accuracy["card_vs_cpu"]["counts"] = read_counts()
        phase_s["accuracy_card_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        accuracy["driver"] = accuracy_driver_phase(torch, args.seed, tmp)
        phase_s["accuracy_driver_rounds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        accuracy["queries"] = accuracy_query_phase(
            torch, args.seed, tmp, accuracy["driver"]["active_pascal_image"]["checkpoint"])
        phase_s["accuracy_queries"] = time.perf_counter() - t0
        # slice 8: train.py's path and the rest of the zoo; no phase may
        # launch B1 or B2 (training computes full logits) but the native
        # phase's dropout queries (a warm-up batch, then 4 queries of 4
        # batches, 20 MC steps each)
        from deep_active_semantic_segmentation_torch import constants

        expected = {"native": {"upsample4_argmax": constants.MC_STEPS * (1 + 4 * 4),
                               "tconv2x_argmax_parity_major": 0}}
        zoo = {}
        t0 = time.perf_counter()
        passive_root = tmp / "passive"
        write_passive_dataset(passive_root, args.seed)
        phase_s["passive_store_write"] = time.perf_counter() - t0
        slice8 = [("native", lambda: native_phase(torch, args.seed, store, paths))]
        slice8 += [(f"train_{name}", lambda name=name: zoo_train_phase(
            torch, args.seed, passive_root, name)) for name in ZOO]
        slice8 += [(f"card_vs_cpu_{arch}_{bb}", lambda arch=arch, bb=bb, side=side:
                    card_vs_cpu_phase(torch, args.seed, arch, bb, side, ("float32",)))
                   for arch, bb, side in (("deeplab", "resnet", 65),
                                          ("enet", "mobilenet", 64),
                                          ("fastscnn", "mobilenet", 64))]
        slice8 += [("train_torch_main", lambda: train_main_phase(
                        torch, args.seed, passive_root)),
                   ("transplant", lambda: transplant_phase(torch, args.seed, tmp)),
                   ("enet_dual", lambda: enet_dual_phase(torch, args.seed, tmp))]
        for name, phase in slice8:
            t0 = time.perf_counter()
            reset_counts()
            zoo[name] = phase()
            zoo[name]["counts"] = read_counts()
            phase_s[name] = time.perf_counter() - t0
            want = expected.get(name, {k: 0 for k in zoo[name]["counts"]})
            check(zoo[name]["counts"] == want,
                  f"launches in the {name} phase: {zoo[name]['counts']}, "
                  f"expected {want}")
        # slice 9: checkpoint replay, the SEM trainer and the tools; no phase
        # launches B1 or B2 but the profiling phase's traced batch (20 MC
        # steps, after a warm-up batch)
        slice9 = [("visualize", lambda: visualize_phase(torch, args.seed, tmp)),
                  ("eval_series", lambda: eval_series_phase(torch, args.seed, tmp)),
                  ("unet_train", lambda: unet_train_phase(torch, args.seed, tmp)),
                  ("convert", lambda: convert_phase(torch, args.seed, tmp)),
                  ("compare_selections", lambda: compare_selections_phase(tmp)),
                  ("profiling", lambda: profiling_phase(torch, args.seed, store, paths,
                                                        tmp))]
        replay = {}
        for name, phase in slice9:
            t0 = time.perf_counter()
            reset_counts()
            replay[name] = phase()
            replay[name]["counts"] = read_counts()
            phase_s[name] = time.perf_counter() - t0
            want = {"upsample4_argmax": constants.MC_STEPS * (name == "profiling"),
                    "tconv2x_argmax_parity_major": 0}
            check(replay[name]["counts"] == want,
                  f"launches in the {name} phase: {replay[name]['counts']}, "
                  f"expected {want}")
        # slice 10: the data-parallel ranks (their launches are counted in
        # the ranks; this process launches B1 and B2 for the one-process
        # references: a warm-up and a query each)
        t0 = time.perf_counter()
        reset_counts()
        multi_rank = multi_rank_phase(torch, args.seed, tmp, tmp / "cityscapes" / "train",
                                      paths)
        multi_rank["counts"] = read_counts()
        phase_s["multi_rank"] = time.perf_counter() - t0
        # slice 11: the drivers on N ranks; no launch of B1 or B2 here or
        # in the worker's ranks
        t0 = time.perf_counter()
        reset_counts()
        drivers = multi_rank_drivers_phase(torch, args.seed, tmp, paths)
        drivers["counts"] = read_counts()
        phase_s["multi_rank_drivers"] = time.perf_counter() - t0
        for counts in [drivers["counts"]] + drivers["rank_counts"]:
            check(not any(counts.values()),
                  f"no B1 or B2 launch in the multi_rank_drivers phase: {counts}")
        # slice 12: the spatial axis; the steps launch no kernel, the dry
        # runs' pool scoring launches B1 on every rank (counted there)
        t0 = time.perf_counter()
        reset_counts()
        spatial = spatial_phase(torch, args.seed, tmp)
        spatial["counts"] = read_counts()
        phase_s["spatial"] = time.perf_counter() - t0
        for name, model in spatial["models"].items():
            phase_s[f"spatial_{name}"] = model["s"]
        check(not any(spatial["counts"].values()),
              f"no B1 or B2 launch in this process in the spatial phase: "
              f"{spatial['counts']}")
        # slice 15: --remat; its steps launch no kernel, its round selects
        # through B1 as often as the AL-round phase's plain round (its
        # counts set to 0 just before the round and read just after)
        t0 = time.perf_counter()
        reset_counts()
        remat = remat_phase(torch, args.seed, tmp, al_round)
        phase_s["remat"] = time.perf_counter() - t0
        for name, model in remat["models"].items():
            phase_s[f"remat_{name}"] = model["s"]
        # slice 16: the per-op step tracer; its ENet MC scoring launches B2
        # 20 times per step, its train steps neither kernel (each mode's
        # counts set to 0 just before it and read just after)
        t0 = time.perf_counter()
        traces = trace_phase(torch)
        phase_s["trace"] = time.perf_counter() - t0
        for mode, table in traces.items():
            phase_s[f"trace_{mode}"] = table["s"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase seconds:", json.dumps({k: round(v, 3) for k, v in phase_s.items()}),
          flush=True)
    for row in rows:
        row["launches"] = next(r["launches"] for r in paths_result.values()
                               if PATHS[r["arch"]]["kernel"] == row["name"])
        check(row["launches"] > 0, f"{row['name']} ran on its main path")
        row["al_round_launches"] = al_round["counts"][row["name"]]
        row["region_round_launches"] = region["cityscapes"]["counts"][row["name"]]
        row["pascal_region_launches"] = region["pascal"]["counts"][row["name"]]
        row["ceal_round_launches"] = ceal["counts"][row["name"]]
        row["noise_query_launches"] = {
            f"{arch} {mode}": r["counts"][0][row["name"]]
            for arch, modes in noise.items() for mode, r in modes.items()}
        check(all(r["counts"][0][row["name"]] > 0 for arch, modes in noise.items()
                  if PATHS[arch]["kernel"] == row["name"] for r in modes.values()),
              f"{row['name']} ran on its noise paths")
        row["region_noise_variance_round_launches"] = (
            region["cityscapes_noise_variance"]["counts"][row["name"]])
        row["representative_round_launches"] = {
            mode: r["counts"][row["name"]] for mode, r in representative.items()}
        row["oracle_launches"] = (oracle["labels_counts"][row["name"]]
                                  + oracle["eval_counts"][row["name"]])
        row["accuracy_predictor_launches"] = {
            **{f"dual {p}": accuracy[p]["counts"][row["name"]]
               for p in ("train", "card_vs_cpu")},
            **{f"driver {d}": r["counts"][row["name"]]
               for d, r in accuracy["driver"].items()},
            **{f"query {q}": r["counts"][row["name"]]
               for q, r in accuracy["queries"].items() if "counts" in r}}
        check(not any(row["accuracy_predictor_launches"].values()),
              f"{row['name']}: no launch in the accuracy-predictor phases")
        row["resnet50_query_launches"] = (
            paths_result["deeplab_resnet50"]["counts"][row["name"]])
        row["zoo_training_launches"] = {name: r["counts"][row["name"]]
                                        for name, r in zoo.items()}
        row["slice9_launches"] = {name: r["counts"][row["name"]]
                                  for name, r in replay.items()}
        row["multi_rank_launches_per_rank"] = {
            route: r[f"{arch}_launches_per_rank"]
            for route, r in multi_rank.items() if route.endswith("_ranks")
            for arch in ("deeplab", "enet")
            if PATHS[arch]["kernel"] == row["name"]}
        row["multi_rank_drivers_launches"] = {
            "this process": drivers["counts"][row["name"]],
            "worker ranks": [c[row["name"]] for c in drivers["rank_counts"]]}
        row["remat_round_launches"] = remat["round"]["counts"][row["name"]]
        row["trace_launches"] = {mode: t["counts"][row["name"]]
                                 for mode, t in traces.items()}
        if row["name"] == "upsample4_argmax":   # the dry runs score with DeepLab
            row["spatial_dryrun_launches_per_rank"] = {
                d["line"].split(" loss=")[0].split(" ", 1)[1]: d["launches_per_rank"]
                for d in spatial["dryruns"]}
    check(paths_result["deeplab_resnet50"]["launches"] == 80,
          "B1 launched 80 times in the ResNet-50 variance query")

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "build_s": build_s, "native_build_s": native_build_s,
             "store_write_s": store_s,
             "sass_tensor_ops": sass, "phase_s": phase_s,
             "kernels": rows, "main_paths": paths_result,
             "training": training, "al_round": al_round, "region": region,
             "ceal": ceal, "noise": noise, "representative": representative,
             "greedy": greedy, "oracle": oracle, "accuracy": accuracy,
             "zoo": zoo, "replay": replay, "multi_rank": multi_rank,
             "multi_rank_drivers": drivers, "spatial": spatial, "remat": remat,
             "trace": traces},
            indent=1, default=str))
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: v for k, v in row.items() if k != "checks"}
                                  for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
