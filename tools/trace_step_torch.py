"""Per-op device time of the port's train steps and of ENet's MC scoring
(the counterpart of the JAX package's ``tools/trace_step.py``).

It builds the JAX tool's steps from the port's parts: a train step of
DeepLab-v3+/MobileNetV2 (os16), ENet, FastSCNN or the 3-channel UNet, or
the two-headed accuracy predictor's step (loss weights 1.0 and 0.3), each
SGD with momentum 0.9 and weight decay 5e-4 (no Nesterov) at a constant lr
of 0.01 over the models' lr-multiplier groups, bf16 autocast, dropout on,
19 classes, on one fixed batch; or, for ``enet_mc``, one batch of ENet's
MC-dropout vote-entropy scoring (``selection/kernels.mc_vote_entropy_maps``,
20 dropout steps in bf16 through the fused B2 kernel). It runs WARMUP
steps, then profiles STEPS more with ``torch.profiler``
(``utils/profiling.trace``) and prints the device time per op name, worst
first (``utils/profiling.op_table``: the card's kernels, or with
``--device cpu`` the host ops' self time), with the step's wall time
(CUDA events on the card).

Usage:
    python tools/trace_step_torch.py deeplab|enet|fastscnn|unet|dual|enet_mc \\
        [side] [batch] [--device cpu] [--steps N]

It runs on the card unless ``--device cpu`` is given, and raises without
one. FastSCNN at side 513 raises the model's ValueError (its fusion needs
ceil(side / 8) to be a multiple of 4); give it 512.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deep_active_semantic_segmentation_torch import constants, resolve_device  # noqa: E402
from deep_active_semantic_segmentation_torch.utils import profiling  # noqa: E402

MODES = ("deeplab", "enet", "fastscnn", "unet", "dual", "enet_mc")
NUM_CLASSES = 19
SIDE, BATCH = 513, 8
WARMUP, STEPS, TOP = 2, 3, 25
LR = 0.01
SGD = SimpleNamespace(momentum=0.9, weight_decay=5e-4, nesterov=False)
DUAL_WEIGHTS = (1.0, 0.3)   # (w_dl, w_un)


def build(mode: str, side: int = SIDE, batch: int = BATCH, device=None,
          compute_dtype: str = "bfloat16", dropout: bool = True, seed: int = 0):
    """``(run, model, data)``: ``run(i)`` is step ``i`` of ``mode`` on the
    fixed batch ``data`` ({'image': (B, side, side, 3) f32 normal draws,
    taken as normalized, 'label'}) and returns a tensor that is ready when
    the step is: a train step's loss, or ``enet_mc``'s per-image mean
    vote entropy. A train mode's model is in train mode; ``dropout=False``
    builds its step without dropout (the tests hold it against JAX that
    way). ``model`` is what the step updates or scores with."""
    if mode not in MODES:
        raise ValueError(f"mode '{mode}' is not one of {MODES}")
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn((batch, side, side, 3), generator=gen, device=device)
    if mode == "enet_mc":
        from deep_active_semantic_segmentation_torch.selection import kernels

        model = kernels.cast_for_mc(
            build_model("enet", NUM_CLASSES, mc_dropout=True, device=device,
                        generator=gen), compute_dtype)
        labels = torch.zeros((batch, side, side), dtype=torch.uint8, device=device)

        def score(i):
            maps = kernels.mc_vote_entropy_maps(
                model, images, labels, kernels.mc_generator(seed, i, device),
                NUM_CLASSES, constants.MC_STEPS, "dropout", fused_upsample=True,
                compute_dtype=compute_dtype)
            return maps.mean(dim=(1, 2))

        return score, model, {"image": images, "label": labels}

    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_dual_train_step, make_train_step)

    arch = "accuracy_predictor" if mode == "dual" else mode
    model = build_model(arch, NUM_CLASSES, backbone="mobilenet", output_stride=16,
                        device=device, generator=gen).train()
    labels = np.random.RandomState(seed).randint(0, NUM_CLASSES, (batch, side, side))
    data = {"image": images,
            "label": torch.from_numpy(labels.astype(np.uint8)).to(device)}
    optimizer = build_optimizer("SGD", param_groups(model, arch), SGD)
    drops = (torch.Generator(device=device).manual_seed(seed + 1) if dropout
             else None)
    if mode == "dual":
        step = make_dual_train_step(model, optimizer, build_loss("ce"), build_loss("ce"),
                                    constant_schedule(LR), compute_dtype, drops)
        return (lambda i: step(data, i, *DUAL_WEIGHTS)["loss"]), model, data
    step = make_train_step(model, optimizer, build_loss("ce"), constant_schedule(LR),
                           compute_dtype, drops)
    return (lambda i: step(data, i)["loss"]), model, data


def trace(mode: str, side: int = SIDE, batch: int = BATCH, device=None,
          steps: int = STEPS, warmup: int = WARMUP, top=TOP) -> dict:
    """Build ``mode``, run ``warmup`` steps, profile ``steps`` more:
    ``profiling.op_table``'s table per step (``top`` ops; None: all) plus
    ``wall_ms`` per step (CUDA events around the profiled steps on the
    card, the host clock on the CPU), with the mode, side, batch and
    device."""
    device = resolve_device(device)
    run, _, _ = build(mode, side, batch, device)
    for i in range(warmup):
        out = run(i)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profiling.trace(None, record=True) as prof:
        t0 = time.perf_counter()
        if cuda:
            start.record()
        for i in range(warmup, warmup + steps):
            out = run(i)
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
        out.cpu()
        wall_s = time.perf_counter() - t0
    table = profiling.op_table(prof, steps, device.type, top)
    wall_ms = start.elapsed_time(end) if cuda else wall_s * 1e3
    table.update(mode=mode, side=side, batch=batch, device=str(device),
                 steps=steps, wall_ms=wall_ms / steps)
    return table


def format_table(table: dict) -> str:
    """The JAX tool's printout: the total, then the table's ops per step."""
    lines = [f"traced {table['steps']} steps of {table['mode']} {table['side']}^2 "
             f"bs{table['batch']} on {table['device']}",
             f"total device time {table['total_ms']:.3f} ms/step over "
             f"{table['names']} op names; wall {table['wall_ms']:.3f} ms/step"]
    lines += [f"  {op['ms']:8.3f} ms/step x{op['launches']:<5g} {op['name'][:120]}"
              for op in table["ops"]]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="deeplab", choices=MODES)
    ap.add_argument("side", nargs="?", type=int, default=SIDE)
    ap.add_argument("batch", nargs="?", type=int, default=BATCH)
    ap.add_argument("--device", default=None,
                    help="where the steps run: the card unless 'cpu'")
    ap.add_argument("--steps", type=int, default=STEPS, help="profiled steps")
    args = ap.parse_args(argv)
    print(format_table(trace(args.mode, args.side, args.batch, args.device,
                             args.steps)), flush=True)


if __name__ == "__main__":
    main()
