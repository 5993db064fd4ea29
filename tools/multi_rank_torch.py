"""The PyTorch port's multi-rank phases alone, on one card or on a host
with several.

    python tools/multi_rank_torch.py [--phase multi_rank|multi_rank_drivers|spatial]
                                     [--out results.json]

Builds the kernels, writes chip_smoke.py's 20 synthetic Cityscapes-sized
records and runs one of its phases. ``multi_rank`` (the default):
``multi_rank_phase``, two gloo ranks sharing card 0, one rank per card
over NCCL where two cards or more are visible, and the NCCL route at
world 1; with four cards or more then ``dryrun_multichip(4)`` and a
4-rank ``variance`` round (global batch 8) through
``active_train_torch.main`` over NCCL. ``multi_rank_drivers``:
``multi_rank_drivers_phase``, the two-headed step, the accuracy
predictor's driver and picks, the replays and the SEM trainer on two gloo
ranks sharing card 0. ``spatial``: ``spatial_phase``, the height-sharded
step of DeepLab-MobileNetV2 and DeepLab-ResNet-101 os16, ENet and
FastSCNN at 1024x2048 and the SEM UNet at 768x1024 on a (1x2) mesh
(gloo ranks sharing card 0, and one rank per card over NCCL where two
cards are visible) and ``dryrun_multichip`` as (1x2) and (2x1), and as (2x2) over
NCCL where four cards are. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=["multi_rank", "multi_rank_drivers", "spatial"],
                    default="multi_rank")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)

    import torch

    import active_train_torch
    import chip_smoke as cs
    from deep_active_semantic_segmentation_torch import cuda_build
    from deep_active_semantic_segmentation_torch.parallel.dryrun import (
        dryrun_multichip)

    if not torch.cuda.is_available():
        print("multi_rank_torch: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), torch.cuda.device_count(), "card(s)", flush=True)
    cuda_build.build()
    tmp = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=REPO))
    out = {"card": cs.card_line(), "cards": torch.cuda.device_count()}
    try:
        _, paths = cs.write_dataset(tmp, 0)
        t0 = time.perf_counter()
        if args.phase == "multi_rank_drivers":
            out["phase"] = cs.multi_rank_drivers_phase(torch, 0, tmp, paths)
        elif args.phase == "spatial":
            out["phase"] = cs.spatial_phase(torch, 0, tmp)
        else:
            out["phase"] = cs.multi_rank_phase(torch, 0, tmp, tmp / "cityscapes" / "train",
                                               paths)
        out["phase_s"] = time.perf_counter() - t0
        print(f"phase {out['phase_s']:.1f} s", flush=True)
        if args.phase == "multi_rank" and torch.cuda.device_count() >= 4:
            t0 = time.perf_counter()
            out["dryrun4"] = dryrun_multichip(4, join_timeout=cs.MR_JOIN_S)
            out["dryrun4_s"] = time.perf_counter() - t0
            argv4 = cs.MR_ROUND_ARGV + ["--num-devices", "4", "--seed", "0",
                                        "--checkname", "round_4cards"]
            t0 = time.perf_counter()
            active_train_torch.main(argv4, dataset_root=str(tmp),
                                    runs_root=str(tmp / "runs4"))
            out["round4_s"] = time.perf_counter() - t0
            exp = tmp / "runs4" / "active_cityscapes_image" / "round_4cards"
            out["round4_selections"] = [
                len((d / "selections.txt").read_text().splitlines())
                for d in sorted(exp.iterdir()) if d.name.startswith("run_")]
            print(f"4-rank NCCL round {out['round4_s']:.1f} s, selections "
                  f"{out['round4_selections']}", flush=True)
            cs.check(out["round4_selections"] == [cs.SEED_SET, cs.SEED_SET + 5],
                     "the 4-rank round's selections")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
