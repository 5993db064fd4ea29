"""The PyTorch port's multi-rank phase alone, on one card or on a host
with several.

    python tools/multi_rank_torch.py [--out results.json]

Builds the kernels, writes chip_smoke.py's 20 synthetic Cityscapes-sized
records and runs its ``multi_rank_phase``: two gloo ranks sharing card 0,
one rank per card over NCCL where two cards or more are visible, and the
NCCL route at world 1. With four cards or more it then runs
``dryrun_multichip(4)`` and a 4-rank ``variance`` round (global batch 8)
through ``active_train_torch.main`` over NCCL. Needs CUDA; imports no JAX.
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
        out["phase"] = cs.multi_rank_phase(torch, 0, tmp, tmp / "cityscapes" / "train",
                                           paths)
        out["phase_s"] = time.perf_counter() - t0
        print(f"phase {out['phase_s']:.1f} s", flush=True)
        if torch.cuda.device_count() >= 4:
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
