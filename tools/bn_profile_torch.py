"""Where a train-mode step with the port's cross-replica batch norm
spends its time on one card: DeepLab-MobileNetV2, 4 images at 513², bf16
autocast, forward and backward (no optimizer), with plain BatchNorm2d and
with CrossReplicaBatchNorm2d over a one-rank NCCL group; host-clock ms
per call, then torch.profiler's tables (device and host time by op).

    python tools/bn_profile_torch.py

Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        convert_cross_replica_bn)
    from deep_active_semantic_segmentation_torch.parallel.mesh import make_mesh
    from deep_active_semantic_segmentation_torch.selection.kernels import (
        normalize_on_device)

    if not torch.cuda.is_available():
        print("bn_profile_torch: no CUDA device", file=sys.stderr)
        return 2
    mesh = make_mesh(device="cuda", backend="nccl")
    try:
        x = normalize_on_device(torch.randint(0, 256, (4, 513, 513, 3),
                                              dtype=torch.uint8, device=mesh.device))

        def ms(fn, n: int = 5) -> float:
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        for label, m in (("BatchNorm2d", None), ("CrossReplicaBatchNorm2d", mesh)):
            model = convert_cross_replica_bn(
                build_model("deeplab", 19, mc_dropout=True, device=mesh.device).train(), m)

            def step():
                model(x, use_dropout=False).float().mean().backward()

            with torch.autocast("cuda", dtype=torch.bfloat16):
                fwd = ms(lambda: model(x, use_dropout=False))
                both = ms(step)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    step()
                    torch.cuda.synchronize()
            print(f"{label}: forward {fwd:.2f} ms, forward + backward {both:.2f} ms",
                  flush=True)
            for key in ("cuda_time_total", "cpu_time_total"):
                print(prof.key_averages().table(sort_by=key, row_limit=12,
                                                max_name_column_width=60), flush=True)
    finally:
        mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
