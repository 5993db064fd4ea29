"""A short multi-rank dry run of the data x spatial mesh (the counterpart
of the JAX package's ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` starts n ranks (``parallel/mesh.launch``): n gloo
ranks on the CPU, or n NCCL ranks on n cards (fewer cards raise), laid
out as JAX lays them: ``spatial = 2`` when n is even, ``data = n //
spatial``. Each rank runs DeepLab-MobileNetV2 at side 64 (cross-replica
BN over every rank, global loss normalizers, DDP):
- JAX's first step, ``make_train_step(spatial=True)`` on its data row's
  2 images of a float batch and its band of their rows (the plain
  data-parallel step where spatial is 1);
- the uint8-wire step sharded over ``data`` only, the spatial ranks of a
  row replicas (JAX's ``P('data')`` step on the same mesh);
- the sharded MC-dropout pool scoring of a small in-memory pool over the
  flattened ranks, at side 65 (4 x 16 + 1, the exact 4x geometry B1
  takes: at 64 the votes fall back to the model's own upsample, in the
  JAX package as here), so a card launches B1 on every rank.
The ranks check that they hold the same updated weights and the same
picks, and rank 0's line is printed and returned, with each rank's B1
launches:

    dryrun_multichip: n=2 mesh=(1x2) loss=... pool_scores_ok=True u8_wire_ok=True upsample4_argmax_launches=[8, 4] OK
"""

from __future__ import annotations

import hashlib
import math
import os
import tempfile
from typing import Optional

import numpy as np
import torch

SIDE = 64          # tiny, spatial-shardable
POOL_SIDE = 65     # the pool's: B1's exact 4x of the decoder's 17
PER_ROW = 2        # train images per data row
NUM_CLASSES = 19
MC_STEPS = 2


def _dryrun_rank(mesh, out_path: str) -> None:
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.data.store import MemoryStore
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops import upsample_argmax
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        make_schedule)
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        convert_cross_replica_bn)
    from deep_active_semantic_segmentation_torch.parallel.optim import (
        build_optimizer)
    from deep_active_semantic_segmentation_torch.parallel.spatial import shard_rows
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_train_step)
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)

    gen = torch.Generator(device=mesh.device).manual_seed(0)
    model = build_model("deeplab", NUM_CLASSES, backbone="mobilenet",
                        output_stride=16, mc_dropout=True, device=mesh.device,
                        generator=gen)
    convert_cross_replica_bn(model.train(), mesh)
    optimizer = build_optimizer("SGD", param_groups(model, "deeplab"))

    def train(batch, index: int, spatial: bool) -> float:
        # one step function (and DDP wrapper) at a time over the model
        step = make_train_step(model, optimizer, build_loss("ce", mesh=mesh),
                               make_schedule("poly", 0.01, 2, 2), generator=gen,
                               mesh=mesh, spatial=spatial)
        return float(step({k: torch.from_numpy(v).to(mesh.device)
                           for k, v in batch.items()}, index)["loss"])

    rng = np.random.RandomState(0)
    n = PER_ROW * mesh.data_world
    rows = slice(mesh.data_rank * PER_ROW, (mesh.data_rank + 1) * PER_ROW)
    band = slice(*shard_rows(SIDE, mesh))
    # JAX's batches: a float one for the (spatial) step, then a uint8 one
    images = rng.rand(n, SIDE, SIDE, 3).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, (n, SIDE, SIDE)).astype(np.uint8)
    losses = [train({"image": images[rows, band], "label": labels[rows, band]}, 0,
                    mesh.spatial_world > 1)]
    images = rng.randint(0, 255, (n, SIDE, SIDE, 3)).astype(np.uint8)
    labels = rng.randint(0, NUM_CLASSES, (n, SIDE, SIDE)).astype(np.uint8)
    losses.append(train({"image": images[rows], "label": labels[rows]}, 1, False))
    loss, u8_loss = losses
    if not (math.isfinite(loss) and math.isfinite(u8_loss)):
        raise RuntimeError(f"dryrun_multichip: losses {loss}, {u8_loss}")
    digest = hashlib.sha1()
    for p in model.state_dict().values():
        digest.update(p.detach().cpu().numpy().tobytes())
    mesh.assert_same(digest.hexdigest(), "the weights after the step")

    # the sharded pool scoring: 2 * world + 1 images in batches of 2, so
    # the ranks hold unequal shares and the last batch is padded
    store = MemoryStore()
    keys = [f"img_{i:03d}".encode() for i in range(2 * mesh.world + 1)]
    for k in keys:
        label = rng.randint(0, NUM_CLASSES, (POOL_SIDE, POOL_SIDE)).astype(np.uint8)
        store.put(k, np.dstack((rng.randint(0, 256, (POOL_SIDE, POOL_SIDE, 3), np.uint8),
                                label)))
    saved, constants.MC_STEPS = constants.MC_STEPS, MC_STEPS
    launches = upsample_argmax.upsample4_argmax.launches
    try:
        sel = get_active_selection_class("variance", NUM_CLASSES, store, POOL_SIDE,
                                         2, mesh=mesh)
        scorer = sel._scorer(ModelBundle(model, mesh.device), seed=2)
        scores = sel._collect_scores(
            keys, lambda b: scorer(b).mean(dim=(1, 2)), include_labels=True,
            labels_as_mask=NUM_CLASSES)
        top = sel.get_vote_entropy_for_images(ModelBundle(model, mesh.device),
                                              keys, 2, seed=2)
    finally:
        constants.MC_STEPS = saved
    launches = mesh.gather_objects(upsample_argmax.upsample4_argmax.launches
                                   - launches)
    ok = len(scores) == len(keys) and bool(np.isfinite(scores).all())
    mesh.assert_same((scores, top), "the pool's scores and picks")
    if mesh.main:
        with open(out_path, "w") as f:
            f.write(f"dryrun_multichip: n={mesh.world} "
                    f"mesh=({mesh.data_world}x{mesh.spatial_world}) loss={loss:.4f} "
                    f"pool_scores_ok={ok} u8_wire_ok=True "
                    f"upsample4_argmax_launches={launches} OK")


def dryrun_multichip(n: int, device=None, backend: Optional[str] = None,
                     join_timeout: Optional[float] = None,
                     spatial: Optional[int] = None) -> str:
    """Run the dry run on ``n`` ranks (module docstring); prints and
    returns rank 0's line. ``device``: ``"cpu"`` for gloo ranks on the
    CPU, None for one card per rank; ``backend``: as ``mesh.launch``.
    ``spatial``: the ranks per data row; None is JAX's layout (2 for an
    even n, else 1), 1 the data-only mesh."""
    from deep_active_semantic_segmentation_torch.parallel.mesh import launch

    if spatial is None:
        spatial = 2 if n % 2 == 0 else 1
    with tempfile.TemporaryDirectory(prefix="dass_dryrun_") as tmp:
        out_path = os.path.join(tmp, "line.txt")
        launch(_dryrun_rank, (out_path,), num_devices=n, device=device,
               backend=backend, join_timeout=join_timeout,
               spatial=spatial)
        with open(out_path) as f:
            line = f.read()
    print(line, flush=True)
    return line
