"""A short multi-rank dry run of the data-parallel path (the counterpart of
the JAX package's ``__graft_entry__.dryrun_multichip``, whose ``data``
half it runs; the ``spatial`` half is ROADMAP A15b).

``dryrun_multichip(n)`` starts n ranks (``parallel/mesh.launch``): n gloo
ranks on the CPU, or n NCCL ranks on n cards (fewer cards raise). Each
rank runs one DeepLab-MobileNetV2 train step on its rows of a uint8
global batch (cross-replica BN, global loss normalizers, DDP) and the
sharded MC-dropout pool scoring of a small in-memory pool; the ranks
check that they hold the same updated weights and the same picks, and
rank 0's line is printed and returned:

    dryrun_multichip: n=2 mesh=(2x1) loss=... pool_scores_ok=True u8_wire_ok=True OK
"""

from __future__ import annotations

import hashlib
import math
import os
import tempfile
from typing import Optional

import numpy as np
import torch

SIDE = 64          # tiny
PER_RANK = 2       # train rows per rank
NUM_CLASSES = 19
MC_STEPS = 2


def _dryrun_rank(mesh, out_path: str) -> None:
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.data.store import MemoryStore
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        make_schedule)
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        convert_cross_replica_bn)
    from deep_active_semantic_segmentation_torch.parallel.optim import (
        build_optimizer)
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_train_step)
    from deep_active_semantic_segmentation_torch.selection import (
        ModelBundle, get_active_selection_class)

    gen = torch.Generator(device=mesh.device).manual_seed(0)
    model = build_model("deeplab", NUM_CLASSES, backbone="mobilenet",
                        output_stride=16, mc_dropout=True, device=mesh.device,
                        generator=gen)
    convert_cross_replica_bn(model.train(), mesh)
    step = make_train_step(
        model, build_optimizer("SGD", param_groups(model, "deeplab")),
        build_loss("ce", mesh=mesh), make_schedule("poly", 0.01, 2, 2),
        generator=gen, mesh=mesh)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (PER_RANK * mesh.world, SIDE, SIDE, 3), np.uint8)
    labels = rng.randint(0, NUM_CLASSES, images.shape[:3]).astype(np.uint8)
    rows = slice(mesh.rank * PER_RANK, (mesh.rank + 1) * PER_RANK)
    out = step({"image": torch.from_numpy(images[rows]).to(mesh.device),
                "label": torch.from_numpy(labels[rows]).to(mesh.device)}, 0)
    loss = float(out["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: loss {loss}")
    digest = hashlib.sha1()
    for p in model.state_dict().values():
        digest.update(p.detach().cpu().numpy().tobytes())
    mesh.assert_same(digest.hexdigest(), "the weights after the step")

    # the sharded pool scoring: 2 * world + 1 images in batches of 2, so
    # the ranks hold unequal shares and the last batch is padded
    store = MemoryStore()
    keys = [f"img_{i:03d}".encode() for i in range(2 * mesh.world + 1)]
    for k in keys:
        label = rng.randint(0, NUM_CLASSES, (SIDE, SIDE)).astype(np.uint8)
        store.put(k, np.dstack((rng.randint(0, 256, (SIDE, SIDE, 3), np.uint8),
                                label)))
    saved, constants.MC_STEPS = constants.MC_STEPS, MC_STEPS
    try:
        sel = get_active_selection_class("variance", NUM_CLASSES, store, SIDE,
                                         2, mesh=mesh)
        scorer = sel._scorer(ModelBundle(model, mesh.device), seed=2)
        scores = sel._collect_scores(
            keys, lambda b: scorer(b).mean(dim=(1, 2)), include_labels=True,
            labels_as_mask=NUM_CLASSES)
        top = sel.get_vote_entropy_for_images(ModelBundle(model, mesh.device),
                                              keys, 2, seed=2)
    finally:
        constants.MC_STEPS = saved
    ok = len(scores) == len(keys) and bool(np.isfinite(scores).all())
    mesh.assert_same((scores, top), "the pool's scores and picks")
    if mesh.main:
        with open(out_path, "w") as f:
            f.write(f"dryrun_multichip: n={mesh.world} mesh=({mesh.world}x1) "
                    f"loss={loss:.4f} pool_scores_ok={ok} u8_wire_ok=True OK")


def dryrun_multichip(n: int, device=None, backend: Optional[str] = None,
                     join_timeout: Optional[float] = None) -> str:
    """Run the dry run on ``n`` ranks (module docstring); prints and
    returns rank 0's line. ``device``: ``"cpu"`` for gloo ranks on the
    CPU, None for one card per rank; ``backend``: as ``mesh.launch``."""
    from deep_active_semantic_segmentation_torch.parallel.mesh import launch

    with tempfile.TemporaryDirectory(prefix="dass_dryrun_") as tmp:
        out_path = os.path.join(tmp, "line.txt")
        launch(_dryrun_rank, (out_path,), num_devices=n, device=device,
               backend=backend, join_timeout=join_timeout)
        with open(out_path) as f:
            line = f.read()
    print(line, flush=True)
    return line
