"""Checkpoint evaluation shared by visualize_torch.py and eval_series_torch.py
(parity: the JAX package's engine/evaluation.py:33-118, itself the eval
loop of reference visualize.py:57-159 and the checkpoint-series sweep
``get_validation_mIoUs`` of reference active_selection/tests.py:32-101).

The checkpoint is read onto the trainer's device into ``trainer.model``
(the optimizer is not needed) and the val split streams through the
loader's prefetch and the trainer's eval step. The losses and confusion
matrices stay on the device and are fetched once, after the last batch;
a batch's predictions are fetched only when PNGs are written.

``mesh`` (a data-parallel replay, ``parallel/mesh.py``): every rank loads
the checkpoint and validates its rows of each global batch; the eval
step sums the confusions exactly over the ranks, so every rank computes
the metrics of one rank whose forwards see the same rows (on a card the
rounding of a forward depends on its batch size: cuDNN picks its
kernels by shape). The PNGs are written by rank 0 alone, from every
rank's rows of the batch (``Mesh.gather_rows``), so the files are those
of such a one-rank replay; the series table too is rank 0's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from deep_active_semantic_segmentation_torch.ops.metrics import Evaluator
from deep_active_semantic_segmentation_torch.utils.checkpoint import load_checkpoint
from deep_active_semantic_segmentation_torch.utils.summaries import (
    TensorboardSummary)


def eval_trainer(cfg, dataset_root: Optional[str], device,
                 dual_head: bool = False, mesh=None):
    """The initialized Trainer that visualize_torch.py and
    eval_series_torch.py replay checkpoints in: ``cfg``'s loaders on
    ``device`` (or on ``mesh``'s ranks), the accuracy predictor's two
    heads when ``dual_head``."""
    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.engine.trainer import Trainer

    _, train_loader, val_loader, _, nclass = make_dataloader(
        cfg.dataset, cfg.base_size, cfg.crop_size, cfg.batch_size,
        cfg.workers, cfg.overfit, init_set=cfg.seed_set,
        memory_hog=cfg.memory_hog, dataset_root=dataset_root, seed=cfg.seed,
        device=device, mesh=mesh)
    trainer = Trainer(cfg, train_loader, val_loader, nclass, device=device,
                      dual_head=dual_head, mesh=mesh)
    trainer.initialize()
    return trainer


def evaluate_checkpoint(trainer, ckpt_path: str,
                        vis_folder: Optional[str] = None) -> dict:
    """Load ``ckpt_path`` into ``trainer.model`` and run the full val split.

    Returns {epoch, loss, Acc, Acc_class, mIoU, FWIoU} plus {UNetAcc,
    UNetmIoU} for a dual-head trainer, whose eval step runs with loss
    weights w_dl = w_un = 1. When ``vis_folder`` is set (and the trainer
    is not dual-head), writes each val image's img/tgt/prd PNGs there (on
    a mesh, rank 0 writes every rank's rows)."""
    payload = load_checkpoint(ckpt_path, trainer.model, device=trainer.device)
    evaluator = Evaluator(trainer.nclass, trainer.device)
    unet_evaluator = Evaluator(2, trainer.device) if trainer.dual_head else None
    weights = (1.0, 1.0) if trainer.dual_head else ()
    device_losses = []
    for i, batch in enumerate(trainer.val_loader.device_batches()):
        out = trainer.eval_step(batch, batch["nvalid"], *weights)
        device_losses.append(out["loss"])
        evaluator.add_matrix(out["confusion"])
        if unet_evaluator is not None:
            unet_evaluator.add_matrix(out["unet_confusion"])
        elif vis_folder is not None:
            _write_pngs(trainer, vis_folder, i, batch, out["pred"])
    # summed on the host in batch order, as the JAX package adds its floats
    test_loss = sum(torch.stack(device_losses).tolist()) if device_losses else 0.0

    result = {
        "epoch": payload.get("epoch"),
        "loss": test_loss,
        "Acc": evaluator.Pixel_Accuracy(),
        "Acc_class": evaluator.Pixel_Accuracy_Class(),
        "mIoU": evaluator.Mean_Intersection_over_Union(),
        "FWIoU": evaluator.Frequency_Weighted_Intersection_over_Union(),
    }
    if unet_evaluator is not None:
        result["UNetAcc"] = unet_evaluator.Pixel_Accuracy()
        result["UNetmIoU"] = unet_evaluator.Mean_Intersection_over_Union()
    return result


def _write_pngs(trainer, vis_folder: str, batch_index: int, batch, pred):
    """The batch's valid images' img/tgt/prd PNGs. On a mesh every rank's
    rows (image, label and prediction packed as one uint8 tensor; class
    ids fit) cross to every rank in rank order, which is the global
    batch's order, its valid rows first; rank 0 writes them."""
    mesh = trainer.mesh
    image, label, n = batch["image"], batch["label"], batch["nvalid"]
    if mesh is not None and mesh.distributed:
        rows = mesh.gather_rows({mesh.rank: torch.cat(
            [image, label[..., None], pred.to(torch.uint8)[..., None]], dim=-1)})
        n = int(mesh.all_reduce(torch.tensor([n], dtype=torch.int64,
                                             device=mesh.device)))
        image, label, pred = rows[..., :3], rows[..., 3], rows[..., 4]
        if not mesh.main:
            return
    TensorboardSummary.visualize_images_to_folder(
        vis_folder, batch_index, image[:n], label[:n], pred[:n],
        trainer.args.dataset)


def discover_run_checkpoints(experiment_dir: str,
                             ckpt_name: str = "best.ckpt"):
    """Ordered [(labeled count, ckpt path)] over an experiment's run_*
    directories (the AL round layout of utils/saver.py)."""
    out = []
    for entry in sorted(os.listdir(experiment_dir)):
        if not entry.startswith("run_"):
            continue
        path = os.path.join(experiment_dir, entry, ckpt_name)
        if os.path.exists(path):
            out.append((int(entry[len("run_"):]), path))
    return out


def evaluate_checkpoint_series(trainer, experiment_dir: str,
                               ckpt_name: str = "best.ckpt"):
    """Re-validate every AL round's checkpoint; returns {labeled count:
    metrics}, prints one row per round and writes the rows to
    ``validation_mIoUs.txt`` beside the runs, in the JAX package's
    format (rank 0's, on a mesh)."""
    series = {}
    rows = []
    for pct, path in discover_run_checkpoints(experiment_dir, ckpt_name):
        metrics = evaluate_checkpoint(trainer, path)
        series[pct] = metrics
        extras = ""
        if "UNetAcc" in metrics:
            extras = (f", UNetAcc: {metrics['UNetAcc']}, "
                      f"UNetmIoU: {metrics['UNetmIoU']}")
        row = (f"run_{pct:04d}: Acc:{metrics['Acc']}, "
               f"Acc_class:{metrics['Acc_class']}, mIoU:{metrics['mIoU']}, "
               f"fwIoU: {metrics['FWIoU']}{extras}")
        print(row)
        rows.append(row)
    if rows and (trainer.mesh is None or trainer.mesh.main):
        with open(os.path.join(experiment_dir, "validation_mIoUs.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return series
