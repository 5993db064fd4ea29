"""Checkpoint evaluation shared by visualize_torch.py and eval_series_torch.py
(parity: the JAX package's engine/evaluation.py:33-118, itself the eval
loop of reference visualize.py:57-159 and the checkpoint-series sweep
``get_validation_mIoUs`` of reference active_selection/tests.py:32-101).

The checkpoint is read onto the trainer's device into ``trainer.model``
(the optimizer is not needed) and the val split streams through the
loader's prefetch and the trainer's eval step. The losses and confusion
matrices stay on the device and are fetched once, after the last batch;
a batch's predictions are fetched only when PNGs are written.
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
                 dual_head: bool = False):
    """The initialized Trainer that visualize_torch.py and
    eval_series_torch.py replay checkpoints in: ``cfg``'s loaders on
    ``device``, the accuracy predictor's two heads when ``dual_head``."""
    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.engine.trainer import Trainer

    _, train_loader, val_loader, _, nclass = make_dataloader(
        cfg.dataset, cfg.base_size, cfg.crop_size, cfg.batch_size,
        cfg.workers, cfg.overfit, init_set=cfg.seed_set,
        memory_hog=cfg.memory_hog, dataset_root=dataset_root, seed=cfg.seed,
        device=device)
    trainer = Trainer(cfg, train_loader, val_loader, nclass, device=device,
                      dual_head=dual_head)
    trainer.initialize()
    return trainer


def evaluate_checkpoint(trainer, ckpt_path: str,
                        vis_folder: Optional[str] = None) -> dict:
    """Load ``ckpt_path`` into ``trainer.model`` and run the full val split.

    Returns {epoch, loss, Acc, Acc_class, mIoU, FWIoU} plus {UNetAcc,
    UNetmIoU} for a dual-head trainer, whose eval step runs with loss
    weights w_dl = w_un = 1. When ``vis_folder`` is set (and the trainer
    is not dual-head), writes each val image's img/tgt/prd PNGs there."""
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
            n = batch["nvalid"]
            TensorboardSummary.visualize_images_to_folder(
                vis_folder, i, batch["image"][:n], batch["label"][:n],
                out["pred"][:n], trainer.args.dataset)
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
    format."""
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
    if rows:
        with open(os.path.join(experiment_dir, "validation_mIoUs.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return series
