"""Checkpoint-series evaluation CLI of the PyTorch port, on one CUDA card.

The same flags as ``eval_series.py`` (the JAX package's CLI,
``get_validation_mIoUs`` of reference active_selection/tests.py:32-101):
given an active-learning experiment directory, re-validate every round's
``run_*/best.ckpt`` on the val split, print one row per round and write
the mIoU-vs-labeled table to ``validation_mIoUs.txt`` in the experiment
directory:

    python eval_series_torch.py --dataset active_cityscapes_image \\
        --base-size 513 --crop-size 513 --batch-size 5 \\
        --backbone mobilenet --checkname <experiment name> \\
        [--dual-head] [--experiment-dir DIR] [--ckpt-name best.ckpt]

``--dual-head`` evaluates the accuracy predictor's checkpoints (its
segmentation head's metrics and the error head's UNetAcc / UNetmIoU).
Datasets are read from ``$DASS_DATASET_ROOT`` and the experiment from
``$DASS_RUNS/<dataset>/<checkname>``. On the CPU, call
``main(argv, device="cpu")``.
"""

import argparse
import os

from deep_active_semantic_segmentation_torch import resolve_device
from deep_active_semantic_segmentation_torch.config import (
    add_common_flags, config_from_args)


def main(argv=None, dataset_root=None, runs_root=None, device=None):
    """Returns {labeled count: metrics}. Raises ``FileNotFoundError`` when
    the experiment directory or every ``run_*/<ckpt name>`` is missing."""
    parser = argparse.ArgumentParser(
        description="Re-validate an AL run's per-round checkpoints")
    add_common_flags(parser)
    parser.add_argument("--experiment-dir", type=str, default=None,
                        help="explicit experiment directory (default: "
                             "<runs>/<dataset>/<checkname>)")
    parser.add_argument("--ckpt-name", type=str, default="best.ckpt")
    parser.add_argument("--dual-head", action="store_true", default=False,
                        help="evaluate accuracy-predictor checkpoints "
                             "(seg + error head, tests.py:88-96)")
    ns = parser.parse_args(argv)
    cfg = config_from_args(ns).finalize(n_devices=1)
    device = resolve_device(device)

    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.engine.evaluation import (
        eval_trainer, evaluate_checkpoint_series)

    experiment_dir = ns.experiment_dir or os.path.join(
        runs_root or constants.RUNS, cfg.dataset, cfg.checkname)
    if not os.path.isdir(experiment_dir):
        raise FileNotFoundError(experiment_dir)

    trainer = eval_trainer(cfg, dataset_root, device, dual_head=ns.dual_head)
    series = evaluate_checkpoint_series(trainer, experiment_dir,
                                        ckpt_name=ns.ckpt_name)
    if not series:
        raise FileNotFoundError(
            f"no run_*/{ns.ckpt_name} under {experiment_dir}")
    return series


if __name__ == "__main__":
    main()
