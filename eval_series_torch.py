"""Checkpoint-series evaluation CLI of the PyTorch port, on one or more
CUDA cards.

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
It runs data-parallel on every visible card (``--num-devices N``), or on
the ranks of ``torchrun --nproc-per-node N eval_series_torch.py ...``,
as ``visualize_torch.py`` does: every rank replays every checkpoint on
its rows and computes the same series, and rank 0 writes the table.

Datasets are read from ``$DASS_DATASET_ROOT`` and the experiment from
``$DASS_RUNS/<dataset>/<checkname>``. On the CPU, call
``main(argv, device="cpu")`` (with ``--num-devices 2``, two gloo ranks).
"""

import argparse
import os

from deep_active_semantic_segmentation_torch.config import (
    add_common_flags, config_from_args)


def main(argv=None, dataset_root=None, runs_root=None, device=None,
         backend=None):
    """Returns {labeled count: metrics} on one rank or a ``torchrun``
    rank, None after spawning ranks (``parallel.mesh.launch``; ``device``
    and ``backend`` as in ``visualize_torch.main``). Raises
    ``FileNotFoundError`` when the experiment directory or every
    ``run_*/<ckpt name>`` is missing."""
    from deep_active_semantic_segmentation_torch.parallel.mesh import (
        launch, process_batch_slice)

    args, experiment_dir, ckpt_name, dual_head = parse_args(argv, runs_root)
    if not os.path.isdir(experiment_dir):
        raise FileNotFoundError(experiment_dir)
    if args.batch_size is not None and args.num_devices:
        process_batch_slice(args.batch_size, 0, args.num_devices)
    return launch(_run, (args, experiment_dir, ckpt_name, dual_head, dataset_root),
                  num_devices=args.num_devices, device=device, backend=backend)


def parse_args(argv=None, runs_root=None):
    """(the flags as an ``ExperimentConfig``, not yet finalized; the
    experiment directory; the checkpoint name; ``--dual-head``)."""
    from deep_active_semantic_segmentation_torch import constants

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
    args = config_from_args(ns)
    experiment_dir = ns.experiment_dir or os.path.join(
        runs_root or constants.RUNS, args.dataset,
        args.finalize(n_devices=args.num_devices or 1).checkname)
    return args, experiment_dir, ns.ckpt_name, ns.dual_head


def _run(mesh, args, experiment_dir, ckpt_name, dual_head, dataset_root):
    """One rank's sweep (``parallel.mesh.launch``)."""
    from deep_active_semantic_segmentation_torch.engine.evaluation import (
        eval_trainer, evaluate_checkpoint_series)

    cfg = args.finalize(n_devices=mesh.world)
    cfg.seed = mesh.broadcast_object(cfg.seed)
    trainer = eval_trainer(cfg, dataset_root, mesh.device, dual_head=dual_head,
                           mesh=mesh)
    series = evaluate_checkpoint_series(trainer, experiment_dir,
                                        ckpt_name=ckpt_name)
    if not series:
        raise FileNotFoundError(f"no run_*/{ckpt_name} under {experiment_dir}")
    return series


if __name__ == "__main__":
    main()
