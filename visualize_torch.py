"""Checkpoint evaluation and visualization CLI of the PyTorch port, on one
or more CUDA cards.

The same flags as ``visualize.py`` (the JAX package's CLI): load a
checkpoint into the model the flags describe, run the val split, write
each val image's img/tgt/prd PNGs into ``visualizations/`` beside the
checkpoint (``$DASS_VISUALIZATIONS`` names another folder) and print
Acc / Acc_class / mIoU / FWIoU and the loss:

    python visualize_torch.py --dataset active_cityscapes_image \\
        --backbone mobilenet --base-size 513 --crop-size 513 \\
        --batch-size 5 --checkpoint runs/.../run_0050/best.ckpt

It runs data-parallel on every visible card (``--num-devices N`` for N
of them), or on the ranks of ``torchrun --nproc-per-node N
visualize_torch.py ...``: every rank loads the checkpoint and validates
its rows of each global batch of ``--batch-size`` (which must divide by
N), the confusions are summed exactly over the ranks, and rank 0 writes
every PNG: the metrics and files of one card whose forwards see the same
rows (``engine/evaluation.py``).

Datasets are read from ``$DASS_DATASET_ROOT``. On the CPU, call
``main(argv, device="cpu")`` (with ``--num-devices 2``, two gloo ranks).
"""

import argparse
import os

from deep_active_semantic_segmentation_torch.config import (
    add_common_flags, config_from_args)


def main(argv=None, dataset_root=None, device=None, backend=None):
    """``device``: where evaluation runs, every visible CUDA card by
    default (callers that mean the CPU say ``device="cpu"``; an indexed
    card such as ``cuda:0`` holds every rank). ``backend``: the ranks'
    process-group backend. Returns the metrics (epoch, loss, Acc,
    Acc_class, mIoU, FWIoU) on one rank or a ``torchrun`` rank, None after
    spawning ranks (``parallel.mesh.launch``)."""
    from deep_active_semantic_segmentation_torch.parallel.mesh import (
        launch, process_batch_slice)

    args, checkpoint = parse_args(argv)
    if args.batch_size is not None and args.num_devices:
        process_batch_slice(args.batch_size, 0, args.num_devices)
    return launch(_run, (args, checkpoint, dataset_root),
                  num_devices=args.num_devices, device=device, backend=backend)


def parse_args(argv=None):
    """(the flags as an ``ExperimentConfig``, not yet finalized; the
    checkpoint path)."""
    parser = argparse.ArgumentParser(description="PyTorch DeeplabV3Plus visualize")
    add_common_flags(parser)
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="checkpoint path to evaluate")
    ns = parser.parse_args(argv)
    return config_from_args(ns), ns.checkpoint


def _run(mesh, args, checkpoint, dataset_root):
    """One rank's replay (``parallel.mesh.launch``)."""
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.engine.evaluation import (
        eval_trainer, evaluate_checkpoint)

    cfg = args.finalize(n_devices=mesh.world)
    cfg.seed = mesh.broadcast_object(cfg.seed)
    trainer = eval_trainer(cfg, dataset_root, mesh.device, mesh=mesh)

    vis_folder = os.path.join(os.path.dirname(os.path.realpath(checkpoint)),
                              constants.VISUALIZATIONS_FOLDER)
    if mesh.main:
        os.makedirs(vis_folder, exist_ok=True)

    m = evaluate_checkpoint(trainer, checkpoint, vis_folder=vis_folder)
    print(f"=> loaded checkpoint {checkpoint} (epoch {m['epoch']})")
    print("\nEvaluation:")
    print("Acc:{}, Acc_class:{}, mIoU:{}, fwIoU: {}".format(
        m["Acc"], m["Acc_class"], m["mIoU"], m["FWIoU"]))
    print("Loss: %.3f" % m["loss"])
    return m


if __name__ == "__main__":
    main()
