"""Checkpoint evaluation and visualization CLI of the PyTorch port, on one
CUDA card.

The same flags as ``visualize.py`` (the JAX package's CLI): load a
checkpoint into the model the flags describe, run the val split, write
each val image's img/tgt/prd PNGs into ``visualizations/`` beside the
checkpoint (``$DASS_VISUALIZATIONS`` names another folder) and print
Acc / Acc_class / mIoU / FWIoU and the loss:

    python visualize_torch.py --dataset active_cityscapes_image \\
        --backbone mobilenet --base-size 513 --crop-size 513 \\
        --batch-size 5 --checkpoint runs/.../run_0050/best.ckpt

Datasets are read from ``$DASS_DATASET_ROOT``. On the CPU, call
``main(argv, device="cpu")``.
"""

import argparse
import os

from deep_active_semantic_segmentation_torch import resolve_device
from deep_active_semantic_segmentation_torch.config import (
    add_common_flags, config_from_args, refuse_multi_device)


def main(argv=None, dataset_root=None, device=None):
    """``device``: where evaluation runs, the CUDA card by default (callers
    that mean the CPU say ``device="cpu"``). Returns the metrics
    (epoch, loss, Acc, Acc_class, mIoU, FWIoU)."""
    parser = argparse.ArgumentParser(description="PyTorch DeeplabV3Plus visualize")
    add_common_flags(parser)
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="checkpoint path to evaluate")
    ns = parser.parse_args(argv)
    refuse_multi_device(ns.num_devices)
    cfg = config_from_args(ns).finalize(n_devices=1)
    device = resolve_device(device)

    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.engine.evaluation import (
        eval_trainer, evaluate_checkpoint)

    trainer = eval_trainer(cfg, dataset_root, device)

    vis_folder = os.path.join(os.path.dirname(os.path.realpath(ns.checkpoint)),
                              constants.VISUALIZATIONS_FOLDER)
    os.makedirs(vis_folder, exist_ok=True)

    m = evaluate_checkpoint(trainer, ns.checkpoint, vis_folder=vis_folder)
    print(f"=> loaded checkpoint {ns.checkpoint} (epoch {m['epoch']})")
    print("\nEvaluation:")
    print("Acc:{}, Acc_class:{}, mIoU:{}, fwIoU: {}".format(
        m["Acc"], m["Acc_class"], m["mIoU"], m["FWIoU"]))
    print("Loss: %.3f" % m["loss"])
    return m


if __name__ == "__main__":
    main()
