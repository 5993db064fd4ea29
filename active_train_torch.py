"""Active-learning trainer CLI of the PyTorch port, on one CUDA card.

The same flags as ``active_train.py`` (the JAX package's driver); the loop
is ``deep_active_semantic_segmentation_torch/engine/active_loop.py``. For
example, the canonical experiment's round:

    python active_train_torch.py --dataset active_cityscapes_image \\
        --backbone mobilenet --crop-size 513 --batch-size 5 --lr 0.01 \\
        --use-lr-scheduler --use-balanced-weights --eval-interval 5 \\
        --active-selection-mode variance --active-batch-size 50

Datasets are read from ``$DASS_DATASET_ROOT`` and runs written to
``$DASS_RUNS`` (``datasets/`` and ``runs/`` under the current directory by
default).
"""

from deep_active_semantic_segmentation_torch.config import parse_cli


def main(argv=None, device=None):
    """``device``: where the loop runs, the CUDA card by default (callers
    that mean the CPU say ``device="cpu"``)."""
    cfg = parse_cli(argv, description="PyTorch DeeplabV3Plus active "
                                      "training").finalize(n_devices=1)
    print(cfg)
    print("Using random seed =", cfg.seed)

    from deep_active_semantic_segmentation_torch.engine.active_loop import (
        run_active_loop)

    return run_active_loop(cfg, device=device)


if __name__ == "__main__":
    main()
