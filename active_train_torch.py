"""Active-learning trainer CLI of the PyTorch port, on one or more CUDA
cards.

The same flags as ``active_train.py`` (the JAX package's driver); the loop
is ``deep_active_semantic_segmentation_torch/engine/active_loop.py``. For
example, the canonical experiment's round:

    python active_train_torch.py --dataset active_cityscapes_image \\
        --backbone mobilenet --crop-size 513 --batch-size 5 --lr 0.01 \\
        --use-lr-scheduler --use-balanced-weights --eval-interval 5 \\
        --active-selection-mode variance --active-batch-size 50

It runs data-parallel on every visible card (``--num-devices N`` for N
of them, one rank per card over NCCL), or on the ranks of
``torchrun --nproc-per-node N active_train_torch.py ...``: the global
batch ``--batch-size`` is split by rows over the ranks and must divide,
the auto batch and lr scale with the ranks as in the JAX driver, the pool
is scored by all ranks, and rank 0 writes the run's files.

Datasets are read from ``$DASS_DATASET_ROOT`` and runs written to
``$DASS_RUNS`` (``datasets/`` and ``runs/`` under the current directory by
default).
"""

from deep_active_semantic_segmentation_torch.config import parse_cli


def _run(mesh, cfg, dataset_root, runs_root):
    """One rank's loop (``parallel.mesh.launch``): the config finalized for
    the run's ranks, its seed rank 0's."""
    from deep_active_semantic_segmentation_torch.engine.active_loop import (
        run_active_loop)

    cfg = cfg.finalize(n_devices=mesh.world)
    cfg.seed = mesh.broadcast_object(cfg.seed)
    print(cfg)
    print("Using random seed =", cfg.seed)
    return run_active_loop(cfg, dataset_root=dataset_root, runs_root=runs_root,
                           mesh=mesh)


def main(argv=None, device=None, dataset_root=None, runs_root=None,
         backend=None):
    """``device``: where the loop runs, every visible CUDA card by default
    (callers that mean the CPU say ``device="cpu"``; an indexed card such
    as ``cuda:0`` holds every rank). ``backend``: the ranks' process-group
    backend (NCCL on cards, gloo on the CPU by default). Returns the loop's
    history on one rank or a ``torchrun`` rank, None after spawning ranks
    (``parallel.mesh.launch``)."""
    from deep_active_semantic_segmentation_torch.engine.active_loop import (
        check_args)
    from deep_active_semantic_segmentation_torch.parallel.mesh import launch

    cfg = parse_cli(argv, description="PyTorch DeeplabV3Plus active training")
    check_args(cfg, cfg.num_devices or 1)   # before any rank starts
    return launch(_run, (cfg, dataset_root, runs_root),
                  num_devices=cfg.num_devices, device=device, backend=backend)


if __name__ == "__main__":
    main()
