"""Passive (full-supervision) trainer CLI of the PyTorch port, on one or
more CUDA cards.

The same flags as ``train.py`` (the JAX package's CLI), for the
passive datasets ``cityscapes`` and ``pascal``: every train record, per
``--eval-interval`` validation, ``experiment_{n}`` run directories under
``$DASS_RUNS/<dataset>/<checkname>/`` and the cross-experiment
``model_best.ckpt`` promotion; ``--resume-checkpoint`` restarts from a
checkpoint's epoch (its best mIoU too, unless ``--ft``). Every
architecture and backbone the JAX package builds trains:

    python train_torch.py --dataset cityscapes                 # DeepLab-ResNet-50
    python train_torch.py --dataset cityscapes --backbone resnet101
    python train_torch.py --dataset cityscapes --backbone mobilenet \\
        --pretrained-weights mobilenet_v2.pth.tar
    python train_torch.py --dataset cityscapes --architecture enet \\
        --crop-size 512 --optimizer Adam
    python train_torch.py --dataset cityscapes --architecture fastscnn \\
        --crop-size 512

It runs data-parallel on every visible card (``--num-devices N`` for N
of them, one rank per card over NCCL), or on the ranks of ``torchrun
--nproc-per-node N train_torch.py ...``: the default batch is 4 per rank
with the lr scaled by ``finalize`` (the JAX CLI's rule), each global
batch is split by rows over the ranks, and rank 0 writes the run's files.

Datasets are read from ``$DASS_DATASET_ROOT`` and runs written to
``$DASS_RUNS`` (``datasets/`` and ``runs/`` under the current directory by
default). On the CPU, call ``main(argv, device="cpu")``.

The host stream is one ``random.Random`` seeded with ``--seed``: the train
transforms and the trainer's grid and panel picks draw from it in the JAX
CLI's order (which seeds the module-level ``random``).
"""

import argparse
import random

from deep_active_semantic_segmentation_torch.config import (
    add_common_flags, config_from_args)
from deep_active_semantic_segmentation_torch.parallel.mesh import (
    process_batch_slice)


def main(argv=None, dataset_root=None, runs_root=None, device=None):
    """``device``: where training runs, every visible CUDA card by default
    (callers that mean the CPU say ``device="cpu"``: gloo ranks). Returns
    the trainer on one rank or a ``torchrun`` rank, None after spawning
    ranks (``parallel.mesh.launch``)."""
    from deep_active_semantic_segmentation_torch.parallel.mesh import launch

    parser = argparse.ArgumentParser(description="PyTorch DeeplabV3Plus training")
    add_common_flags(parser)
    parser.add_argument("--resume-checkpoint", type=str, default=None,
                        help="checkpoint path to resume from")
    ns = parser.parse_args(argv)
    args = config_from_args(ns)
    if args.dataset not in ("cityscapes", "pascal"):
        parser.error("train.py drives the passive datasets: cityscapes|pascal")
    if args.batch_size is not None and args.num_devices:
        process_batch_slice(args.batch_size, 0, args.num_devices)
    return launch(_train, (args, ns.resume_checkpoint, dataset_root, runs_root),
                  num_devices=args.num_devices, device=device)


def _train(mesh, args, resume_checkpoint, dataset_root, runs_root):
    """One rank's run (``parallel.mesh.launch``)."""
    cfg = args.finalize(n_devices=mesh.world)
    cfg.seed = mesh.broadcast_object(cfg.seed)
    process_batch_slice(cfg.batch_size, mesh.rank, mesh.world)
    print(cfg)
    device = mesh.device
    rng = random.Random(cfg.seed)

    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.engine.trainer import Trainer
    from deep_active_semantic_segmentation_torch.utils.checkpoint import (
        load_checkpoint)
    from deep_active_semantic_segmentation_torch.utils.saver import PassiveSaver
    from deep_active_semantic_segmentation_torch.utils.summaries import (
        TensorboardSummary)

    train_set, train_loader, val_loader, _, nclass = make_dataloader(
        cfg.dataset, cfg.base_size, cfg.crop_size, cfg.batch_size,
        cfg.workers, cfg.overfit, memory_hog=cfg.memory_hog,
        dataset_root=dataset_root, seed=cfg.seed, rng=rng, mesh=mesh)
    train_set.make_dataset_multiple_of_batchsize(cfg.batch_size)

    trainer = Trainer(cfg, train_loader, val_loader, nclass, device=device,
                      runs_root=runs_root, rng=rng, train_grids=True, mesh=mesh)
    trainer.saver = PassiveSaver(cfg, runs_root=runs_root, mesh=mesh)
    trainer.saver.save_experiment_config()
    trainer.summary = TensorboardSummary(trainer.saver.experiment_dir, mesh)
    trainer.writer = trainer.summary.create_summary()
    trainer.initialize()

    start_epoch = cfg.start_epoch
    if resume_checkpoint:
        payload = load_checkpoint(resume_checkpoint, trainer.model,
                                  trainer.optimizer, device)
        trainer.step = payload["step"]
        start_epoch = payload["epoch"]
        if not cfg.ft:
            trainer.best_pred = payload["best_pred"]
        print(f"=> loaded checkpoint {resume_checkpoint} "
              f"(epoch {payload['epoch']})")

    print("Starting Epoch:", start_epoch)
    print("Total Epoches:", cfg.epochs)
    for epoch in range(start_epoch, cfg.epochs):
        trainer.training(epoch)
        if not cfg.no_val and epoch % cfg.eval_interval == cfg.eval_interval - 1:
            trainer.validation(epoch)
    trainer.writer.close()
    return trainer


if __name__ == "__main__":
    main()
