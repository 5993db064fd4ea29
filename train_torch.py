"""Passive (full-supervision) trainer CLI of the PyTorch port, on one CUDA
card.

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

Datasets are read from ``$DASS_DATASET_ROOT`` and runs written to
``$DASS_RUNS`` (``datasets/`` and ``runs/`` under the current directory by
default). On the CPU, call ``main(argv, device="cpu")``.

The host stream is one ``random.Random`` seeded with ``--seed``: the train
transforms and the trainer's grid and panel picks draw from it in the JAX
CLI's order (which seeds the module-level ``random``).
"""

import argparse
import random

from deep_active_semantic_segmentation_torch import resolve_device
from deep_active_semantic_segmentation_torch.config import (
    add_common_flags, config_from_args)


def main(argv=None, dataset_root=None, runs_root=None, device=None):
    """``device``: where training runs, the CUDA card by default (callers
    that mean the CPU say ``device="cpu"``). Returns the trainer."""
    parser = argparse.ArgumentParser(description="PyTorch DeeplabV3Plus training")
    add_common_flags(parser)
    parser.add_argument("--resume-checkpoint", type=str, default=None,
                        help="checkpoint path to resume from")
    ns = parser.parse_args(argv)
    args = config_from_args(ns)
    if args.dataset not in ("cityscapes", "pascal"):
        parser.error("train.py drives the passive datasets: cityscapes|pascal")
    cfg = args.finalize(n_devices=1)
    print(cfg)
    device = resolve_device(device)
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
        dataset_root=dataset_root, seed=cfg.seed, rng=rng, device=device)
    train_set.make_dataset_multiple_of_batchsize(cfg.batch_size)

    trainer = Trainer(cfg, train_loader, val_loader, nclass, device=device,
                      runs_root=runs_root, rng=rng, train_grids=True)
    trainer.saver = PassiveSaver(cfg, runs_root=runs_root)
    trainer.saver.save_experiment_config()
    trainer.summary = TensorboardSummary(trainer.saver.experiment_dir)
    trainer.writer = trainer.summary.create_summary()
    trainer.initialize()

    start_epoch = cfg.start_epoch
    if ns.resume_checkpoint:
        payload = load_checkpoint(ns.resume_checkpoint, trainer.model,
                                  trainer.optimizer, device)
        trainer.step = payload["step"]
        start_epoch = payload["epoch"]
        if not cfg.ft:
            trainer.best_pred = payload["best_pred"]
        print(f"=> loaded checkpoint {ns.resume_checkpoint} "
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
