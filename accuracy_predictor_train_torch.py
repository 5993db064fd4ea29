"""Accuracy-predictor trainer CLI of the PyTorch port, on one CUDA card.

The same flags as ``accuracy_predictor_train.py`` (the JAX package's
driver): the AL loop of the two-headed model (a DeepLab segmentation head
and a UNet error head) trained on w_dl * L_seg + w_un * L_err, with the
staged weight schedule for ``--no-end-to-end``, and the selection modes
``accuracy`` (images and regions), ``gradient``, ``uncertain`` and
``uncertain_gradient`` (images). For example, the Pascal experiment of
``test_scripts/pa_experiments_07t.sh``:

    python accuracy_predictor_train_torch.py --backbone mobilenet \\
        --lr 0.007 --epochs 150 --batch-size 5 --eval-interval 5 \\
        --dataset active_pascal_image --base-size 512 --crop-size -1 \\
        --use-lr-scheduler --lr-scheduler step --max-iterations 8 \\
        --active-batch-size 60 --use-balanced-weights --no-early-stop \\
        --active-selection-mode accuracy --min-improvement 0.0025

Datasets are read from ``$DASS_DATASET_ROOT`` and runs written to
``$DASS_RUNS`` (``datasets/`` and ``runs/`` under the current directory by
default). On the CPU, call ``main(argv, device="cpu")``.

The host stream is one ``random.Random`` seeded with ``--seed``: the
pools' train transforms and the trainer's panel picks draw from it in the
JAX driver's order.
"""

import argparse
import math
import random

from deep_active_semantic_segmentation_torch import resolve_device
from deep_active_semantic_segmentation_torch.config import (
    add_common_flags, config_from_args, refuse_multi_device)

MODES = ("accuracy", "gradient", "uncertain", "uncertain_gradient")


def build_weight_schedules(epochs, weight_unet, staged):
    """Per-epoch loss weights (w_dl, w_un) (reference
    accuracy_predictor_train.py:372-385): 1 - weight_unet and weight_unet
    every epoch; staged, the first two thirds train the segmentation head
    alone (1, 0) and the rest the error head alone (0, 1)."""
    w_dl = [1 - weight_unet] * epochs
    w_un = [weight_unet] * epochs
    if staged:
        for i in range(0, epochs * 2 // 3):
            w_dl[i], w_un[i] = 1.0, 0.0
        for i in range(2 * epochs // 3, epochs):
            w_dl[i], w_un[i] = 0.0, 1.0
    return w_dl, w_un


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="PyTorch accuracy-predictor training")
    add_common_flags(parser, selection_choices=list(MODES))
    parser.add_argument("--weight-unet", type=float, default=0.30)
    parser.add_argument("--weight-wrong-label-unet", type=float, default=0.75)
    parser.add_argument("--accuracy-selection", type=str, default="softmax",
                        choices=["softmax", "argmax"])
    parser.add_argument("--no-end-to-end", action="store_true", default=False)
    parser.add_argument("--symmetry", action="store_true", default=False)
    args = config_from_args(parser.parse_args(argv))
    refuse_multi_device(args.num_devices)
    return args.finalize(n_devices=1)


def check_mode(mode: str, dataset: str) -> None:
    """Refuse, before any training, the modes the JAX driver cannot finish
    on region datasets: ``gradient``, ``uncertain`` and
    ``uncertain_gradient`` read the pool's remaining_image_paths, which the
    region pool does not have, so the JAX driver raises AttributeError
    after a whole training round (ROADMAP C)."""
    if mode not in MODES:
        raise NotImplementedError(mode)
    if dataset.endswith("_region") and mode != "accuracy":
        raise NotImplementedError(
            f"selection mode '{mode}' on region datasets: the JAX driver reads "
            "the region pool's remaining_image_paths, which it does not have "
            f"(ROADMAP C, {mode} on region datasets)")


def main(argv=None, device=None, dataset_root=None, runs_root=None):
    """Run the loop on ``device`` (the CUDA card by default; callers that
    mean the CPU say ``device="cpu"``). Returns ``{percent labeled: {mIoU,
    Acc, Acc_class, FWIoU}}``, each round's best."""
    cfg = parse_args(argv)
    print(cfg)
    mode = cfg.active_selection_mode
    check_mode(mode, cfg.dataset)
    device = resolve_device(device)
    rng = random.Random(cfg.seed)

    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.engine.trainer import Trainer
    from deep_active_semantic_segmentation_torch.selection import (
        ActiveSelectionAccuracy)
    from deep_active_semantic_segmentation_torch.utils.early_stop import (
        EarlyStopChecker)
    from deep_active_semantic_segmentation_torch.utils.saver import Saver
    from deep_active_semantic_segmentation_torch.utils.summaries import (
        TensorboardSummary)

    w_dl, w_un = build_weight_schedules(
        cfg.epochs, cfg.weight_unet,
        staged=cfg.architecture == "enet" or cfg.no_end_to_end)

    training_set, train_loader, val_loader, _, nclass = make_dataloader(
        cfg.dataset, cfg.base_size, cfg.crop_size, cfg.batch_size,
        cfg.workers, cfg.overfit, init_set=cfg.seed_set,
        memory_hog=cfg.memory_hog, dataset_root=dataset_root, seed=cfg.seed,
        rng=rng, device=device)
    cfg.nclass = nclass

    saver = Saver(cfg, runs_root=runs_root)
    saver.save_experiment_config()
    summary = TensorboardSummary(saver.experiment_dir)
    writer = summary.create_summary()

    active_selector = ActiveSelectionAccuracy(
        nclass, training_set.store, cfg.crop_size, cfg.batch_size,
        device=device)
    total_iterations = min(
        len(training_set.image_paths) // cfg.active_batch_size - 1,
        cfg.max_iterations)

    trainer = Trainer(cfg, train_loader, val_loader, nclass, device=device,
                      dual_head=True, runs_root=runs_root, rng=rng)
    trainer.initialize()
    region = cfg.dataset.endswith("_region")

    history = {}
    for selection_iter in range(cfg.resume, total_iterations):
        print(f"ActiveIteration-{selection_iter:03d}/{total_iterations:03d}")
        fraction = round(training_set.get_fraction_of_labeled_data() * 100)
        trainer.setup_saver_and_summary(
            fraction, training_set.current_image_paths,
            regions=([training_set.current_paths_to_regions_map[x]
                      for x in training_set.current_image_paths]
                     if region else None))
        training_set.make_dataset_multiple_of_batchsize(cfg.batch_size)
        trainer.initialize()  # fresh model every round

        early_stop = None
        if not cfg.no_early_stop:
            early_stop = EarlyStopChecker(patience=5,
                                          min_improvement=cfg.min_improvement)
        best = dict(mIoU=0.0, Acc=0.0, Acc_class=0.0, FWIoU=0.0)
        train_loss = test_loss = 0.0
        visualizations = None
        for outer_epoch in range(cfg.epochs // cfg.eval_interval):
            train_loss = 0.0
            for inner_epoch in range(cfg.eval_interval):
                epoch = outer_epoch * cfg.eval_interval + inner_epoch
                train_loss += trainer.training(epoch, w_dl[epoch], w_un[epoch])
            (test_loss, mIoU, Acc, Acc_class, FWIoU,
             visualizations) = trainer.validation(epoch, w_dl[epoch], w_un[epoch])
            for k, v in zip(("mIoU", "Acc", "Acc_class", "FWIoU"),
                            (mIoU, Acc, Acc_class, FWIoU)):
                best[k] = max(best[k], v)
            if early_stop is not None and early_stop(mIoU):
                print(f"Early stopping triggered after {epoch} epochs")
                break

        training_set.reset_dataset()
        history[fraction] = dict(best)
        writer.add_scalar("active_loop/train_loss",
                          train_loss / len(training_set), fraction)
        writer.add_scalar("active_loop/val_loss", test_loss, fraction)
        for k in best:
            writer.add_scalar(f"active_loop/{'fwIoU' if k == 'FWIoU' else k}",
                              best[k], fraction)
        if visualizations is not None:
            # the round-end accuracy panel (reference :474)
            summary.create_single_visualization(
                writer, "active_loop", cfg.dataset, *visualizations,
                len(training_set.current_image_paths))

        if selection_iter == total_iterations - 1:
            break

        trainer.load_best_checkpoint()
        _select(cfg, mode, active_selector, trainer.bundle, training_set)
    writer.close()
    return history


def _select(cfg, mode, selector, bundle, training_set) -> None:
    """One selection and the pool update (accuracy_predictor_train.py
    :148-182)."""
    k = cfg.active_batch_size
    if cfg.dataset.endswith("_region"):   # accuracy (check_mode)
        regions, counts = selector.get_least_accurate_region_maps(
            bundle, training_set.image_paths,
            training_set.get_existing_region_maps(), cfg.active_region_size, k)
        print(f"Got {counts}/"
              f"{math.ceil(k * cfg.crop_size ** 2 / cfg.active_region_size ** 2)}"
              " regions")
        training_set.expand_training_set(regions,
                                         counts * cfg.active_region_size ** 2)
        return
    remaining = training_set.remaining_image_paths
    if mode == "accuracy":
        selected = selector.get_least_accurate_samples(
            bundle, remaining, k, cfg.accuracy_selection)
    elif mode == "gradient":
        selected = selector.get_adversarially_vulnarable_samples(bundle,
                                                                 remaining, k)
    elif mode == "uncertain":
        selected = selector.get_unsure_samples(bundle, remaining, k)
    else:   # uncertain_gradient: the 2k least sure, then the k most fragile
        selected = selector.get_adversarially_vulnarable_samples(
            bundle, selector.get_unsure_samples(bundle, remaining, 2 * k), k)
    training_set.expand_training_set(selected)


if __name__ == "__main__":
    main()
