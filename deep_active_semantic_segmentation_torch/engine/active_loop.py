"""The outer active-learning loop (parity: the JAX package's
engine/active_loop.py:29-278, itself the reference active_train.py
:336-529): per-round fresh model, train with early stop, reload the best
checkpoint, select, grow the pool; resume from selections; the
active_loop/* scalars keyed by percent of data labeled.

The host stream is one ``random.Random`` seeded with ``args.seed``; the
pools' train transforms, the trainer's visualization pick and the
random-mode scorer draw from it in the JAX package's order (which seeds
the module-level ``random`` instead), so one seed gives both packages the
same draws; the ``ceal_fusion`` shuffle draws from it too. Every
selection mode of ``active_train.py`` runs on image datasets;
``variance``, ``variance_representative`` and ``noise_variance`` on region
datasets too. The combinations the JAX loop cannot finish are refused
before training.

``mesh`` (``parallel/mesh.py``; the JAX loop's ``mesh``) runs the loop
data-parallel: every rank trains on its rows of each global batch of
``--batch-size`` (which the ranks must divide), scores its share of the
pool, and expands the same pool with the same picks, which the ranks
check against each other after every selection; rank 0 writes the run's
files. The returned seconds are each rank's own.
"""

from __future__ import annotations

import math
import os
import random
import time
from typing import Optional

from deep_active_semantic_segmentation_torch import constants, resolve_device
from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
from deep_active_semantic_segmentation_torch.engine.trainer import Trainer
from deep_active_semantic_segmentation_torch.selection import (
    get_active_selection_class, get_max_subset_active_selector)
from deep_active_semantic_segmentation_torch.utils.early_stop import (
    EarlyStopChecker)
from deep_active_semantic_segmentation_torch.utils.saver import Saver
from deep_active_semantic_segmentation_torch.utils.summaries import (
    TensorboardSummary)

_CEAL = ("ceal_confidence", "ceal_margin", "ceal_entropy", "ceal_fusion",
         "ceal_entropy_weakly_labeled")
_MODES = ("random", "variance", "variance_representative", "coreset",
          "noise_image", "noise_feature", "noise_variance", "accuracy_labels",
          "accuracy_eval") + _CEAL
_REGION_CAPABLE = ("random", "variance", "variance_representative",
                   "noise_variance", "accuracy_eval", "accuracy_labels")


def check_args(args, world: int = 1) -> None:
    """Refuse, before any training, what the loop cannot run on ``world``
    ranks: ``_check_mode``'s combinations, ``variance_representative`` on
    region datasets at the letterbox, and a global batch that the ranks do
    not divide (an unset batch, which ``finalize`` chooses, is not
    checked)."""
    _check_mode(args.active_selection_mode, args.dataset)
    if (args.active_selection_mode == "variance_representative"
            and args.dataset.endswith("_region") and args.crop_size <= 0):
        raise NotImplementedError(
            f"variance_representative on region datasets needs --crop-size > 0, "
            f"not {args.crop_size}: its max-subset stage maps regions onto the "
            "feature map at region_size * map size / crop_size (the JAX "
            "selector's formula), which is negative at the letterbox, and the "
            "JAX loop fails at its first selection there (ROADMAP C)")
    if args.batch_size is not None and args.batch_size % world:
        raise ValueError(f"--batch-size {args.batch_size} does not divide over "
                         f"{world} ranks: the global batch must be a multiple "
                         "of --num-devices")


def _check_mode(mode: str, dataset: str) -> None:
    """Refuse, before any training, what the loop cannot run: the JAX
    loop's up-front checks (its engine/active_loop.py:34-45; the reference
    asserts only at selection time, after a whole training round), then
    ``random``, ``accuracy_eval`` and ``accuracy_labels`` on region
    datasets, which the JAX loop lists as region-capable but fails at its
    first selection (ROADMAP C); and the passive datasets, whose pool has
    no unlabeled remainder to select from (the JAX loop fails at its first
    selection there too)."""
    region = dataset.endswith("_region")
    if not dataset.startswith("active_"):
        raise ValueError(f"dataset '{dataset}' is passive: the AL loop drives "
                         "active_*_{image,region}; train_torch.py trains on "
                         "the passive datasets")
    if mode == "coreset" and not dataset.endswith("_image"):
        raise AssertionError("only images supported for coreset approach")
    if region and mode not in _REGION_CAPABLE:
        raise NotImplementedError(f"selection mode '{mode}' does not support "
                                  "region datasets")
    if region and mode in ("random", "accuracy_eval", "accuracy_labels"):
        raise NotImplementedError(
            f"selection mode '{mode}' on region datasets: the JAX loop reads "
            "the region pool's remaining_image_paths, which it does not have "
            f"(ROADMAP C, {mode} on region datasets)")
    if mode not in _MODES:
        raise NotImplementedError(mode)


def run_active_loop(args, dataset_root: Optional[str] = None,
                    runs_root: Optional[str] = None, device=None,
                    mesh=None) -> dict:
    """Run the loop of ``args`` (a finalized ``ExperimentConfig``) on
    ``device`` (the CUDA card by default), or on ``mesh``'s ranks (each on
    its device). Returns ``{percent labeled: {mIoU, Acc, Acc_class, FWIoU,
    seconds}}``: the round's best metrics, and its wall seconds in
    ``train``, ``validate`` and ``select`` (the best-checkpoint reload, the
    scoring and the pool update)."""
    mode = args.active_selection_mode
    region = args.dataset.endswith("_region")
    check_args(args, mesh.world if mesh is not None else 1)
    device = mesh.device if mesh is not None else resolve_device(device)
    rng = random.Random(args.seed)

    training_set, train_loader, val_loader, _, nclass = make_dataloader(
        args.dataset, args.base_size, args.crop_size, args.batch_size,
        args.workers, args.overfit, init_set=args.seed_set,
        memory_hog=args.memory_hog, dataset_root=dataset_root,
        seed=args.seed, rng=rng, device=device, mesh=mesh)
    args.nclass = nclass

    saver = Saver(args, runs_root=runs_root, mesh=mesh)
    saver.save_experiment_config()
    summary = TensorboardSummary(saver.experiment_dir, mesh)
    writer = summary.create_summary()

    active_selector = get_active_selection_class(
        mode, nclass, training_set.store, args.crop_size, args.batch_size,
        device=device, mesh=mesh)
    max_subset_selector = get_max_subset_active_selector(
        training_set.store, args.crop_size, args.batch_size, device=device,
        mesh=mesh)

    total_iterations = min(
        len(training_set.image_paths) // args.active_batch_size - 1,
        args.max_iterations)

    # resume: replay selections.txt into the pool (active_train.py:364-369)
    if args.resume != 0 and args.resume_selections is not None:
        seed_size = len(training_set)
        with open(os.path.join(saver.experiment_dir,
                               args.resume_selections)) as f:
            paths = [x.strip().encode("ascii") for x in f.readlines()
                     if x.strip()]
        training_set.expand_training_set(paths[seed_size:])
        assert len(training_set) == (
            args.resume * args.active_batch_size + seed_size)

    assert args.eval_interval <= args.epochs
    assert args.epochs % args.eval_interval == 0

    trainer = Trainer(args, train_loader, val_loader, nclass, device=device,
                      runs_root=runs_root, rng=rng, mesh=mesh)
    trainer.initialize()
    history = {}

    for selection_iter in range(args.resume, total_iterations):
        print(f"ActiveIteration-{selection_iter:03d}/{total_iterations:03d}")
        fraction = round(training_set.get_fraction_of_labeled_data() * 100)
        trainer.setup_saver_and_summary(
            fraction, training_set.current_image_paths,
            regions=([training_set.current_paths_to_regions_map[x]
                      for x in training_set.current_image_paths]
                     if region else None))
        training_set.make_dataset_multiple_of_batchsize(args.batch_size)
        trainer.initialize()  # fresh model every round (active_train.py:394)

        early_stop = None
        if not args.no_early_stop:
            early_stop = EarlyStopChecker(patience=5,
                                          min_improvement=args.min_improvement)

        best = dict(mIoU=0.0, Acc=0.0, Acc_class=0.0, FWIoU=0.0)
        seconds = dict(train=0.0, validate=0.0, select=0.0)
        train_loss = test_loss = 0.0
        visualizations = None
        for outer_epoch in range(args.epochs // args.eval_interval):
            train_loss = 0.0
            for inner_epoch in range(args.eval_interval):
                epoch = outer_epoch * args.eval_interval + inner_epoch
                t0 = time.perf_counter()
                train_loss += trainer.training(epoch)
                seconds["train"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            (test_loss, mIoU, Acc, Acc_class, FWIoU,
             visualizations) = trainer.validation(epoch)
            seconds["validate"] += time.perf_counter() - t0
            best["mIoU"] = max(best["mIoU"], mIoU)
            best["Acc"] = max(best["Acc"], Acc)
            best["Acc_class"] = max(best["Acc_class"], Acc_class)
            best["FWIoU"] = max(best["FWIoU"], FWIoU)
            if early_stop is not None and early_stop(mIoU):
                print(f"Early stopping triggered after {epoch} epochs")
                break

        training_set.reset_dataset()
        history[fraction] = dict(best, seconds=seconds)

        writer.add_scalar("active_loop/train_loss",
                          train_loss / len(training_set), fraction)
        writer.add_scalar("active_loop/val_loss", test_loss, fraction)
        writer.add_scalar("active_loop/mIoU", best["mIoU"], fraction)
        writer.add_scalar("active_loop/Acc", best["Acc"], fraction)
        writer.add_scalar("active_loop/Acc_class", best["Acc_class"], fraction)
        writer.add_scalar("active_loop/fwIoU", best["FWIoU"], fraction)
        if visualizations is not None:
            summary.visualize_image(writer, args.dataset, visualizations[0],
                                    visualizations[1], visualizations[2],
                                    len(training_set.current_image_paths))

        if selection_iter == total_iterations - 1:
            break

        # -- selection (active_train.py:440-527) --
        t0 = time.perf_counter()
        trainer.load_best_checkpoint()
        _select(args, mode, active_selector, max_subset_selector,
                trainer.bundle, training_set, selection_iter, rng, runs_root)
        seconds["select"] = time.perf_counter() - t0
        if mesh is not None:
            mesh.assert_same(
                [getattr(training_set, name, None) for name in (
                    "current_image_paths", "weakly_labeled_image_paths",
                    "current_paths_to_regions_map")],
                "the labeled pool after a selection")

    writer.close()
    if trainer.writer is not None:
        trainer.writer.close()
    return history


def _select(args, mode, active_selector, max_subset_selector, bundle,
            training_set, selection_iter: int, rng: random.Random,
            runs_root: Optional[str]) -> None:
    """One selection and the pool update (the JAX loop's dispatch,
    engine/active_loop.py:152-275)."""
    k = args.active_batch_size
    seed = args.seed + selection_iter
    if args.dataset.endswith("_region"):
        # variance, variance_representative or noise_variance (_check_mode)
        print("Creating region maps..")
        regions, counts = active_selector.create_region_maps(
            bundle, training_set.image_paths,
            training_set.get_existing_region_maps(), args.active_region_size,
            k, seed=seed)
        if mode == "variance_representative":
            regions, counts = max_subset_selector.get_representative_regions(
                bundle, training_set.image_paths, regions,
                args.active_region_size)
        if mode != "noise_variance":
            print(f"Got {counts}/"
                  f"{math.ceil(k * args.crop_size ** 2 / args.active_region_size ** 2)}"
                  " regions")
        training_set.expand_training_set(
            regions, counts * args.active_region_size ** 2)
        return
    remaining = training_set.remaining_image_paths
    if mode == "random":
        selected = active_selector.get_random_uncertainity(remaining, k, rng=rng)
    elif mode in ("variance", "variance_representative"):
        print("Calculating entropies..")
        selected = active_selector.get_vote_entropy_for_images(
            bundle, remaining, k, seed=seed)
        if mode == "variance_representative":
            selected = max_subset_selector.get_representative_images(
                bundle, training_set.image_paths, selected)
    elif mode == "coreset":
        selected = active_selector.get_k_center_greedy_selections(
            k, bundle, remaining, training_set.current_image_paths)
    elif mode == "ceal_confidence":
        selected = active_selector.get_least_confident_samples(bundle,
                                                               remaining, k)
    elif mode == "ceal_margin":
        selected = active_selector.get_least_margin_samples(bundle, remaining, k)
    elif mode == "ceal_entropy":
        selected = active_selector.get_maximum_entropy_samples(bundle,
                                                               remaining, k)[0]
    elif mode == "ceal_fusion":
        selected = active_selector.get_fusion_of_confidence_margin_entropy_samples(
            bundle, remaining, k, rng=rng)
    elif mode == "ceal_entropy_weakly_labeled":
        selected, entropies = active_selector.get_maximum_entropy_samples(
            bundle, remaining, k)
        training_set.clear_weak_labels()
        threshold = (args.weak_label_entropy_threshold
                     - selection_iter * args.weak_label_threshold_decay)
        weak_labels = active_selector.get_weakly_labeled_data(
            bundle, remaining, threshold, entropies)
        for sample in selected:
            weak_labels.pop(sample, None)
        training_set.expand_training_set(selected)
        training_set.add_weak_labels(weak_labels)
        return
    elif mode == "noise_image":
        selected = active_selector.get_vote_entropy_for_images_with_input_noise(
            bundle, remaining, k, seed=seed)
    elif mode == "noise_feature":
        selected = active_selector.get_vote_entropy_for_images_with_feature_noise(
            bundle, remaining, k, seed=seed)
    elif mode == "noise_variance":
        selected = (active_selector
                    .get_vote_entropy_for_batch_with_noise_and_vote_entropy(
                        bundle, remaining, k, seed=seed))
    elif mode == "accuracy_labels":
        selected = active_selector.get_least_accurate_sample_using_labels(
            bundle, remaining, k)
    elif mode == "accuracy_eval":
        # the producer run's selections.txt for the next percentage
        # (active_train.py:513-527)
        pct = round(training_set.get_next_est_fraction_of_labeled_data(k) * 100)
        selections_file = os.path.join(runs_root or constants.RUNS,
                                       args.dataset, args.monitor_directory,
                                       f"run_{pct:04d}", "selections.txt")
        print("Waiting for the next folder to be available..", selections_file)
        selected = active_selector.wait_for_selected_samples(selections_file,
                                                             remaining)
    else:
        raise NotImplementedError(mode)
    training_set.expand_training_set(selected)
