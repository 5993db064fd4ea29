"""Rank functions for the port's two-rank CPU tests
(tests/test_torch_parallel.py, tests/test_torch_sharded_scoring.py).

Each runs in a process that ``parallel.mesh.launch`` spawned (gloo, CPU),
as ``fn(mesh, setup_path, out_dir)``: it reads its inputs from the torch
file ``setup_path`` the test wrote and saves what it computed to
``<out_dir>/rank<r>.pt``. This module imports no JAX, so the ranks start
with torch alone; ``launch`` gives each the test process's one thread.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _save(mesh, out_dir, out):
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def _load(path):
    return torch.load(path, weights_only=False)


def _rows(mesh, x):
    """This rank's rows of a global batch."""
    per = x.shape[0] // mesh.world
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _deeplab(state_dict, mesh):
    from deep_active_semantic_segmentation_torch.models.deeplab import DeepLab
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        convert_cross_replica_bn)

    model = DeepLab(num_classes=19, backbone="mobilenet", output_stride=16,
                    mc_dropout=True)
    model.load_state_dict(state_dict)
    return convert_cross_replica_bn(model.train(), mesh)


def f64_image(image_u8):
    """A uint8 NHWC batch normalized on the host in f64 (ingest passes a
    float batch through)."""
    mean = np.array([0.485, 0.456, 0.406])
    std = np.array([0.229, 0.224, 0.225])
    return (image_u8 / 255.0 - mean) / std


def _train_step(mesh, setup, generator, dtype=torch.float32):
    """One SGD step (lr 0.01, balanced weights) of the setup's DeepLab on
    this rank's rows, in f32 on the uint8 wire or with f64 weights and a
    host-normalized f64 image; (loss, state_dict)."""
    from deep_active_semantic_segmentation_torch.models.factory import param_groups
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.optim import (
        build_optimizer)
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_train_step)

    model = _deeplab(setup["state_dict"], mesh).to(dtype)
    step = make_train_step(
        model, build_optimizer("SGD", param_groups(model, "deeplab")),
        build_loss("ce", class_weights=torch.from_numpy(setup["cw"]), mesh=mesh),
        constant_schedule(0.01), generator=generator, mesh=mesh)
    image = setup["image"] if dtype == torch.float32 else f64_image(setup["image"])
    out = step({"image": torch.from_numpy(_rows(mesh, image)),
                "label": torch.from_numpy(_rows(mesh, setup["label"]))}, 0)
    return float(out["loss"]), {k: v.clone() for k, v in model.state_dict().items()}


def parallel_checks(mesh, setup_path, out_dir):
    """Cross-replica BN, the three losses, the train step (dropout off,
    then on) and the eval step on this rank's rows."""
    from deep_active_semantic_segmentation_torch.ops import losses
    from deep_active_semantic_segmentation_torch.parallel import crossreplica
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_eval_step)

    setup = _load(setup_path)
    out = {}
    # batch norm: statistics, forward, backward and running statistics
    x = torch.from_numpy(_rows(mesh, setup["bn_x"]))
    out["bn_stats"] = [t.numpy() for t in crossreplica.batch_norm_stats(x, mesh)]
    bn = crossreplica.CrossReplicaBatchNorm2d(x.shape[1], mesh)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(setup["bn_w"]))
        bn.bias.copy_(torch.from_numpy(setup["bn_b"]))
    xg = x.clone().requires_grad_(True)
    y = bn(xg)
    (y * torch.from_numpy(_rows(mesh, setup["bn_dy"]))).sum().backward()
    out["bn"] = {"y": y.detach().numpy(), "dx": xg.grad.numpy(),
                 "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
                 "running_mean": bn.running_mean.numpy(),
                 "running_var": bn.running_var.numpy()}
    # the losses, with the global normalizers, and their gradients
    out["losses"] = {}
    for kind, batch_average in setup["loss_cases"]:
        logits = torch.from_numpy(_rows(mesh, setup["logits"])).requires_grad_(True)
        target = torch.from_numpy(_rows(mesh, setup["target"]))
        cw = torch.from_numpy(setup["cw5"]) if kind.startswith("weighted") else None
        if kind == "sample_weighted":
            loss = losses.sample_weighted_cross_entropy(
                logits, target, torch.from_numpy(_rows(mesh, setup["sw"])),
                setup["cw5"], batch_average=batch_average, mesh=mesh)
        else:
            fn = losses.focal_loss if "focal" in kind else losses.cross_entropy
            loss = fn(logits, target, class_weights=cw,
                      batch_average=batch_average, mesh=mesh)
        loss.backward()
        out["losses"][(kind, batch_average)] = (float(loss), logits.grad.numpy())
    # the train step: dropout off, then on from a seeded generator
    out["step"] = _train_step(mesh, setup, None)
    out["dropout_step"] = _train_step(
        mesh, setup, torch.Generator().manual_seed(setup["dropout_seed"]),
        torch.float64)
    # the eval step on a padded partial batch
    model = _deeplab(setup["state_dict"], mesh)
    step = make_eval_step(model, 19, losses.build_loss(
        "ce", batch_average=False, mesh=mesh), mesh=mesh)
    label = _rows(mesh, setup["eval_label"])
    nvalid = int((label != 255).reshape(len(label), -1).any(1).sum())
    ev = step({"image": torch.from_numpy(_rows(mesh, setup["image"])),
               "label": torch.from_numpy(label)}, nvalid)
    out["eval"] = {"loss": float(ev["loss"]), "confusion": ev["confusion"].numpy(),
                   "nvalid": nvalid}
    _save(mesh, out_dir, out)


def scoring_queries(selectors, bundle, keys, k, rng_seed):
    """Every query the sharded scorer serves, on one set of selectors
    (``{mode: selector}`` and a max-subset one): picks, scores, features
    and region boxes. The same function runs the one-rank reference."""
    import random

    from deep_active_semantic_segmentation_torch.ops.entropy import mean_over_pixels

    out = {}
    mc = selectors["variance"]
    out["variance"] = mc.get_vote_entropy_for_images(bundle, keys, k, seed=3)
    scorer = mc._scorer(bundle, 3)
    out["variance_scores"] = mc._collect_scores(
        keys, lambda b: mean_over_pixels(scorer(b)), include_labels=True,
        labels_as_mask=19)
    noise = selectors["noise_image"]
    out["noise_image"] = noise.get_vote_entropy_for_images_with_input_noise(
        bundle, keys, k, seed=4)
    out["noise_variance"] = (noise.get_vote_entropy_for_batch_with_noise_and_vote_entropy(
        bundle, keys, k, seed=5))
    ceal = selectors["ceal_entropy"]
    out["ceal_confidence"] = ceal.get_least_confident_samples(bundle, keys, k)
    out["ceal_margin"] = ceal.get_least_margin_samples(bundle, keys, k)
    out["ceal_entropy"], out["ceal_entropies"] = ceal.get_maximum_entropy_samples(
        bundle, keys, k)
    out["ceal_fusion"] = ceal.get_fusion_of_confidence_margin_entropy_samples(
        bundle, keys, k, rng=random.Random(rng_seed))
    weak = ceal.get_weakly_labeled_data(bundle, keys, float(np.median(
        out["ceal_entropies"])), out["ceal_entropies"])
    out["weak_labels"] = {p: np.asarray(v) for p, v in weak.items()}
    core = selectors["coreset"]
    out["coreset_features"] = core.extract_features(bundle, keys).numpy()
    out["coreset"] = core.get_k_center_greedy_selections(k, bundle, keys[2:], keys[:2])
    if bundle.model.model_name == "deeplab":
        existing = [[(0, 0, 9, 9)] if i % 3 == 0 else [] for i in range(len(keys))]
        out["regions"] = mc.create_region_maps(bundle, keys, existing, 9, 1, seed=6)
        out["representative"] = selectors["max_subset"].get_representative_images(
            bundle, keys, keys[:2 * k])
    return out


def scoring_selectors(store, crop, batch, mesh=None, device="cpu"):
    from deep_active_semantic_segmentation_torch.selection import (
        get_active_selection_class, get_max_subset_active_selector)

    out = {mode: get_active_selection_class(mode, 19, store, crop, batch,
                                            device=device, mesh=mesh)
           for mode in ("variance", "noise_image", "ceal_entropy", "coreset")}
    out["max_subset"] = get_max_subset_active_selector(store, crop, batch,
                                                       device=device, mesh=mesh)
    return out


def scoring_checks(mesh, setup_path, out_dir):
    """The setup's queries on both models, sharded over the ranks; the
    kernels' launch counts (their plain versions run on the CPU)."""
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.data import native
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.selection import ModelBundle

    native.set_num_threads(1)
    setup = _load(setup_path)
    constants.MC_STEPS = setup["mc_steps"]
    out = {}
    for arch, (model, crop) in setup["models"].items():
        selectors = scoring_selectors(DirectoryStore(setup["root"]), crop,
                                      setup["batch"], mesh=mesh)
        out[arch] = scoring_queries(selectors, ModelBundle(model.eval(), mesh.device),
                                    setup["keys"], setup["k"], setup["rng_seed"])
    _save(mesh, out_dir, out)


def loop_checks(mesh, setup_path, out_dir):
    """Two-round AL loops on this rank, every round selecting with the
    setup's fixed weights; records each rank's labeled pool per round."""
    from deep_active_semantic_segmentation_torch import constants
    from deep_active_semantic_segmentation_torch.data import native, pools
    from deep_active_semantic_segmentation_torch.engine import trainer
    from deep_active_semantic_segmentation_torch.engine.active_loop import (
        run_active_loop)

    native.set_num_threads(1)
    setup = _load(setup_path)
    constants.MC_STEPS = setup["mc_steps"]
    trainer.Trainer.load_best_checkpoint = (
        lambda self: self.model.load_state_dict(setup["state_dict"]))
    labeled = []
    expand = pools.ActiveImagePool.expand_training_set

    def recording_expand(self, paths):
        expand(self, paths)
        labeled.append(list(self.current_image_paths))

    pools.ActiveImagePool.expand_training_set = recording_expand
    out = {}
    for cfg in setup["configs"]:
        labeled.clear()
        history = run_active_loop(cfg, dataset_root=setup["root"],
                                  runs_root=setup["runs"], mesh=mesh)
        out[cfg.checkname] = {"labeled": list(labeled), "rounds": sorted(history)}
    _save(mesh, out_dir, out)


def failing_rank(mesh, setup_path, out_dir):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.barrier()
