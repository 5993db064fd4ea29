"""Rank functions for the port's two-rank CPU tests
(tests/test_torch_parallel.py, tests/test_torch_sharded_scoring.py,
tests/test_torch_dual_parallel.py, tests/test_torch_parallel_drivers.py,
tests/test_torch_spatial.py, tests/test_torch_spatial_zoo.py).

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


# ------------------------------------------------ the two-headed steps

def dual_train_step(setup, mesh, generator=None, dtype=torch.float32,
                    enet=False, weights=(0.7, 0.3), device="cpu"):
    """One SGD step (lr 0.01, class-weighted CE, error classes [w_wrong,
    1 - w_wrong]) of the setup's accuracy predictor on this rank's rows
    (``mesh`` None: the whole batch, on ``device``); dropout from
    ``generator``, f32 on the uint8 wire or f64 weights on a
    host-normalized f64 image: ({loss, loss_dl, loss_un}, state_dict on
    the host)."""
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        convert_cross_replica_bn)
    from deep_active_semantic_segmentation_torch.parallel.optim import (
        build_optimizer)
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_dual_train_step)

    key = "enet" if enet else "deeplab"
    device = mesh.device if mesh is not None else torch.device(device)
    model = build_model("accuracy_predictor", setup["nclass"], device=device,
                        enet_head=enet)
    model.load_state_dict(setup[key]["state_dict"])
    convert_cross_replica_bn(model.train(), mesh)
    model.to(dtype)
    step = make_dual_train_step(
        model, build_optimizer("SGD", param_groups(model, "accuracy_predictor")),
        build_loss("ce", class_weights=torch.from_numpy(setup["cw"]).to(device),
                   mesh=mesh),
        build_loss("ce", class_weights=torch.from_numpy(setup["w_wrong"]).to(device),
                   mesh=mesh),
        constant_schedule(0.01), generator=generator, mesh=mesh)
    image, label = setup[key]["image"], setup[key]["label"]
    if dtype == torch.float64:
        image = f64_image(image)
    if mesh is not None:
        image, label = _rows(mesh, image), _rows(mesh, label)
    out = step({"image": torch.from_numpy(image).to(device),
                "label": torch.from_numpy(label).to(device)}, 0, *weights)
    return ({k: float(out[k]) for k in ("loss", "loss_dl", "loss_un")},
            {k: v.detach().cpu().clone() for k, v in model.state_dict().items()})


def dual_card_checks(mesh, setup_path, out_dir):
    """The two-headed f64 step with dropout on this rank's rows on its
    card (its generator seeded on the card)."""
    setup = _load(setup_path)
    gen = torch.Generator(device=mesh.device).manual_seed(setup["dropout_seed"])
    _save(mesh, out_dir, {"dropout_step": dual_train_step(setup, mesh, gen,
                                                          torch.float64)})


def dual_checks(mesh, setup_path, out_dir):
    """The two-headed train step (dropout off in f32; on, in f64; the
    ENet-headed one at the staged schedule's (0, 1) in f64) and the dual
    eval step on a padded partial batch, on this rank's rows."""
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_dual_eval_step)

    setup = _load(setup_path)
    out = {"step": dual_train_step(setup, mesh),
           "dropout_step": dual_train_step(
               setup, mesh, torch.Generator().manual_seed(setup["dropout_seed"]),
               torch.float64),
           "enet_step": dual_train_step(setup, mesh, dtype=torch.float64, enet=True,
                                        weights=(0.0, 1.0))}
    model = build_model("accuracy_predictor", setup["nclass"], device="cpu")
    model.load_state_dict(setup["deeplab"]["state_dict"])
    losses = [build_loss("ce", class_weights=torch.from_numpy(w), batch_average=False,
                         mesh=mesh) for w in (setup["cw"], setup["w_wrong"])]
    step = make_dual_eval_step(model, setup["nclass"], *losses, mesh=mesh)
    label = _rows(mesh, setup["deeplab"]["eval_label"])
    nvalid = int((label != 255).reshape(len(label), -1).any(1).sum())
    ev = step({"image": torch.from_numpy(_rows(mesh, setup["deeplab"]["image"])),
               "label": torch.from_numpy(label)}, nvalid, 0.7, 0.3)
    out["eval"] = {k: float(ev[k]) for k in ("loss", "loss_dl", "loss_un")}
    out["eval"].update(nvalid=nvalid, confusion=ev["confusion"].numpy(),
                       unet_confusion=ev["unet_confusion"].numpy())
    _save(mesh, out_dir, out)


# ------------------------------------------------------------ the drivers

def driver_checks(mesh, setup_path, out_dir):
    """The rank bodies of the four drivers on this rank, as their ``main``
    runs them on N ranks: accuracy_predictor_train_torch's loop in every
    configuration of the setup (each selection made with the setup's
    fixed weights), visualize_torch and eval_series_torch replays, and
    unet_train_torch's SEM run in f64 (``chip_smoke.f64_models``).
    Saves each's result."""
    import accuracy_predictor_train_torch as acc_driver
    import eval_series_torch
    from chip_smoke import f64_models
    import unet_train_torch
    import visualize_torch
    from deep_active_semantic_segmentation_torch.data import native
    from deep_active_semantic_segmentation_torch.engine import trainer

    native.set_num_threads(1)
    setup = _load(setup_path)
    trainer.Trainer.load_best_checkpoint = (
        lambda self: self.model.load_state_dict(setup["state_dict"]))
    out = {"accuracy": {}}
    for name, argv in setup["accuracy_runs"].items():
        out["accuracy"][name] = acc_driver._run(
            mesh, acc_driver.parse_args(argv), setup["root"], setup["runs"])
    out["visualize"] = visualize_torch._run(
        mesh, *visualize_torch.parse_args(setup["visualize_argv"]), setup["root"])
    out["eval_series"] = eval_series_torch._run(
        mesh, *eval_series_torch.parse_args(setup["eval_series_argv"]), setup["root"])
    with f64_models():
        out["unet"] = unet_train_torch.train(
            mesh, unet_train_torch.parse_args(setup["unet_argv"]), setup["sem_root"])[2]
    _save(mesh, out_dir, out)


# ------------------------------------------------ the spatial (height) axis

def _band(mesh, x, axis=2):
    """This rank's data rows of a global batch and its band of their rows
    (``axis``: the rows' axis, 2 for NCHW, 1 for NHWC and labels)."""
    from deep_active_semantic_segmentation_torch.parallel.spatial import shard_rows

    per = x.shape[0] // mesh.data_world
    x = x[mesh.data_rank * per:(mesh.data_rank + 1) * per]
    start, end = shard_rows(x.shape[axis], mesh, multiple=1)
    return x[(slice(None),) * axis + (slice(start, end),)]


def _conv_band(mesh, case):
    """The rows [start, end) of the global (padded) conv input this rank
    holds: equal bands of the unpadded rows, plus the padding rows at the
    global top and bottom (``sharded_conv``'s ``edge_rows``)."""
    top, bottom = case["edge"]
    n, r = mesh.spatial_world, mesh.spatial_rank
    h = (case["x"].shape[2] - top - bottom) // n
    start = r * h + (top if r else 0)
    return start, (r + 1) * h + top + (bottom if r == n - 1 else 0)


def spatial_primitives(mesh, cases):
    """Each case's forward band and gradients on this rank (f64)."""
    from deep_active_semantic_segmentation_torch.models.enet import (
        max_unpool2x, transposed_conv2x)
    from deep_active_semantic_segmentation_torch.models.layers import conv
    from deep_active_semantic_segmentation_torch.parallel import spatial

    axis = mesh.axis("spatial")
    out = []
    for case in cases:
        x_all = torch.from_numpy(case["x"])
        if case["kind"] == "conv":
            start, end = _conv_band(mesh, case)
            x = x_all[:, :, start:end].clone().requires_grad_(True)
            w = torch.from_numpy(case["weight"])
            layer = conv(w.shape[1] * case["groups"], w.shape[0], w.shape[2],
                         case["stride"], case["pad"], case["dilation"],
                         case["groups"]).double()
            with torch.no_grad():
                layer.weight.copy_(w)
            layer.edge_rows = case["edge"]
            y = spatial.sharded_conv(layer, x, axis)
            dy = _band(mesh, torch.from_numpy(case["dy"]))
            (y * dy).sum().backward()
            out.append({"y": y.detach().numpy(), "dx": x.grad.numpy(),
                        "dw": layer.weight.grad.numpy()})
            continue
        if case["kind"] in ("adaptive_pool", "resize_replicated"):
            out.append(_replicated_case(mesh, axis, case))
            continue
        x = _band(mesh, x_all).clone().requires_grad_(True)
        got = {}
        if case["kind"] == "resize":
            oh, ow = case["out"]
            y = spatial.resize_rows(x, oh // mesh.spatial_world, ow, axis)
        elif case["kind"] == "mean":
            y = spatial.spatial_mean(x, axis)
        elif case["kind"] == "max_pool":
            y, selector = spatial.sharded_max_pool(x, axis, selector=True)
            got["selector"] = selector.numpy()
        elif case["kind"] == "conv_transpose":
            w = torch.from_numpy(case["weight"])
            layer = transposed_conv2x(w.shape[0], w.shape[1]).double()
            with torch.no_grad():
                layer.weight.copy_(w)
            layer.shard = axis
            y = layer(x)
        else:   # ENet's unpool, its selector from the whole image's pool
            selector = _band(mesh, torch.from_numpy(case["selector"]))
            y = max_unpool2x(x, selector, axis)
        dy = (torch.from_numpy(case["dy"]) if case["kind"] == "mean"
              else _band(mesh, torch.from_numpy(case["dy"])))
        (y * dy).sum().backward()
        got.update(y=y.detach().numpy(), dx=x.grad.numpy())
        if case["kind"] == "conv_transpose":
            got["dw"] = layer.weight.grad.numpy()
        out.append(got)
    return out


def _replicated_case(mesh, axis, case):
    """FastSCNN's pyramid pool on the bands (the same map on every rank)
    or the resize of a map every rank holds to this rank's rows."""
    from deep_active_semantic_segmentation_torch.models.fastscnn import (
        adaptive_pool_matrix)
    from deep_active_semantic_segmentation_torch.parallel import spatial

    x_all = torch.from_numpy(case["x"])
    if case["kind"] == "adaptive_pool":
        x = _band(mesh, x_all).clone().requires_grad_(True)
        size = case["size"]
        y = spatial.band_adaptive_pool(
            x, adaptive_pool_matrix(x_all.shape[2], size, "cpu", x.dtype),
            adaptive_pool_matrix(x_all.shape[3], size, "cpu", x.dtype), axis)
        dy = torch.from_numpy(case["dy"])
    else:
        x = x_all.clone().requires_grad_(True)
        oh, ow = case["out"]
        y = spatial.resize_replicated(x, oh // mesh.spatial_world, ow, axis)
        dy = _band(mesh, torch.from_numpy(case["dy"]))
    (y * dy).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy()}


def spatial_losses(mesh, setup):
    """The four losses on this rank's band of the logits: (value, logits
    gradient) per case."""
    from deep_active_semantic_segmentation_torch.ops import losses

    out = {}
    for kind, batch_average in setup["loss_cases"]:
        logits = _band(mesh, torch.from_numpy(setup["logits"])).clone()
        logits.requires_grad_(True)
        target = _band(mesh, torch.from_numpy(setup["target"]), 1)
        cw = torch.from_numpy(setup["cw5"]) if kind.startswith("weighted") else None
        if kind == "sample_weighted":
            per = setup["sw"].shape[0] // mesh.data_world
            sw = setup["sw"][mesh.data_rank * per:(mesh.data_rank + 1) * per]
            loss = losses.sample_weighted_cross_entropy(
                logits, target, torch.from_numpy(sw), setup["cw5"],
                batch_average=batch_average, mesh=mesh)
        else:
            fn = losses.focal_loss if "focal" in kind else losses.cross_entropy
            loss = fn(logits, target, class_weights=cw, batch_average=batch_average,
                      mesh=mesh)
        loss.backward()
        out[(kind, batch_average)] = (float(loss), logits.grad.numpy())
    return out


def _spatial_model(setup, mesh, device):
    """The setup's model (``arch``, ``backbone``, ``os``, ``classes``;
    DeepLab-MobileNetV2 os16, 19 classes, by default) in train mode with
    its BNs converted for ``mesh``."""
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        convert_cross_replica_bn)

    model = build_model(setup.get("arch", "deeplab"), setup.get("classes", 19),
                        backbone=setup.get("backbone", "mobilenet"),
                        output_stride=setup.get("os", 16), mc_dropout=True,
                        device=device)
    model.load_state_dict(setup["state_dict"])
    return convert_cross_replica_bn(model.train(), mesh)


def _freeze_bn(model):
    """``model`` with every batch norm at its running statistics (eval
    mode) while the rest trains."""
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    return model


def spatial_train_step(mesh, setup, dtype=torch.float64, spatial=True,
                       dropout_seed=None, device="cpu", frozen_bn=False):
    """One SGD step (lr 0.01, the setup's class weights) of the setup's
    model (``_spatial_model``; ``frozen_bn``: its batch norms at their
    running statistics) on this rank's data rows (``spatial``: and its
    band of their rows), f64 weights on the host-normalized f64 image or
    f32 on the uint8 wire; (loss, state_dict on the host). ``mesh`` None:
    one process on the whole batch, on ``device``; dropout from a
    generator on the device."""
    from deep_active_semantic_segmentation_torch.models.factory import param_groups
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.optim import (
        build_optimizer)
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_train_step)

    device = mesh.device if mesh is not None else torch.device(device)
    model = _spatial_model(setup, mesh, device).to(device, dtype)
    if frozen_bn:
        _freeze_bn(model)
    gen = (None if dropout_seed is None
           else torch.Generator(device=device).manual_seed(dropout_seed))
    step = make_train_step(
        model, build_optimizer("SGD", param_groups(model, setup.get("arch", "deeplab"))),
        build_loss("ce", class_weights=torch.from_numpy(setup["cw"]).to(device),
                   mesh=mesh),
        constant_schedule(0.01), generator=gen, mesh=mesh,
        spatial=spatial and mesh is not None)
    image = setup["image"] if dtype == torch.float32 else f64_image(setup["image"])
    image, label = torch.from_numpy(image), torch.from_numpy(setup["label"])
    if mesh is not None and spatial:
        image, label = _band(mesh, image, 1), _band(mesh, label, 1)
    elif mesh is not None:
        per = image.shape[0] // mesh.data_world
        rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
        image, label = image[rows], label[rows]
    out = step({"image": image.to(device), "label": label.to(device)}, 0)
    return float(out["loss"]), {k: v.detach().cpu().clone()
                                for k, v in model.state_dict().items()}


def spatial_card_checks(mesh, setup_path, out_dir):
    """The spatial step in f64 with dropout on this rank's card."""
    setup = _load(setup_path)
    _save(mesh, out_dir, {"f64_step": spatial_train_step(
        mesh, setup, dropout_seed=setup["dropout_seed"])})


def spatial_checks(mesh, setup_path, out_dir):
    """On this rank of a (data x spatial) mesh: the primitives, the
    losses on bands, the spatial step in f64 with dropout and in f32
    without, and the data-only step in f64 (the spatial ranks of a row
    replicas)."""
    setup = _load(setup_path)
    out = {"prims": spatial_primitives(mesh, setup["prims"])}
    if setup.get("steps"):
        out["losses"] = spatial_losses(mesh, setup)
        steps = {"f64_step": spatial_train_step(mesh, setup,
                                                dropout_seed=setup["dropout_seed"]),
                 "f32_step": spatial_train_step(mesh, setup, torch.float32),
                 "data_only_step": spatial_train_step(mesh, setup, spatial=False)}
        # rank 0's tensors in full, every rank's digest of them
        for name, (loss, state) in steps.items():
            out[name] = (loss, state if mesh.main else None, state_digest(state))
    _save(mesh, out_dir, out)


def zoo_state_dict(spec, seed: int = 4):
    """The weights of ``spec``'s model (``_spatial_model``'s keys) drawn
    from ``seed``, its BN biases ~0.1 N(0, 1) (off the ReLU kinks,
    ROADMAP C): the same in the test process and in every rank."""
    from deep_active_semantic_segmentation_torch.models.factory import build_model

    gen = torch.Generator().manual_seed(seed)
    model = build_model(spec["arch"], spec["classes"], backbone=spec["backbone"],
                        output_stride=spec["os"], mc_dropout=True, device="cpu",
                        generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    return model.state_dict()


def state_gap(got, want) -> float:
    """The largest difference of ``got``'s floating tensors from
    ``want``'s over ``want``'s largest value (its other tensors equal)."""
    floats = [k for k, v in want.items() if v.is_floating_point()]
    scale = max(float(want[k].abs().max()) for k in floats)
    assert all(torch.equal(got[k], v) for k, v in want.items()
               if not v.is_floating_point())
    return max(float((got[k] - want[k]).abs().max()) for k in floats) / scale


def spatial_zoo_checks(mesh, setup_path, out_dir):
    """On this rank of a (data x spatial) mesh: the primitives, then each
    of the setup's models' (``zoo_state_dict``'s weights) spatial step in
    f64 with dropout, its loss and state digest, and on rank 0 the
    one-process step's loss and ``state_gap`` to it; for the models in
    ``f32``, the f32 step without dropout, BN at its running statistics
    (rank 0's state in full). Rank 0 compares the f64 states itself, so
    no rank writes an f64 state to disk."""
    setup = _load(setup_path)
    out = {"prims": spatial_primitives(mesh, setup["prims"])}
    seed = setup["dropout_seed"]
    for name, model in setup["models"].items():
        model = dict(model, state_dict=zoo_state_dict(model))
        loss, state = spatial_train_step(mesh, model, dropout_seed=seed)
        got = {"f64": (loss, state_digest(state))}
        if mesh.main:
            ref_loss, ref = spatial_train_step(None, model, dropout_seed=seed)
            got["one_process"] = (ref_loss, state_gap(state, ref))
        if name in setup["f32"]:
            loss, state = spatial_train_step(mesh, model, torch.float32, frozen_bn=True)
            got["f32"] = (loss, state_digest(state), state if mesh.main else None)
        out[name] = got
    _save(mesh, out_dir, out)


def state_digest(state) -> str:
    import hashlib

    digest = hashlib.sha1()
    for k in sorted(state):
        digest.update(state[k].numpy().tobytes())
    return digest.hexdigest()
