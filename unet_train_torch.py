"""Standalone UNet trainer of the PyTorch port for the SEM
binary-segmentation dataset, on one or more CUDA cards.

The same flags and output as ``unet_train.py`` (the JAX package's CLI,
reference unet_train.py): ``UNet(in_channels=1, num_classes=2)``, RMSprop
at a constant learning rate (0.001), plain cross-entropy summed over the
batch (``batch_average=False``), a per-epoch train line and a validation
line every 5 epochs:

    python unet_train_torch.py [--epochs 2000] [--crop-size 512] \\
        [--batch-size 2] [--lr 0.001] [--num-devices N]

It runs data-parallel on every visible card (``--num-devices N`` for N
of them), or on the ranks of ``torchrun --nproc-per-node N
unet_train_torch.py ...``: ``--batch-size`` is the global batch and must
divide by N; each rank trains on its rows (the model in
DistributedDataParallel, cross-replica batch norm, the loss's normalizer
the global batch's), and the printed losses and accuracies are summed
over the ranks, so they are one card's. The validation batch stays 1 as
in the JAX CLI: rank 0 holds the image and the other ranks a pad row
that counts for nothing (the JAX CLI's 1-row batch on a 2-device mesh
raises instead; ROADMAP C).

The dataset is read from ``$DASS_DATASET_ROOT/sem/{train,val}/{images,masks}``
(``data/sem.py``). On the CPU, call ``main(argv, device="cpu")`` (with
``--num-devices 2``, two gloo ranks). The weights are drawn from a
generator seeded 0, the train loader shuffles from seed 0 and the train
transforms draw from ``random.Random(0)``.
"""

import argparse
import random

import torch


def build_unet_training(lr: float, device, generator=None, mesh=None):
    """(model, optimizer, train_step, eval_step) of the SEM trainer on
    ``device`` (or ``mesh``'s rank): ``UNet(1, 2)`` drawn from
    ``generator`` (seeded 0 when omitted), RMSprop at the constant ``lr``,
    CE with ``batch_average=False``, both steps normalizing with SEM's
    mean and std; with ``mesh``, the data-parallel steps and
    cross-replica batch norm."""
    from deep_active_semantic_segmentation_torch.data import sem
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        convert_cross_replica_bn)
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_eval_step, make_train_step)

    if mesh is not None:
        device = mesh.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = build_model("unet", sem.SEMData.NUM_CLASSES, input_channels=1,
                        device=device, generator=generator)
    convert_cross_replica_bn(model, mesh)
    optimizer = build_optimizer("RMSprop", model.parameters())
    loss_fn = build_loss("ce", batch_average=False, mesh=mesh)
    norm = (sem.MEAN, sem.STD)
    train_step = make_train_step(model, optimizer, loss_fn,
                                 constant_schedule(lr), norm=norm, mesh=mesh)
    eval_step = make_eval_step(model, sem.SEMData.NUM_CLASSES, loss_fn,
                               norm=norm, mesh=mesh)
    return model, optimizer, train_step, eval_step


def get_loss_and_accuracy(eval_step, loader, mesh=None):
    """Mean pixel accuracy and loss over ``loader`` (the JAX package's
    unet_train.py:23-35, reference unet_train.py:47-61, quirks included:
    each batch's loss is multiplied by its real sample count and the sum
    divided by the number of batches). The per-batch counts stay on the
    device and are fetched once; with ``mesh`` (``eval_step`` built with
    it) the correct pixels and the valid samples are the global batch's,
    summed over the ranks in one all-reduce after the sweep."""
    losses, counts, pixels = [], [], 0
    for batch in loader.device_batches():
        n = batch["nvalid"]
        out = eval_step(batch, n)
        correct = (out["pred"][:n] == batch["label"][:n].long()).sum()
        losses.append(out["loss"].double())
        counts.append(torch.stack([correct.double(), correct.new_tensor(
            n, dtype=torch.float64)]))
        pixels = batch["label"][0].numel()
    if not losses:
        return 0.0, 0.0
    counts = torch.stack(counts)
    if mesh is not None:   # the losses are every rank's already
        mesh.all_reduce(counts)
    total_acc, total_loss = 0.0, 0.0
    for loss, (correct, n) in zip(torch.stack(losses).tolist(), counts.tolist()):
        total_acc += correct / (n * pixels)
        total_loss += loss * n
    return total_acc / len(losses), total_loss / len(losses)


def main(argv=None, dataset_root=None, device=None, backend=None):
    """``device``: where training runs, every visible CUDA card by default
    (callers that mean the CPU say ``device="cpu"``; an indexed card such
    as ``cuda:0`` holds every rank). ``backend``: the ranks' process-group
    backend. Returns (model, optimizer) on one rank or a ``torchrun``
    rank, None after spawning ranks (``parallel.mesh.launch``)."""
    from deep_active_semantic_segmentation_torch.parallel.mesh import (
        launch, process_batch_slice)

    ns = parse_args(argv)
    if ns.num_devices:
        process_batch_slice(ns.batch_size, 0, ns.num_devices)
    out = launch(train, (ns, dataset_root), num_devices=ns.num_devices,
                 device=device, backend=backend)
    return None if out is None else out[:2]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="PyTorch SEM UNet training")
    parser.add_argument("--epochs", type=int, default=2000)
    parser.add_argument("--crop-size", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--num-devices", type=int, default=None,
                        help="data-parallel ranks, one card each (default: "
                             "every visible card)")
    return parser.parse_args(argv)


def train(mesh, ns, dataset_root):
    """One rank's run (``parallel.mesh.launch``): (model, optimizer, the
    printed numbers as ``[(epoch, train loss, train acc, val loss or
    None, val acc or None)]``)."""
    from deep_active_semantic_segmentation_torch.data.loader import Loader
    from deep_active_semantic_segmentation_torch.data.sem import SEMData
    from deep_active_semantic_segmentation_torch.parallel.mesh import (
        process_batch_slice)

    process_batch_slice(ns.batch_size, mesh.rank, mesh.world)
    shard = dict(device=mesh.device, rank=mesh.rank, world=mesh.world)
    rng = random.Random(0)
    train_set = SEMData(ns.crop_size, "train", dataset_root=dataset_root, rng=rng)
    val_set = SEMData(ns.crop_size, "val", dataset_root=dataset_root, rng=rng)
    train_loader = Loader(train_set, ns.batch_size, shuffle=True, seed=0, **shard)
    val_loader = Loader(val_set, 1, shuffle=False, **shard)
    model, optimizer, train_step, eval_step = build_unet_training(
        ns.lr, mesh.device, mesh=mesh)

    print("Initializing Training!")
    log = []
    for i in range(ns.epochs):
        model.train()
        for step, batch in enumerate(train_loader.device_batches()):
            train_step(batch, step)
        train_acc, train_loss = get_loss_and_accuracy(eval_step, train_loader, mesh)
        print("Epoch", i + 1, "Train loss:", train_loss, "Train acc", train_acc)
        val_acc = val_loss = None
        if (i + 1) % 5 == 0:
            val_acc, val_loss = get_loss_and_accuracy(eval_step, val_loader, mesh)
            print("Val loss:", val_loss, "val acc:", val_acc)
        log.append((i + 1, train_loss, train_acc, val_loss, val_acc))
    return model, optimizer, log


if __name__ == "__main__":
    main()
