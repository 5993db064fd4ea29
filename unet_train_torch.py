"""Standalone UNet trainer of the PyTorch port for the SEM
binary-segmentation dataset, on one CUDA card.

The same flags and output as ``unet_train.py`` (the JAX package's CLI,
reference unet_train.py): ``UNet(in_channels=1, num_classes=2)``, RMSprop
at a constant learning rate (0.001), plain cross-entropy summed over the
batch (``batch_average=False``), a per-epoch train line and a validation
line every 5 epochs:

    python unet_train_torch.py [--epochs 2000] [--crop-size 512] \\
        [--batch-size 2] [--lr 0.001]

The dataset is read from ``$DASS_DATASET_ROOT/sem/{train,val}/{images,masks}``
(``data/sem.py``). On the CPU, call ``main(argv, device="cpu")``. The
weights are drawn from a generator seeded 0, the train loader shuffles
from seed 0 and the train transforms draw from ``random.Random(0)``.
"""

import argparse
import random

import torch

from deep_active_semantic_segmentation_torch import resolve_device
from deep_active_semantic_segmentation_torch.config import refuse_multi_device


def build_unet_training(lr: float, device, generator=None):
    """(model, optimizer, train_step, eval_step) of the SEM trainer on
    ``device``: ``UNet(1, 2)`` drawn from ``generator`` (seeded 0 when
    omitted), RMSprop at the constant ``lr``, CE with
    ``batch_average=False``, both steps normalizing with SEM's mean and
    std."""
    from deep_active_semantic_segmentation_torch.data import sem
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_eval_step, make_train_step)

    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = build_model("unet", sem.SEMData.NUM_CLASSES, input_channels=1,
                        device=device, generator=generator)
    optimizer = build_optimizer("RMSprop", model.parameters())
    loss_fn = build_loss("ce", batch_average=False)
    norm = (sem.MEAN, sem.STD)
    train_step = make_train_step(model, optimizer, loss_fn,
                                 constant_schedule(lr), norm=norm)
    eval_step = make_eval_step(model, sem.SEMData.NUM_CLASSES, loss_fn, norm=norm)
    return model, optimizer, train_step, eval_step


def get_loss_and_accuracy(eval_step, loader):
    """Mean pixel accuracy and loss over ``loader`` (the JAX package's
    unet_train.py:23-35, reference unet_train.py:47-61, quirks included:
    each batch's loss is multiplied by its real sample count and the sum
    divided by the number of batches). The per-batch counts stay on the
    device and are fetched once."""
    device_rows, nvalids = [], []
    for batch in loader.device_batches():
        n = batch["nvalid"]
        out = eval_step(batch, n)
        correct = (out["pred"][:n] == batch["label"][:n].long()).sum()
        device_rows.append(torch.stack([out["loss"].double(), correct.double()]))
        nvalids.append((n, batch["label"][:n].numel()))
    total_acc, total_loss = 0.0, 0.0
    rows = torch.stack(device_rows).tolist() if device_rows else []
    for (loss, correct), (n, pixels) in zip(rows, nvalids):
        total_acc += correct / pixels
        total_loss += loss * n
    batches = max(len(rows), 1)
    return total_acc / batches, total_loss / batches


def main(argv=None, dataset_root=None, device=None):
    """``device``: where training runs, the CUDA card by default (callers
    that mean the CPU say ``device="cpu"``). Returns (model, optimizer)."""
    parser = argparse.ArgumentParser(description="PyTorch SEM UNet training")
    parser.add_argument("--epochs", type=int, default=2000)
    parser.add_argument("--crop-size", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--num-devices", type=int, default=None,
                        help="one card; more than one is ROADMAP A15b")
    ns = parser.parse_args(argv)
    refuse_multi_device(ns.num_devices)
    device = resolve_device(device)

    from deep_active_semantic_segmentation_torch.data.loader import Loader
    from deep_active_semantic_segmentation_torch.data.sem import SEMData

    rng = random.Random(0)
    train_set = SEMData(ns.crop_size, "train", dataset_root=dataset_root, rng=rng)
    val_set = SEMData(ns.crop_size, "val", dataset_root=dataset_root, rng=rng)
    train_loader = Loader(train_set, ns.batch_size, shuffle=True, seed=0,
                          device=device)
    val_loader = Loader(val_set, 1, shuffle=False, device=device)
    model, optimizer, train_step, eval_step = build_unet_training(ns.lr, device)

    print("Initializing Training!")
    for i in range(ns.epochs):
        model.train()
        for step, batch in enumerate(train_loader.device_batches()):
            train_step(batch, step)
        train_acc, train_loss = get_loss_and_accuracy(eval_step, train_loader)
        print("Epoch", i + 1, "Train loss:", train_loss, "Train acc", train_acc)
        if (i + 1) % 5 == 0:
            val_acc, val_loss = get_loss_and_accuracy(eval_step, val_loader)
            print("Val loss:", val_loss, "val acc:", val_acc)
    return model, optimizer


if __name__ == "__main__":
    main()
