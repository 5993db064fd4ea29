"""The trainer of the AL loops (parity: the JAX package's
engine/trainer.py:44, itself the reference active_train.py:27-194 and,
with ``dual_head``, accuracy_predictor_train.py:25-241).

A fresh model and optimizer at every ``initialize()`` (one per AL round),
per-epoch training and validation with the reference's scalar tag schema,
best-checkpoint saving and reloading. Per-iteration losses stay on the
device during an epoch and are fetched once at its end; validation
accumulates the confusion matrix on the device.

Every random draw has an explicit source: the weight init and the dropout
masks come from one ``torch.Generator`` on the trainer's device, seeded
with ``args.seed`` and carried on from round to round; the validation's
visualization pick draws from the host stream ``rng`` (a
``random.Random``), the one the pools' train transforms draw from, in the
JAX package's order.

``dual_head`` trains the two-headed accuracy predictor (a DeepLab
segmentation head and the UNet error head, or a symmetric DeepLab one with
``args.symmetry``): ``training`` and ``validation`` take the epoch's loss
weights (w_dl, w_un), the error head's classes are weighted [w_wrong,
1 - w_wrong] (``args.weight_wrong_label_unet``), validation keeps the
error head's 2-class confusion (``val/UNetAcc``) and returns the 5-tuple
panel (image, seg target, seg prediction, error target, error
prediction); every train epoch writes that panel for one train batch.
The best checkpoint is chosen by the segmentation mIoU. With
``args.architecture == 'enet'`` the predictor's segmentation head is an
ENet (the JAX package's trainer.py:93-111).

Every architecture trains: DeepLab (MobileNetV2, ResNet-50/101), ENet and
FastSCNN, with the reference's learning-rate groups
(``models/factory.param_groups``). ``args.pretrained_weights`` (with
``args.pretrained``) transplants an ImageNet backbone into every DeepLab
head's backbone at every ``initialize()``, as the reference's per-round
re-init does (the JAX package's trainer.py:201-235): the file is read
once and kept on the host. ENet, FastSCNN and the error heads start from
the random init, as in the reference.

``train_grids`` (``train_torch.py``) writes one train-batch grid per
epoch, picked, as in the JAX package, over the VAL loader's length
(reference train.py:106); a pick past the train loader's end writes none.

``mesh`` (``parallel/mesh.py``; the JAX trainer's ``mesh``): the loaders
yield the rank's rows of each global batch, the model's batch norms
become ``CrossReplicaBatchNorm2d``s, the train step is data-parallel and
the eval step all-reduces, so every rank computes the same losses,
metrics and best epoch. Every rank draws the same host-stream numbers
(its summary writer on ranks other than 0 is a ``NullWriter``); only rank
0 writes files, and every rank reads ``best.ckpt`` after a barrier. The
weights, the dropout generator, the class weights (class counts summed
over the ranks) and the transplant are the same on every rank. The
two-headed trainer runs on one rank (ROADMAP A15b).
"""

from __future__ import annotations

import os
import random
import time
from typing import Optional

import torch

from deep_active_semantic_segmentation_torch import resolve_device
from deep_active_semantic_segmentation_torch.models import pretrained
from deep_active_semantic_segmentation_torch.models.factory import (
    build_model, param_groups)
from deep_active_semantic_segmentation_torch.ops.losses import build_loss
from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
    constant_schedule, make_schedule)
from deep_active_semantic_segmentation_torch.ops.metrics import Evaluator
from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
    convert_cross_replica_bn)
from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
from deep_active_semantic_segmentation_torch.parallel.steps import (
    make_dual_eval_step, make_dual_train_step, make_eval_step, make_train_step)
from deep_active_semantic_segmentation_torch.selection.base import ModelBundle
from deep_active_semantic_segmentation_torch.utils.checkpoint import load_checkpoint
from deep_active_semantic_segmentation_torch.utils.class_weights import (
    calculate_weights_labels)
from deep_active_semantic_segmentation_torch.utils.saver import (
    BEST_NAME, ActiveSaver)
from deep_active_semantic_segmentation_torch.utils.summaries import (
    TensorboardSummary)


class Trainer:
    def __init__(self, args, train_loader, val_loader, nclass: int,
                 device=None, dual_head: bool = False,
                 runs_root: Optional[str] = None,
                 rng: Optional[random.Random] = None,
                 train_grids: bool = False, mesh=None):
        self.args = args
        self.mesh = mesh
        if mesh is not None and mesh.distributed and dual_head:
            raise NotImplementedError("the two-headed trainer runs on one "
                                      "rank (ROADMAP A15b)")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        for loader in (train_loader, val_loader):
            if loader.device != self.device:
                raise ValueError(f"loader puts batches on {loader.device}, "
                                 f"the trainer runs on {self.device}")
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.nclass = nclass
        self.dual_head = dual_head
        self.train_grids = train_grids or dual_head
        self.runs_root = runs_root
        self.rng = rng if rng is not None else random.Random(args.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            args.seed if args.seed >= 0 else 0)
        self.writer = None
        self.saver = None
        self._class_weights = None
        self._pretrained = None   # the backbone file's tensors, read once

    # -- saver / summary (active_train.py:34-40) --
    def setup_saver_and_summary(self, num_current_labeled_samples, samples,
                                regions=None):
        """The round's run directory; ``regions`` (one box list per sample)
        makes selections.txt's lines ``path,r,c,h,w,...``."""
        self.num_current_labeled_samples = num_current_labeled_samples
        self.saver = ActiveSaver(self.args, num_current_labeled_samples,
                                 runs_root=self.runs_root, mesh=self.mesh)
        self.saver.save_experiment_config()
        self.saver.save_active_selections(samples, regions)
        self.summary = TensorboardSummary(self.saver.experiment_dir, self.mesh)
        if self.writer is not None:   # the previous round's
            self.writer.close()
        self.writer = self.summary.create_summary()

    # -- model/optimizer construction (active_train.py:42-87) --
    def initialize(self):
        args = self.args
        arch = "accuracy_predictor" if self.dual_head else args.architecture
        self.model = build_model(arch, self.nclass, backbone=args.backbone,
                                 output_stride=args.out_stride,
                                 mc_dropout=args.mc_dropout,
                                 device=self.device, generator=self.generator,
                                 enet_head=self.dual_head and args.architecture == "enet",
                                 symmetry=args.symmetry)
        convert_cross_replica_bn(self.model, self.mesh)
        self._transplant_pretrained_backbone()
        self.optimizer = build_optimizer(
            args.optimizer, param_groups(self.model, arch), args)

        if args.use_balanced_weights and self._class_weights is None:
            print("Calculating class weights..")
            self._class_weights = torch.as_tensor(
                calculate_weights_labels(self.train_loader, self.nclass,
                                         self.mesh),
                dtype=torch.float32, device=self.device)

        # the round's schedule geometry, read after the pool is padded to
        # a batch multiple
        ipe = max(len(self.train_loader), 1)
        self._geometry = (args.epochs * ipe, ipe)
        if args.use_lr_scheduler:
            schedule = make_schedule(args.lr_scheduler, args.lr, args.epochs,
                                     ipe, lr_step=args.lr_step)
        else:
            schedule = constant_schedule(args.lr)
        losses = [build_loss(args.loss_type, class_weights=self._class_weights,
                             batch_average=average, mesh=self.mesh)
                  for average in (True, False)]
        if self.dual_head:
            w_wrong = args.weight_wrong_label_unet
            unet_weights = torch.tensor([w_wrong, 1 - w_wrong],
                                        dtype=torch.float32, device=self.device)
            err_losses = [build_loss(args.loss_type, class_weights=unet_weights,
                                     batch_average=average)
                          for average in (True, False)]
            self.train_step = make_dual_train_step(
                self.model, self.optimizer, losses[0], err_losses[0], schedule,
                compute_dtype=args.dtype, generator=self.generator,
                remat=args.remat)
            self.eval_step = make_dual_eval_step(self.model, self.nclass,
                                                 losses[1], err_losses[1])
            self.unet_evaluator = Evaluator(2, self.device)
        else:
            self.train_step = make_train_step(
                self.model, self.optimizer, losses[0], schedule,
                compute_dtype=args.dtype, generator=self.generator,
                remat=args.remat, mesh=self.mesh)
            self.eval_step = make_eval_step(self.model, self.nclass, losses[1],
                                            mesh=self.mesh)
        self.step = 0
        self.evaluator = Evaluator(self.nclass, self.device)
        self.best_pred = 0.0

    def _transplant_pretrained_backbone(self):
        """The ImageNet backbone into the fresh DeepLab head's backbone
        (the segmentation head's, in the two-headed model)."""
        args = self.args
        if not (args.pretrained and args.pretrained_weights
                and args.architecture == "deeplab"):
            return
        if self._pretrained is None:
            self._pretrained = pretrained.backbone_state_dict(
                pretrained.load_backbone_state_dict(args.pretrained_weights),
                args.backbone)
        head = self.model.deeplab if self.dual_head else self.model
        pretrained.transplant_backbone(head.backbone, self._pretrained)

    @property
    def bundle(self) -> ModelBundle:
        return ModelBundle(self.model, self.device)

    def load_best_checkpoint(self):
        """Reload best.ckpt onto the trainer's device before selection
        (active_train.py:440-441), on every rank once rank 0 has written it."""
        if self.mesh is not None:
            self.mesh.barrier()
        path = os.path.join(self.saver.experiment_dir, BEST_NAME)
        payload = load_checkpoint(path, self.model, self.optimizer, self.device)
        self.step = payload["step"]

    def _save(self, epoch: int, is_best: bool):
        self.saver.save_checkpoint(self.model, self.optimizer, epoch + 1,
                                   self.best_pred, is_best=is_best,
                                   step=self.step)

    # -- one training epoch (active_train.py:89-127,
    #    accuracy_predictor_train.py:81-155) --
    def training(self, epoch: int, w_dl: Optional[float] = None,
                 w_un: Optional[float] = None) -> float:
        """One epoch; the dual trainer takes the epoch's loss weights."""
        num_img_tr = len(self.train_loader)
        self.model.train()
        weights = (w_dl, w_un) if self.dual_head else ()
        # the train grid shows one train batch, picked from the host stream
        # over the train loader for the dual trainer
        # (accuracy_predictor_train.py:91), over the val loader for the
        # passive one (train.py:106)
        vis_index = -1
        if self.train_grids and self.writer is not None:
            vis_index = int(self.rng.random() * (
                num_img_tr if self.dual_head else len(self.val_loader)))
        vis_batch = None
        device_losses, lrs = [], []
        epoch_start = time.perf_counter()
        n_images = 0
        for i, batch in enumerate(self.train_loader.device_batches()):
            n_images += batch["nvalid"]
            if i == vis_index:
                vis_batch = batch
            out = self.train_step(batch, self.step, *weights, *self._geometry)
            self.step += 1
            device_losses.append(torch.stack(
                [out[k] for k in ("loss", "loss_dl", "loss_un") if k in out]))
            lrs.append(out["lr"])
        losses = torch.stack(device_losses).tolist() if device_losses else []
        train_loss = 0.0
        for i, (loss, lr) in enumerate(zip(losses, lrs)):
            train_loss += loss[0]
            if self.writer is not None:
                it = i + num_img_tr * epoch
                self.writer.add_scalar("train/total_loss_iter", loss[0], it)
                if self.dual_head:
                    self.writer.add_scalar("train/total_loss_iter_dl", loss[1], it)
                    self.writer.add_scalar("train/total_loss_iter_un", loss[2], it)
                if self.args.use_lr_scheduler:
                    self.writer.add_scalar("train/learning_rate", lr, it)
        if self.mesh is not None:   # every rank's images
            n_images = int(self.mesh.all_reduce(torch.tensor([float(n_images)])))
        # the losses' fetch above waited for the card: the clock is honest
        imgs_per_sec = n_images / max(time.perf_counter() - epoch_start, 1e-9)
        if self.writer is not None:
            self.writer.add_scalar("train/total_loss_epoch", train_loss, epoch)
            self.writer.add_scalar("train/imgs_per_sec", imgs_per_sec, epoch)
        if vis_batch is not None:
            # predicted at the epoch's end with the eval step, as the JAX
            # trainer does (the reference logs the mid-epoch output)
            out = self.eval_step(vis_batch, self.args.batch_size, *weights)
            if self.dual_head:
                self.summary.create_single_visualization(
                    self.writer,
                    f"train/run_{self.num_current_labeled_samples:04d}",
                    self.args.dataset, vis_batch["image"], vis_batch["label"],
                    out["pred"], out["unet_target"], out["err_pred"], epoch)
            else:
                self.summary.visualize_image(
                    self.writer, self.args.dataset, vis_batch["image"],
                    vis_batch["label"], out["pred"], epoch, prefix="train")
        print(f"[Epoch: {epoch}] Loss: {train_loss:.3f} "
              f"BestPred: {self.best_pred:.3f} "
              f"({imgs_per_sec:.1f} imgs/s)")
        if self.args.no_val and self.saver is not None:
            self._save(epoch, is_best=False)
        return train_loss

    # -- validation (active_train.py:129-194,
    #    accuracy_predictor_train.py:157-241) --
    def validation(self, epoch: int, w_dl: Optional[float] = None,
                   w_un: Optional[float] = None):
        """The epoch's validation; the dual trainer takes the epoch's loss
        weights and returns the 5-tuple panel."""
        self.evaluator.reset()
        weights = (w_dl, w_un) if self.dual_head else ()
        if self.dual_head:
            self.unet_evaluator.reset()
        visualization_index = int(self.rng.random() * len(self.val_loader))
        vis = None
        device_losses = []
        for i, batch in enumerate(self.val_loader.device_batches()):
            out = self.eval_step(batch, batch["nvalid"], *weights)
            device_losses.append(out["loss"])
            self.evaluator.add_matrix(out["confusion"])
            if self.dual_head:
                self.unet_evaluator.add_matrix(out["unet_confusion"])
            if i == visualization_index:
                vis = [batch["image"], batch["label"], out["pred"]]
                if self.dual_head:
                    vis += [out["unet_target"], out["err_pred"]]
        test_loss = 0.0
        for loss in torch.stack(device_losses).tolist():
            test_loss += loss

        Acc = self.evaluator.Pixel_Accuracy()
        Acc_class = self.evaluator.Pixel_Accuracy_Class()
        mIoU = self.evaluator.Mean_Intersection_over_Union()
        FWIoU = self.evaluator.Frequency_Weighted_Intersection_over_Union()
        if self.writer is not None:
            self.writer.add_scalar("val/total_loss_epoch", test_loss, epoch)
            self.writer.add_scalar("val/mIoU", mIoU, epoch)
            self.writer.add_scalar("val/Acc", Acc, epoch)
            self.writer.add_scalar("val/Acc_class", Acc_class, epoch)
            self.writer.add_scalar("val/fwIoU", FWIoU, epoch)
            if self.dual_head:
                self.writer.add_scalar("val/UNetAcc",
                                       self.unet_evaluator.Pixel_Accuracy(),
                                       epoch)
        print(f"Validation: [Epoch: {epoch}] Acc:{Acc}, Acc_class:{Acc_class},"
              f" mIoU:{mIoU}, fwIoU: {FWIoU} Loss: {test_loss:.3f}")

        is_best = mIoU > self.best_pred
        if is_best:
            self.best_pred = mIoU
        if self.saver is not None:
            self._save(epoch, is_best)
        return test_loss, mIoU, Acc, Acc_class, FWIoU, vis
