"""Experiment configuration (own copy of the JAX package's config.py).

The same dataclass, flags, defaults and derived rules, so one command line
gives both packages the same configuration and the same
``parameters.txt``. The reference's derived-default rules:

* auto epochs / batch size / lr keyed by dataset and scaled by device
  count (reference active_train.py:306-328);
* ``variance_representative`` doubles the active batch before the halving
  max-subset stage (reference active_train.py:334).

Flags that mean something only to the JAX package on a TPU are accepted
and kept in the configuration; what each does in the port:

* ``--scoring-precision``: TPU matmul precision of deterministic scoring;
  no effect (the card computes in f32; the MC forwards run TF32).
* ``--f32-wire``: the JAX package's f32 host->device wire; no effect, the
  port always ships the uint8 wire and normalizes on the device.
* ``--scan-steps k``: accepted; the trainer runs k single steps, which is
  numerically what the JAX package's k-step scan computes.
* ``--sync-bn``: accepted; on more than one rank the batch norms are
  always cross-replica, as in the JAX package's global step.
* ``--num-devices N``: N data-parallel ranks, one card each
  (``parallel/mesh.py``), in every driver; omitted, every visible card.
  ``finalize(n)`` applies the auto batch and lr rules with the run's n
  ranks.
* ``--remat``: raises (``parallel/steps.make_train_step``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
from dataclasses import dataclass
from typing import Optional


SELECTION_MODES = [
    "random", "variance", "coreset", "ceal_confidence", "ceal_margin",
    "ceal_entropy", "ceal_fusion", "ceal_entropy_weakly_labeled",
    "variance_representative", "noise_image", "noise_feature",
    "noise_variance", "accuracy_labels", "accuracy_eval",
]

DATASETS = [
    "cityscapes", "pascal",
    "active_cityscapes_image", "active_cityscapes_region",
    "active_pascal_image", "active_pascal_region",
]

_AUTO_EPOCHS = {"coco": 30, "cityscapes": 200, "active_cityscapes": 200, "pascal": 50}
_AUTO_LR = {"coco": 0.1, "cityscapes": 0.01, "active_cityscapes": 0.01, "pascal": 0.007}


@dataclass
class ExperimentConfig:
    # model
    architecture: str = "deeplab"          # deeplab | enet | fastscnn
    backbone: str = "resnet"               # resnet | mobilenet
    out_stride: int = 16
    sync_bn: Optional[bool] = None         # None -> auto by device count
    freeze_bn: bool = False
    # ImageNet-pretrained backbone from a local file (models/pretrained.py)
    pretrained: bool = True
    pretrained_weights: Optional[str] = None
    # data
    dataset: str = "active_cityscapes_image"
    base_size: int = 513
    crop_size: int = 513
    workers: int = 4
    overfit: bool = False
    memory_hog: bool = False
    seed_set: str = "set_0.txt"
    # training
    loss_type: str = "ce"                  # ce | focal
    epochs: Optional[int] = None
    start_epoch: int = 0
    batch_size: Optional[int] = None
    test_batch_size: Optional[int] = None
    use_balanced_weights: bool = False
    lr: Optional[float] = None
    lr_scheduler: str = "poly"             # poly | step | cos
    use_lr_scheduler: bool = False
    lr_step: int = 0
    optimizer: str = "SGD"                 # SGD | Adam
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False
    # precision / runtime: bfloat16 is the default train compute dtype
    # (autocast, f32 master weights and BN statistics)
    dtype: str = "bfloat16"                # compute dtype: float32 | bfloat16
    remat: bool = False                    # refused (parallel/steps.py)
    scan_steps: int = 1                    # runs k single steps
    uint8_wire: bool = True                # the port always ships uint8
    num_devices: Optional[int] = None      # ranks; None: every card
    scoring_precision: str = "high"        # TPU only; no effect
    # reproducibility / logging
    seed: int = -1
    resume: int = 0
    resume_selections: Optional[str] = None
    checkname: Optional[str] = None
    ft: bool = False
    eval_interval: int = 1
    no_val: bool = False
    # active learning
    active_batch_size: int = 50
    active_selection_mode: str = "random"
    active_region_size: int = 129
    max_iterations: int = 1000
    min_improvement: float = 0.01
    weak_label_entropy_threshold: float = 0.80
    weak_label_threshold_decay: float = 0.015
    monitor_directory: Optional[str] = None
    no_early_stop: bool = False
    # accuracy-predictor driver extras (accuracy_predictor_train.py:323-332)
    weight_unet: float = 0.30
    weight_wrong_label_unet: float = 0.75
    accuracy_selection: str = "softmax"
    no_end_to_end: bool = False
    symmetry: bool = False

    # -- derived (filled by finalize) --
    nclass: int = -1
    mc_dropout: bool = False

    def finalize(self, n_devices: int = 1) -> "ExperimentConfig":
        """Apply the reference's derived-default rules (active_train.py:299-343)
        for a run of ``n_devices`` ranks."""
        if self.num_devices is not None and self.num_devices != n_devices:
            raise ValueError(f"--num-devices {self.num_devices} in a run of "
                             f"{n_devices} ranks")
        cfg = dataclasses.replace(self)
        if cfg.sync_bn is None:
            cfg.sync_bn = n_devices > 1
        dataset_key = cfg.dataset.lower()
        for prefix in ("active_cityscapes", "active_pascal", "cityscapes", "pascal"):
            if dataset_key.startswith(prefix):
                dataset_key = prefix.replace("active_pascal", "pascal")
                break
        if cfg.epochs is None:
            cfg.epochs = _AUTO_EPOCHS[dataset_key]
        if cfg.batch_size is None:
            cfg.batch_size = 4 * n_devices
        if cfg.test_batch_size is None:
            cfg.test_batch_size = cfg.batch_size
        if cfg.lr is None:
            cfg.lr = _AUTO_LR[dataset_key] / (4 * n_devices) * cfg.batch_size
        if cfg.checkname is None:
            cfg.checkname = "deeplab-" + str(cfg.backbone)
        cfg.mc_dropout = cfg.active_selection_mode in (
            "variance", "variance_representative", "noise_variance")
        if cfg.active_selection_mode == "variance_representative":
            cfg.active_batch_size = cfg.active_batch_size * 2
        if cfg.seed == -1:
            cfg.seed = int(random.random() * 2000)
        return cfg

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=4, sort_keys=True)


def add_common_flags(parser: argparse.ArgumentParser,
                     selection_choices=None) -> None:
    """Register the reference's public flag surface (active_train.py:199-288).

    ``selection_choices`` overrides the --active-selection-mode enum (the
    accuracy-predictor driver has its own mode set, reference
    accuracy_predictor_train.py:327-328).
    """
    a = parser.add_argument
    a("--backbone", type=str, default="resnet",
      choices=["resnet", "xception", "drn", "mobilenet"])
    a("--out-stride", type=int, default=16)
    a("--dataset", type=str, default="active_cityscapes_image", choices=DATASETS)
    a("--use-sbd", action="store_true", default=False)
    a("--base-size", type=int, default=513)
    a("--crop-size", type=int, default=513)
    a("--sync-bn", type=lambda v: v.lower() in ("1", "true", "yes"), default=None,
      help="accepted; more than one rank always syncs batch norm")
    a("--freeze-bn", type=bool, default=False)
    a("--pretrained-weights", type=str, default=None,
      help="local backbone checkpoint (.pth/.pth.tar/.npz) transplanted "
           "into every fresh DeepLab backbone; stands in for the "
           "reference's model-zoo download")
    a("--no-pretrained", dest="pretrained", action="store_false", default=True,
      help="skip the pretrained-backbone transplant even when "
           "--pretrained-weights is set")
    a("--loss-type", type=str, default="ce", choices=["ce", "focal"])
    a("--workers", type=int, default=4)
    a("--epochs", type=int, default=None)
    a("--start_epoch", type=int, default=0)
    a("--batch-size", type=int, default=None)
    a("--test-batch-size", type=int, default=None)
    a("--use-balanced-weights", action="store_true", default=False)
    a("--lr", type=float, default=None)
    a("--lr-scheduler", type=str, default="poly", choices=["poly", "step", "cos"])
    a("--use-lr-scheduler", default=False, action="store_true")
    a("--optimizer", type=str, default="SGD", choices=["SGD", "Adam"])
    a("--momentum", type=float, default=0.9)
    a("--weight-decay", type=float, default=5e-4)
    a("--nesterov", action="store_true", default=False)
    a("--seed", type=int, default=-1)
    a("--resume", type=int, default=0)
    a("--checkname", type=str, default=None)
    a("--resume-selections", type=str, default=None)
    a("--ft", action="store_true", default=False)
    a("--eval-interval", type=int, default=1)
    a("--no-val", action="store_true", default=False)
    a("--overfit", action="store_true", default=False)
    a("--seed_set", default="set_0.txt")
    a("--active-batch-size", type=int, default=50)
    a("--active-selection-mode", type=str,
      default="random" if selection_choices is None else selection_choices[0],
      choices=selection_choices or SELECTION_MODES)
    a("--active-region-size", type=int, default=129)
    a("--max-iterations", type=int, default=1000)
    a("--min-improvement", type=float, default=0.01)
    a("--weak-label-entropy-threshold", type=float, default=0.80)
    a("--weak-label-threshold-decay", type=float, default=0.015)
    a("--monitor-directory", type=str, default=None)
    a("--memory-hog", action="store_true", default=False)
    a("--no-early-stop", action="store_true", default=False)
    a("--architecture", type=str, default="deeplab",
      choices=["deeplab", "enet", "fastscnn"])
    a("--dtype", type=str, default="bfloat16",
      choices=["float32", "bfloat16"])
    a("--scoring-precision", type=str, default="high",
      choices=["default", "high", "highest"],
      help="TPU matmul precision of deterministic scoring; no effect here")
    a("--remat", action="store_true", default=False,
      help="refused: checkpointing would redraw the dropout masks")
    a("--scan-steps", type=int, default=1,
      help="accepted; the trainer runs k single steps")
    a("--f32-wire", dest="uint8_wire", action="store_false", default=True,
      help="the JAX package's f32 wire; no effect, the port ships uint8")
    a("--num-devices", type=int, default=None,
      help="data-parallel ranks, one card each (default: every visible "
           "card)")


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    known = {f.name for f in dataclasses.fields(ExperimentConfig)}
    payload = {k: v for k, v in vars(args).items() if k in known}
    return ExperimentConfig(**payload)


def parse_cli(argv=None, description="PyTorch active segmentation") -> ExperimentConfig:
    parser = argparse.ArgumentParser(description=description)
    add_common_flags(parser)
    return config_from_args(parser.parse_args(argv))
