"""Run-directory savers (parity: the JAX package's utils/saver.py:33-90,
itself the reference utils/saver.py:10-78).

``<RUNS>/<experiment_group>/<checkname>/run_{pct:04d}/`` per AL round,
with ``selections.txt`` (``path[,r,c,h,w...]`` lines), ``best_pred.txt``
and ``parameters.txt`` byte-compatible with the JAX package's, and
``checkpoint.ckpt`` / ``best.ckpt`` as ``torch.save`` files. The passive
saver (``experiment_{n}`` dirs) comes with ``train.py`` (ROADMAP A14).
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, is_dataclass

from deep_active_semantic_segmentation_torch import constants
from deep_active_semantic_segmentation_torch.utils.checkpoint import save_checkpoint

CHECKPOINT_NAME = "checkpoint.ckpt"
BEST_NAME = "best.ckpt"


def _args_dict(args):
    if is_dataclass(args):
        return asdict(args)
    return vars(args)


class Saver:
    def __init__(self, args, experiment_group=None, runs_root=None):
        self.args = args
        if experiment_group is None:
            experiment_group = _args_dict(args)["dataset"]
        root = runs_root or constants.RUNS
        self.directory = os.path.join(root, experiment_group,
                                      _args_dict(args)["checkname"])
        self.experiment_dir = self.directory
        os.makedirs(self.experiment_dir, exist_ok=True)

    def save_experiment_config(self):
        with open(os.path.join(self.experiment_dir, "parameters.txt"), "w") as f:
            f.write(json.dumps(_args_dict(self.args), indent=4, sort_keys=True,
                               default=str))


class ActiveSaver(Saver):
    """Per-AL-round run_{pct:04d} directories (saver.py:43-78)."""

    def __init__(self, args, num_of_labeled_samples, experiment_group=None,
                 runs_root=None):
        super().__init__(args, experiment_group=experiment_group,
                         runs_root=runs_root)
        self.experiment_dir = os.path.join(
            self.directory, f"run_{num_of_labeled_samples:04d}")
        os.makedirs(self.experiment_dir, exist_ok=True)

    def save_checkpoint(self, model, optimizer, epoch, best_pred, is_best,
                        step=0, filename=CHECKPOINT_NAME):
        save_checkpoint(os.path.join(self.experiment_dir, filename), model,
                        optimizer, epoch, best_pred, step)
        if is_best:
            with open(os.path.join(self.experiment_dir, "best_pred.txt"), "w") as f:
                f.write(str(best_pred))
                f.write(f"\n{epoch}")
            save_checkpoint(os.path.join(self.experiment_dir, BEST_NAME),
                            model, optimizer, epoch, best_pred, step)

    def save_active_selections(self, paths, regions=None):
        """selections.txt — the scientific checkpoint (saver.py:68-78)."""
        filename = os.path.join(self.experiment_dir, "selections.txt")
        with open(filename, "w") as f:
            if regions:
                for p, region in zip(paths, regions):
                    region_line = ",".join(
                        ",".join(str(i) for i in r) for r in region)
                    f.write(p.decode("utf-8") + "," + region_line + "\n")
            else:
                for p in paths:
                    f.write(p.decode("utf-8") + "\n")
