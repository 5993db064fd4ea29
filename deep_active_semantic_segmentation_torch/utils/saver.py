"""Run-directory savers (parity: the JAX package's utils/saver.py:33-120,
itself the reference utils/saver.py:10-123).

``<RUNS>/<experiment_group>/<checkname>/run_{pct:04d}/`` per AL round,
with ``selections.txt`` (``path[,r,c,h,w...]`` lines), ``best_pred.txt``
and ``parameters.txt`` byte-compatible with the JAX package's, and
``checkpoint.ckpt`` / ``best.ckpt`` as ``torch.save`` files. A passive
run (``train_torch.py``) writes ``experiment_{n}/`` directories and
promotes its checkpoint to ``<checkname>/model_best.ckpt`` when its best
mIoU beats every earlier experiment's ``best_pred.txt``.

``mesh`` (a data-parallel run, ``parallel/mesh.py``): only rank 0 makes
directories and writes files; every rank knows the paths (a passive
run's experiment number is rank 0's).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from dataclasses import asdict, is_dataclass

from deep_active_semantic_segmentation_torch import constants
from deep_active_semantic_segmentation_torch.utils.checkpoint import save_checkpoint

CHECKPOINT_NAME = "checkpoint.ckpt"
BEST_NAME = "best.ckpt"


def _args_dict(args):
    if is_dataclass(args):
        return asdict(args)
    return vars(args)


def _write_best_pred(directory: str, best_pred, epoch) -> None:
    with open(os.path.join(directory, "best_pred.txt"), "w") as f:
        f.write(str(best_pred))
        f.write(f"\n{epoch}")


class Saver:
    """``remove_existing`` deletes ``<checkname>/`` first (the JAX
    package's saver.py:34-46)."""

    def __init__(self, args, experiment_group=None, remove_existing=False,
                 runs_root=None, mesh=None):
        self.args = args
        self.mesh = mesh
        self.writes = mesh is None or mesh.main
        if experiment_group is None:
            experiment_group = _args_dict(args)["dataset"]
        root = runs_root or constants.RUNS
        self.directory = os.path.join(root, experiment_group,
                                      _args_dict(args)["checkname"])
        self.experiment_dir = self.directory
        if remove_existing and self.writes and os.path.exists(self.experiment_dir):
            shutil.rmtree(self.experiment_dir)
        self._makedirs()

    def _makedirs(self):
        if self.writes:
            os.makedirs(self.experiment_dir, exist_ok=True)

    def save_experiment_config(self):
        if not self.writes:
            return
        with open(os.path.join(self.experiment_dir, "parameters.txt"), "w") as f:
            f.write(json.dumps(_args_dict(self.args), indent=4, sort_keys=True,
                               default=str))


class ActiveSaver(Saver):
    """Per-AL-round run_{pct:04d} directories (saver.py:43-78)."""

    def __init__(self, args, num_of_labeled_samples, experiment_group=None,
                 runs_root=None, mesh=None):
        super().__init__(args, experiment_group=experiment_group,
                         runs_root=runs_root, mesh=mesh)
        self.experiment_dir = os.path.join(
            self.directory, f"run_{num_of_labeled_samples:04d}")
        self._makedirs()

    def save_checkpoint(self, model, optimizer, epoch, best_pred, is_best,
                        step=0, filename=CHECKPOINT_NAME):
        if not self.writes:
            return
        save_checkpoint(os.path.join(self.experiment_dir, filename), model,
                        optimizer, epoch, best_pred, step)
        if is_best:
            _write_best_pred(self.experiment_dir, best_pred, epoch)
            save_checkpoint(os.path.join(self.experiment_dir, BEST_NAME),
                            model, optimizer, epoch, best_pred, step)

    def save_active_selections(self, paths, regions=None):
        """selections.txt — the scientific checkpoint (saver.py:68-78)."""
        if not self.writes:
            return
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


class PassiveSaver(Saver):
    """``experiment_{n}`` directories and the cross-experiment
    ``model_best.ckpt`` promotion (the JAX package's saver.py:93-120,
    reference saver.py:81-123). ``n`` is one more than that of the last
    ``experiment_*`` in sorted (string) order, as in the reference."""

    def __init__(self, args, runs_root=None, mesh=None):
        super().__init__(args, runs_root=runs_root, mesh=mesh)
        self.runs = sorted(glob.glob(os.path.join(self.directory, "experiment_*")))
        run_id = int(self.runs[-1].split("_")[-1]) + 1 if self.runs else 0
        if mesh is not None:
            self.runs, run_id = mesh.broadcast_object((self.runs, run_id))
        self.experiment_dir = os.path.join(self.directory, f"experiment_{run_id}")
        self._makedirs()

    def save_checkpoint(self, model, optimizer, epoch, best_pred, is_best,
                        step=0, filename=CHECKPOINT_NAME):
        """The epoch's checkpoint; when it is the best so far, its
        ``best_pred.txt`` and, when it beats every earlier experiment's
        best (and 0), its copy as ``<checkname>/model_best.ckpt``."""
        if not self.writes:
            return
        filepath = os.path.join(self.experiment_dir, filename)
        save_checkpoint(filepath, model, optimizer, epoch, best_pred, step)
        if not is_best:
            return
        _write_best_pred(self.experiment_dir, best_pred, epoch)
        previous = [0.0]
        for run in self.runs:
            path = os.path.join(run, "best_pred.txt")
            if os.path.exists(path):
                with open(path) as f:
                    previous.append(float(f.readline()))
        if best_pred > max(previous):
            shutil.copyfile(filepath, os.path.join(self.directory,
                                                   "model_best.ckpt"))
