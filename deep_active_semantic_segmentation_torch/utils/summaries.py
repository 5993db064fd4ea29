"""Tensorboard summaries (parity: the JAX package's utils/summaries.py,
itself the reference utils/summaries.py:11-67): the same writer factory,
scalar tag schema, Image / Prediction / Groundtruth grids and the
two-headed model's accuracy panel, and the per-image PNG dump of
``visualize_torch.py``.
tensorboardX is optional: without it a JSONL writer keeps the scalar
schema (tag, value, step), so a run on a machine without it still logs
everything. Images are NHWC uint8 wire batches; targets and predictions
(B, H, W) class maps, as numpy arrays or tensors on any device.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from deep_active_semantic_segmentation_torch.data.colormaps import (
    map_segmentation_to_colors, map_segmentations_to_colors)

try:
    from tensorboardX import SummaryWriter

    HAVE_TBX = True
except ImportError:  # pragma: no cover
    HAVE_TBX = False


class JsonlWriter:
    """Fallback scalar writer with the tensorboard API subset used."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": float(step)}) + "\n")
        self._f.flush()

    def add_image(self, tag, img, step):
        pass

    def close(self):
        self._f.close()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _grid(images_nhwc: np.ndarray) -> np.ndarray:
    """Horizontal grid, CHW float in [0,1] (torchvision make_grid analog)."""
    row = np.concatenate(list(images_nhwc), axis=1)
    return np.transpose(row, (2, 0, 1))


class NullWriter:
    """The writer of a data-parallel rank other than 0, which writes no
    file: the same calls, doing nothing, so that every rank runs the same
    code (and draws the same host-stream numbers) whether or not it logs."""

    def add_scalar(self, tag, value, step):
        pass

    def add_image(self, tag, img, step):
        pass

    def close(self):
        pass


class TensorboardSummary:
    """``mesh``: on a data-parallel rank other than 0, ``create_summary``
    gives a ``NullWriter``."""

    def __init__(self, directory, mesh=None):
        self.directory = directory
        self.writes = mesh is None or mesh.main

    def create_summary(self):
        if not self.writes:
            return NullWriter()
        if HAVE_TBX:
            return SummaryWriter(log_dir=self.directory)
        return JsonlWriter(self.directory)

    def visualize_image(self, writer, dataset, image, target, output,
                        global_step, prefix="val"):
        """image (B,H,W,3) uint8; target and output (B,H,W) class maps."""
        image = _host(image)[:3]
        target = _host(target)[:3]
        pred = _host(output)[:3]
        writer.add_image(f"{prefix}/Image",
                         _grid(image.astype(np.float32) / 255.0), global_step)
        writer.add_image(f"{prefix}/Prediction",
                         _grid(map_segmentations_to_colors(
                             pred.astype(np.uint8), dataset)), global_step)
        writer.add_image(f"{prefix}/Groundtruth",
                         _grid(map_segmentations_to_colors(
                             target.astype(np.uint8), dataset)), global_step)

    def create_single_visualization(self, writer, name, dataset, image,
                                    target_0, output_0, target_1, output_1,
                                    global_step):
        """The two-headed panel (the JAX package's summaries.py:89-122,
        reference summaries.py:45-58), which the dual trainer writes every
        train epoch and the accuracy-predictor driver at the end of every
        round: for each of the first 3 samples one 2x3 tile, [image | seg
        prediction | error prediction] over [zeros | seg ground truth |
        error target], the error maps in the ``binary`` colormap. image
        (B,H,W,3) uint8; the rest (B,H,W) class maps."""
        image = _host(image)
        maps = [_host(m) for m in (output_0, output_1, target_0, target_1)]
        for k in range(min(3, image.shape[0])):
            seg_pred, acc_pred, seg_gt, acc_gt = (
                map_segmentation_to_colors(m[k].astype(np.uint8), cmap)
                for m, cmap in zip(maps, (dataset, "binary", dataset, "binary")))
            top = np.concatenate([image[k].astype(np.float32) / 255.0,
                                  seg_pred, acc_pred], axis=1)
            bottom = np.concatenate([np.zeros_like(seg_gt), seg_gt, acc_gt],
                                    axis=1)
            writer.add_image(f"{name}/accuracy_predictions_{k}",
                             np.transpose(np.concatenate([top, bottom], axis=0),
                                          (2, 0, 1)), global_step)

    @staticmethod
    def visualize_images_to_folder(output_folder, batch_idx, image, target,
                                   output, dataset):
        """One PNG triple per sample (the JAX package's summaries.py:123-141,
        reference summaries.py:60-67): ``img_``, ``tgt_`` and
        ``prd_{batch_idx:04d}_{i:02d}.png`` in ``output_folder``, byte-equal
        to the JAX package's for the same pixels. image (B,H,W,3) uint8;
        target and output (B,H,W) class maps."""
        os.makedirs(output_folder, exist_ok=True)
        image, target, output = _host(image), _host(target), _host(output)
        outpath = os.path.join(output_folder, "{0}_{1:04d}_{2:02d}.png")
        for i in range(image.shape[0]):
            # the JAX package's arithmetic: /255 in f32, then *255 truncated
            rgb = (image[i].astype(np.float32) / 255.0 * 255).astype(np.uint8)
            Image.fromarray(rgb).save(outpath.format("img", batch_idx, i))
            for prefix, plane in (("tgt", target[i]), ("prd", output[i])):
                colored = map_segmentation_to_colors(plane.astype(np.uint8), dataset)
                Image.fromarray((colored * 255).astype(np.uint8)).save(
                    outpath.format(prefix, batch_idx, i))
