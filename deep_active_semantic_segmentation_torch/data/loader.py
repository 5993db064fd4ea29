"""Train/eval and pool-scoring batches and the ordered host->device
prefetch (own copy of the JAX package's data/loader.py ``Loader``,
``PathsLoader`` and ``prefetch_to_device``).

Batches keep the JAX package's uint8 wire: NHWC uint8 images (geometry
only on the host; the steps and scoring kernels normalize on the device)
and either the uint8 label plane or, with ``labels_as_mask``, the 1-bit
valid predicate packed 8 pixels per byte. A final partial batch is padded
to the full batch size with duplicates whose pixels are all invalid, and
``nvalid`` counts the real samples.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from deep_active_semantic_segmentation_torch.data import transforms as tr


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``; to a card through pinned memory
    with a non-blocking copy (the pinned block is held until the copy is
    done by PyTorch's caching host allocator)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Loader:
    """Iterates a pool's ``get_item`` as fixed-shape NHWC uint8 batches
    (the JAX package's ``Loader``, reference DataLoader usage).

    ``shuffle`` draws each epoch's order from ``np.random.RandomState(seed)``,
    one stream for the loader's life: the AL loop keeps one train loader
    for the whole run, so the order carries on from round to round. Final
    partial batches are padded with 255-labelled duplicates of their
    first sample. Iterating yields host batches; ``device_batches`` puts
    them on ``device``.

    ``rank`` / ``world`` (a data-parallel run, ``parallel/mesh.py``):
    ``batch_size`` is the global batch, and rank r yields rows [r * per,
    (r + 1) * per) of each global batch the one-rank Loader yields, byte
    for byte, with ``nvalid`` its valid rows among them. The epoch order
    is the same; the other rows' transform draws are taken from the
    pool's host stream without decoding them (``pool.skip_item``), so the
    stream stays where the one-rank Loader leaves it."""

    def __init__(self, pool, batch_size: int, shuffle: bool = False,
                 seed: Optional[int] = None, device="cpu", rank: int = 0,
                 world: int = 1):
        from deep_active_semantic_segmentation_torch.parallel.mesh import (
            process_batch_slice)

        self.pool = pool
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.device = torch.device(device)
        self._rng = np.random.RandomState(seed if seed is not None else 0)
        self.rank, self.world = rank, world
        self.rows = process_batch_slice(batch_size, rank, world)

    def __len__(self):
        return (len(self.pool) + self.batch_size - 1) // self.batch_size

    def _samples(self, idx):
        """(this rank's samples of the global batch ``idx``, padded to its
        rows; its valid count)."""
        start, per = self.rows
        samples, first_draws = [], None
        for j, i in enumerate(idx):
            if start <= j < start + per:
                samples.append(self.pool.get_item(int(i)))
            elif j == 0:
                first_draws = self.pool.skip_item(int(i))
            else:
                self.pool.skip_item(int(i))
        nvalid = len(samples)
        if nvalid < per:
            # pad rows duplicate the global batch's first sample; a rank
            # that skipped it decodes it with its draws replayed
            first = (samples[0] if start == 0
                     else self.pool.get_item(int(idx[0]), first_draws))
            pad = dict(first)
            pad["label"] = np.full_like(first["label"], 255)
            samples += [pad] * (per - nvalid)
        return samples, nvalid

    def __iter__(self) -> Iterator[dict]:
        n = len(self.pool)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            samples, nvalid = self._samples(order[start: start + self.batch_size])
            image = np.stack([np.asarray(s["image"], np.uint8) for s in samples])
            label = np.stack([np.asarray(s["label"], np.uint8) for s in samples])
            yield {"image": image, "label": label, "nvalid": nvalid}

    def device_batches(self) -> Iterator[dict]:
        """One epoch with ``image`` and ``label`` on ``device``. One
        producer thread runs the host geometry and starts each copy while
        the consumer steps on the previous batch; one, so the transforms'
        draws from the pool's ``random.Random`` keep their order."""
        device = self.device

        def put(batch):
            return {"image": to_device(batch["image"], device),
                    "label": to_device(batch["label"], device),
                    "nvalid": batch["nvalid"]}

        return prefetch_to_device(iter(self), put, depth=2, workers=1)


class PathsLoader:
    """Pool-scoring loader (reference dataloaders/dataset/paths_dataset.py).

    Deterministic order over an explicit path list with the eval geometry;
    ``include_labels`` toggles image+label batches vs image-only. The
    hardcoded base_size=512 for crop_size == -1 matches paths_dataset.py:16.
    """

    def __init__(self, store, paths, crop_size: int, batch_size: int,
                 include_labels: bool = False,
                 labels_as_mask: Optional[int] = None):
        self.store = store
        self.paths = list(paths)
        self.batch_size = batch_size
        self.include_labels = include_labels
        # labels_as_mask = num_classes: ship (label < num_classes) packed
        # 8 pixels/byte instead of the label plane; exact for consumers
        # that read labels only through ops/entropy.valid_mask. The
        # 'label' entry becomes (B, H, ceil(W/8)) uint8.
        self.labels_as_mask = labels_as_mask
        if labels_as_mask is not None and not include_labels:
            raise ValueError("labels_as_mask requires include_labels")
        self.crop_size = crop_size
        self.base_size = 512
        if crop_size == -1:
            self._scalecrop = tr.ScaleWithPadding(base_size=self.base_size)
            self._scalecrop_image = tr.ScaleWithPaddingImageOnly(base_size=self.base_size)
        else:
            self._scalecrop = tr.FixScaleCrop(crop_size=crop_size)
            self._scalecrop_image = tr.FixScaleCropImageOnly(crop_size=crop_size)

    def __len__(self):
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    def _get(self, path: bytes):
        rec = np.asarray(self.store.get(path))
        if self.include_labels:
            return self._scalecrop({"image": rec[:, :, 0:3],
                                    "label": rec[:, :, 3]})
        return self._scalecrop_image(rec[:, :, 0:3])

    def iter_chunks(self) -> Iterator[list]:
        """Path chunks in batch order: the cheap half of iteration, so
        ``build_batch`` (store reads + geometry) runs in prefetch workers."""
        for start in range(0, len(self.paths), self.batch_size):
            yield self.paths[start: start + self.batch_size]

    def build_batch(self, chunk) -> dict:
        """Store reads + geometry + uint8 wire packing for one path chunk."""
        samples = [self._get(p) for p in chunk]
        nvalid = len(samples)
        while len(samples) < self.batch_size:
            samples.append(samples[0])
        if not self.include_labels:
            image = np.stack(samples).astype(np.uint8)
            return {"image": image, "nvalid": nvalid, "paths": chunk}
        image = np.stack([s["image"] for s in samples]).astype(np.uint8)
        label = np.stack([s["label"] for s in samples]).astype(np.uint8)
        if nvalid < self.batch_size:
            label[nvalid:] = 255
        if self.labels_as_mask is not None:
            # trailing packbits padding is zero bits -> invalid, matching
            # the 255-padded duplicates above
            label = np.packbits(label.astype(np.int32) < self.labels_as_mask,
                                axis=-1)
        return {"image": image, "label": label, "nvalid": nvalid,
                "paths": chunk}

    def __iter__(self) -> Iterator[dict]:
        for chunk in self.iter_chunks():
            yield self.build_batch(chunk)


def prefetch_to_device(iterator, device_put_fn, depth: int = 2,
                       workers: int = 1):
    """Host->device pipeline: producer threads apply ``device_put_fn``
    (host geometry plus a pinned-memory, non-blocking copy to the card)
    ahead of the consumer, overlapping host work and transfer with device
    compute.

    workers > 1 runs an ORDERED multi-worker pipeline: items are handed to
    worker threads and yielded strictly in input order (selection scores
    are matched to paths by position). PIL's resize releases the GIL, so
    the geometry of several batches proceeds in parallel.
    """
    sentinel = object()
    err = []

    if workers <= 1:
        q: "queue.Queue" = queue.Queue(maxsize=depth)

        def producer():
            try:
                for item in iterator:
                    q.put(device_put_fn(item))
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item

    in_q: "queue.Queue" = queue.Queue(maxsize=depth + workers)
    results = {}
    cond = threading.Condition()
    done = [0]  # number of workers finished

    def feeder():
        try:
            for seq, item in enumerate(iterator):
                in_q.put((seq, item))
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            for _ in range(workers):
                in_q.put(sentinel)

    def worker():
        while True:
            task = in_q.get()
            if task is sentinel:
                break
            seq, item = task
            try:
                out = device_put_fn(item)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
                break
            with cond:
                results[seq] = out
                cond.notify_all()
        with cond:
            done[0] += 1
            cond.notify_all()

    threading.Thread(target=feeder, daemon=True).start()
    for _ in range(workers):
        threading.Thread(target=worker, daemon=True).start()

    seq = 0
    while True:
        with cond:
            while seq not in results and done[0] < workers and not err:
                cond.wait()
            if err:
                raise err[0]
            if seq in results:
                item = results.pop(seq)
            else:  # all workers done and no next item -> exhausted
                return
        yield item
        seq += 1
