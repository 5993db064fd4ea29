"""Ranks, their devices and their process group (parity: the JAX package's
parallel/mesh.py, whose 1-D ``data`` mesh shards the global batch over
the devices and replicates the parameters).

A ``Mesh`` is this process's place in a data-parallel run: its ``rank``,
the ``world`` size, the ``device`` it computes on and the
``torch.distributed`` process ``group`` the ranks talk over. One rank
with no process group is the one-card path, unchanged: every collective
below is then the identity.

``launch(fn, args, num_devices, ...)`` runs ``fn(mesh, *args)`` on every
rank. Under ``torchrun`` the process is one rank already (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``); otherwise ``num_devices`` > 1 spawns
that many ranks (``torch.multiprocessing``, start method ``spawn``) that
meet through a file under a temporary directory, never a fixed port.
``num_devices=None`` takes every visible card, as the JAX package's
``make_mesh(None)`` takes every device. Each rank computes on its own
card over NCCL; the CPU and ranks that share one card (``device`` with
an index, e.g. ``cuda:0``) talk over gloo, which the caller names. A
failed process-group init raises, and a rank that raises ends the whole
run with the others terminated: nothing falls back to one rank or to
the CPU.

Collectives gloo cannot run on CUDA tensors (all_gather) are written as
all-reduces of zero-padded buffers (``gather_rows``), so one code path
serves both backends.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from deep_active_semantic_segmentation_torch import resolve_device

# the process group's timeout: a collective that waits longer than this
# for a rank that died raises instead of waiting for ever
DEFAULT_TIMEOUT_S = 1800.0


@dataclass
class Mesh:
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[Any] = None
    rendezvous_dir: Optional[str] = field(default=None, repr=False)

    @property
    def distributed(self) -> bool:
        """Whether the ranks run in a process group (world 1 included)."""
        return self.group is not None

    @property
    def main(self) -> bool:
        """Rank 0: the one rank that writes files."""
        return self.rank == 0

    def _nccl(self) -> bool:
        return dist.get_backend(self.group) == "nccl"

    def barrier(self) -> None:
        """Every rank reaches this point before any leaves it (host
        synchronous, so files rank 0 wrote before it are there after)."""
        if not self.distributed:
            return
        if self._nccl():
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def all_reduce(self, tensor: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``tensor`` reduced over the ranks, in place (returned). NCCL
        reduces on the mesh's card: a host tensor goes there and back."""
        if not self.distributed:
            return tensor
        if self._nccl() and tensor.device != self.device:
            on_card = tensor.to(self.device)
            dist.all_reduce(on_card, op=op, group=self.group)
            return tensor.copy_(on_card)
        dist.all_reduce(tensor, op=op, group=self.group)
        return tensor

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=self.device if self._nccl() else None)
        return box[0]

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj`` (picklable, small), in rank order, on
        every rank."""
        if not self.distributed:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def assert_same(self, obj, what: str) -> None:
        """Raise on every rank unless every rank holds an equal ``obj``."""
        objs = self.gather_objects(obj)
        if any(o != objs[0] for o in objs[1:]):
            raise RuntimeError(f"the ranks disagree on {what}")

    def gather_rows(self, parts: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The concatenation, in index order, of every rank's ``parts``
        ({piece index: rows}; each piece lives on exactly one rank, and
        the pieces of all ranks together are numbered 0, 1, ...) on every
        rank, on the mesh's device. An all-reduce of a zero buffer each
        rank wrote its pieces into, so the rows arrive exactly (x + 0 = x);
        the pieces' shapes and dtype cross first, as objects."""
        if not self.distributed:
            return torch.cat([parts[i] for i in sorted(parts)])
        shapes = {}
        for info in self.gather_objects(
                {i: (tuple(t.shape), str(t.dtype)) for i, t in parts.items()}):
            shapes.update(info)
        first, dtype = shapes[0]
        offsets = np.cumsum([0] + [shapes[i][0][0] for i in range(len(shapes))])
        full = torch.zeros((int(offsets[-1]),) + first[1:],
                           dtype=getattr(torch, dtype.split(".")[-1]),
                           device=self.device)
        for i, rows in parts.items():
            full[offsets[i]:offsets[i + 1]] = rows
        return self.all_reduce(full)

    def close(self) -> None:
        if self.distributed:
            dist.destroy_process_group(self.group)
            self.group = None
        if self.rendezvous_dir is not None:
            shutil.rmtree(self.rendezvous_dir, ignore_errors=True)
            self.rendezvous_dir = None


def process_batch_slice(global_batch_size: int, rank: int, world: int):
    """(start, size) of ``rank``'s contiguous rows of a global batch (the
    JAX package's mesh.py:62-67). The batch must divide evenly: the pools
    pad to batch multiples, so a remainder is a misconfiguration, not
    rows to drop."""
    if global_batch_size % world:
        raise ValueError(f"the global batch of {global_batch_size} does not "
                         f"divide over {world} ranks")
    per = global_batch_size // world
    return rank * per, per


def _torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def rank_device(device, local_rank: int, world: int) -> torch.device:
    """The device of ``local_rank``: ``device`` when it names a CPU or an
    indexed card (every rank shares it), else card ``local_rank``; raises
    when fewer cards are visible than ranks need."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    visible = torch.cuda.device_count()
    if world > visible:
        raise RuntimeError(f"{world} ranks need {world} CUDA cards; "
                           f"{visible} visible")
    return torch.device("cuda", local_rank)


def make_mesh(num_devices: Optional[int] = None, device=None,
              backend: Optional[str] = None, init_method: Optional[str] = None,
              timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This process's rank of the run. Under ``torchrun`` (or as a rank
    ``launch`` spawned) it reads ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
    and joins the process group; otherwise it is the only rank, with a
    process group only when ``backend`` is named (a one-rank group, to
    run the distributed route on one card). ``backend``: None is NCCL on
    cards and gloo on the CPU."""
    if _torchrun():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        rank, world, local = 0, 1, 0
    if num_devices is not None and num_devices != world:
        raise ValueError(f"{num_devices} devices asked for in a run of "
                         f"{world} ranks: more than one rank is started by "
                         "parallel.mesh.launch or torchrun")
    dev = rank_device(device, local, world)
    if world == 1 and backend is None:
        return Mesh(0, 1, dev, None)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    shared = device is not None and torch.device(device).index is not None
    if backend == "nccl" and (dev.type != "cuda" or (world > 1 and shared)):
        raise ValueError("NCCL runs one rank on each card: ranks on the CPU "
                         "or sharing one card need backend='gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rendezvous_dir = None
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    elif init_method is None:   # this process alone: a file of its own
        rendezvous_dir = tempfile.mkdtemp(prefix="dass_mesh_")
        init_method = "file://" + os.path.join(rendezvous_dir, "rendezvous")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout))
    return Mesh(rank, world, dev, dist.group.WORLD, rendezvous_dir)


def _rank_main(local_rank: int, world: int, init_method: str, fn: Callable,
               args: tuple, device, backend, timeout: float,
               threads: int) -> None:
    """A spawned rank: torchrun's environment, the mesh, ``fn``. Ranks
    other than 0 print nothing; CPU ranks share the parent's intra-op
    threads."""
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank))
    if local_rank:
        sys.stdout = open(os.devnull, "w")
    mesh = make_mesh(world, device, backend, init_method, timeout)
    if mesh.device.type == "cpu":
        torch.set_num_threads(threads)
    try:
        fn(mesh, *args)
    finally:
        mesh.close()


def launch(fn: Callable, args: tuple = (), num_devices: Optional[int] = None,
           device=None, backend: Optional[str] = None,
           timeout: float = DEFAULT_TIMEOUT_S,
           join_timeout: Optional[float] = None):
    """Run ``fn(mesh, *args)`` on every rank of the run and return its
    result when this process is the only rank or a ``torchrun`` rank;
    after spawning ``num_devices`` > 1 ranks, return None (rank 0's files
    are the result). A rank that raises ends the run: the others are
    terminated and the error is raised here. ``join_timeout``: seconds
    to wait for the spawned ranks before killing them and raising
    ``TimeoutError``; ``timeout`` is each process group's."""
    import torch.multiprocessing as mp

    if not _torchrun():
        n = num_devices
        if n is None:   # every visible card; one rank on the CPU or a named card
            dev = resolve_device(device)
            n = (torch.cuda.device_count() if dev.type == "cuda" and dev.index is None
                 else 1)
        if n < 1:
            raise ValueError(f"num_devices {n}")
        if n > 1:
            rank_device(device, n - 1, n)   # too few cards raise here
            with tempfile.TemporaryDirectory(prefix="dass_mesh_") as tmp:
                init = "file://" + os.path.join(tmp, "rendezvous")
                ctx = mp.start_processes(
                    _rank_main, args=(n, init, fn, args, device, backend, timeout,
                                      max(1, torch.get_num_threads() // n)),
                    nprocs=n, join=False, start_method="spawn")
                deadline = (None if join_timeout is None
                            else time.monotonic() + join_timeout)
                while not ctx.join(timeout=1.0):
                    if deadline is not None and time.monotonic() > deadline:
                        for p in ctx.processes:
                            p.kill()
                        raise TimeoutError(f"{n} ranks did not finish in "
                                           f"{join_timeout} s")
            return None
        num_devices = 1
    mesh = make_mesh(num_devices, device, backend, timeout=timeout)
    try:
        return fn(mesh, *args)
    finally:
        mesh.close()
