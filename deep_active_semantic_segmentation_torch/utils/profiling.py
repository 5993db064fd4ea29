"""Throughput counters and profiler traces (the counterparts of the JAX
package's utils/profiling.py:24-75).

* ``Throughput``: an items/s counter whose ``mark`` waits
  for the work it counts: a CUDA tensor handed to it is synchronized on
  (PyTorch returns before the card has finished), so the clock reads
  completion, not enqueue.
* ``trace``: a context manager around ``torch.profiler.profile`` with CPU
  and, where there is a card, CUDA activities; the trace is written to
  ``log_dir`` as ``<worker>.<time>.pt.trace.json``, which TensorBoard's
  profiler plugin and Chrome's trace viewer read. A falsy ``log_dir``
  makes it a no-op.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


class Throughput:
    def __init__(self):
        self.reset()

    def reset(self):
        self._count = 0
        self._start = None
        self._elapsed = 0.0

    def start(self):
        self._start = time.perf_counter()

    def mark(self, num_items: int, result=None):
        """Record ``num_items`` processed, after waiting for ``result`` (a
        tensor the work produced) to be complete. The first mark of an
        unstarted counter only starts the clock, as in the JAX package."""
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        if self._start is None:
            self.start()
            return
        self._count += num_items
        self._elapsed = time.perf_counter() - self._start

    @property
    def items_per_sec(self) -> float:
        return self._count / self._elapsed if self._elapsed else 0.0

    def summary(self, unit: str = "imgs") -> str:
        return f"{self.items_per_sec:.2f} {unit}/s"


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the ``with`` block into ``log_dir`` (CPU ops and, where
    there is a card, its kernels); a no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
