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
  makes it a no-op, unless ``record`` asks for the profile alone (nothing
  written). It yields the profile (None when off).
* ``op_table``: a profile's time per op name, worst first, per step: on
  the card the kernels' (and copies') device time, on the CPU the ops'
  self time (the per-op table of ``tools/trace_step_torch.py``; the JAX
  package's ``tools/trace_step.py`` reads XLA ops off the xplane).
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
def trace(log_dir: Optional[str], record: bool = False):
    """Profile the ``with`` block into ``log_dir`` (CPU ops and, where
    there is a card, its kernels) and yield the profile; a no-op yielding
    None when ``log_dir`` is falsy, unless ``record`` (profile, write
    nothing)."""
    if not log_dir and not record:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir) if log_dir else None
                 ) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def op_table(prof, steps: int, device_type: str = "cuda",
             top: Optional[int] = 25) -> dict:
    """``{'total_ms', 'names', 'ops': [{'name', 'ms', 'launches'}]}`` of a
    profile of ``steps`` steps, all per step, ``top`` ops by time (None:
    every op): for ``device_type`` 'cuda' every kernel, copy and set on
    the card (their device time), for 'cpu' every op's self time on the
    host (the CPU is the device there). ``total_ms`` sums every name, not
    only the top."""
    rows = []
    for e in prof.key_averages():
        # a user annotation (``record_function``, such as the optimizer's
        # step) spans ops that have rows of their own
        if (e.device_type.name != device_type.upper()
                or getattr(e, "is_user_annotation", False)):
            continue
        if device_type == "cpu":
            us = e.self_cpu_time_total
        else:   # a kernel has no children: its total is its self time
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(key=lambda r: -r[0])
    return {"total_ms": sum(r[0] for r in rows) / 1e3 / steps, "names": len(rows),
            "ops": [{"name": name, "ms": us / 1e3 / steps, "launches": n / steps}
                    for us, name, n in rows[:top]]}
