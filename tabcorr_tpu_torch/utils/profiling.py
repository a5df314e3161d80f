"""Timing and device-trace hooks.

Port of ``tabcorr_tpu/utils/profiling.py``: wall-clock phase timers
(collected, not just printed) and a context manager around
``torch.profiler`` that writes a Chrome trace (open it in Perfetto or
``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from pathlib import Path

import torch

from .device import resolve_device

logger = logging.getLogger("tabcorr_tpu_torch")


class Timer:
    """Collects named wall-clock phase timings.

    >>> timer = Timer()
    >>> with timer("pair counting"):
    ...     do_work()
    >>> timer.summary()

    Work queued on a CUDA device is timed only as far as the host waits
    for it: end a timed block with ``torch.cuda.synchronize()`` to time
    the device's work.
    """

    def __init__(self):
        self.records: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def __call__(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.records.append((name, elapsed))
            logger.debug("%s: %.3f s", name, elapsed)

    def total(self, name=None):
        return sum(t for n, t in self.records
                   if name is None or n == name)

    def summary(self):
        lines = [f"  {name}: {elapsed:.3f} s"
                 for name, elapsed in self.records]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir, *, device="cuda"):
    """Profile a code block with ``torch.profiler`` and write its Chrome
    trace into ``log_dir`` (created if missing).

    Records CPU activity, and on a CUDA ``device`` (the default; 'cpu'
    for a run on the CPU) the card's kernels too, synchronising the
    device before the trace ends.  Yields the ``torch.profiler.profile``
    object (``key_averages()`` sums time by operator and kernel); the
    trace's path is its ``trace_path`` attribute after the block.
    """
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    prof.trace_path = log_dir / (
        f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(str(prof.trace_path))
