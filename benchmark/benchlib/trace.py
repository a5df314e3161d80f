"""The device trace of a traced run, and its reduction.

``torch.profiler`` with CUDA activity only (no CPU op recording, so the
host path keeps its speed but for CUPTI's launch callbacks) over a slice
at the start of the window.  Its device events are kept in memory as
``(name, start_ns, duration_ns)`` on the wall clock, which the profiler
uses for device timestamps; host spans are on ``perf_counter_ns``, so the
slice keeps the offset between the two clocks read back to back at its
start.
"""

from __future__ import annotations

import re
import time

import torch

from .window import synchronize


class Tracer:
    """Profiles one slice of the window: at most ``max_steps`` steps or
    ``max_seconds`` of host clock."""

    def __init__(self, device, max_steps=200, max_seconds=2.0):
        self.device = device
        self.max_steps = max_steps
        self.max_seconds = max_seconds
        self.kernels = []
        self.window_ns = None
        self.wall_minus_perf_ns = 0
        self._prof = None

    def _profile(self):
        """The profiler; on the CPU (tests) a stand-in that records no
        device activity, since there is no device."""
        if self.device.type != "cuda":
            return _NoProfile()
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def warm(self, fn):
        """Run ``fn`` under a throwaway profiler: the first start of CUPTI
        is slow, and belongs to set-up."""
        with self._profile():
            fn()
            synchronize(self.device)

    def start(self):
        synchronize(self.device)
        self._prof = self._profile()
        self._prof.start()
        self.wall_minus_perf_ns = time.time_ns() - time.perf_counter_ns()
        self._t0 = time.time_ns()

    def stop(self):
        synchronize(self.device)
        t1 = time.time_ns()
        self._prof.stop()
        self.window_ns = (self._t0, t1)
        self.kernels = device_events(self._prof)
        self._prof = None


class _NoProfile:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def start(self):
        pass

    def stop(self):
        pass


def device_events(prof):
    """``[(name, start_ns, duration_ns)]`` of every device activity."""
    if isinstance(prof, _NoProfile):
        return []
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
    return out


def merged(intervals, lo, hi):
    """The union of ``(start, end)`` intervals clipped to [lo, hi], as
    sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_ns(kernels, lo, hi):
    """Nanoseconds of [lo, hi] in which some device activity ran."""
    return sum(e - s for s, e in merged(
        [(s, s + d) for _, s, d in kernels], lo, hi))


def idle_gaps(kernels, lo, hi):
    """The intervals of [lo, hi] in which no device activity ran."""
    gaps, t = [], lo
    for s, e in merged([(s, s + d) for _, s, d in kernels], lo, hi):
        if s > t:
            gaps.append((t, s))
        t = e
    if hi > t:
        gaps.append((t, hi))
    return gaps


def short_name(name, limit=160):
    """A kernel's name without ``void`` and its argument list."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    k = 0
    while k < len(name):
        c = name[k]
        if name.startswith("(anonymous namespace)", k):
            k += len("(anonymous namespace)")
            continue
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0 and k > 0:
            name = name[:k]
            break
        k += 1
    return name[:limit]


def kernel_pattern(kernel):
    """A regex that finds ``kernel`` (a function name) in a device event's
    name, and not a longer name that ends or starts with it."""
    return re.compile(rf"(^|[\s:]){re.escape(kernel)}(<|\(|$)")


def kernel_times_ns(kernels, kernel):
    """Durations of every launch of ``kernel``."""
    pattern = kernel_pattern(kernel)
    return [d for name, _, d in kernels if pattern.search(name)]


def top_ops(kernels, n=10):
    """``[[name, seconds], ...]``: the device ops that took most time."""
    acc = {}
    for name, _, d in kernels:
        key = short_name(name)
        acc[key] = acc.get(key, 0) + d
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in top]
