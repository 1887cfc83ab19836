"""The traced window: a ``torch.profiler`` session reduced to what the
per-layer metrics read.

The profiler's raw events (``kineto_results``) are read once: the device's
activity (kernels, copies, sets) as intervals by name, and the host's
operations, which name each idle gap of the device by what the host was
doing as the gap began. Nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import defaultdict

import torch


class TraceSummary:
    """What one profiled window shows."""

    def __init__(self, window_s: float, device_events: list, host_events: list):
        self.window_s = window_s
        self.device = device_events  # (name, start_ns, end_ns)
        self.host = host_events  # (name, start_ns, end_ns)
        merged = []
        for _, s, e in sorted(device_events, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        self._merged = merged

    def kernel_s(self, *patterns: str) -> tuple[float, int]:
        """Device seconds and launch count of the activity whose name
        contains any of ``patterns``."""
        secs, n = 0.0, 0
        for name, s, e in self.device:
            if any(p in name for p in patterns):
                secs += (e - s) * 1e-9
                n += 1
        return secs, n

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, s, e in self.device:
            by[name[:120]] += (e - s) * 1e-9
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device activity, each named by the
        innermost host operation running as it began."""
        gaps = [(b[0] - a[1], a[1]) for a, b in zip(self._merged, self._merged[1:]) if b[0] > a[1]]
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, at in gaps[:n]:
            inner = None
            for name, s, e in self.host:
                if s <= at < e and (inner is None or e - s < inner[1]):
                    inner = (name, e - s)
            out.append([inner[0][:120] if inner else "host idle", length * 1e-9])
        return out


@contextlib.contextmanager
def profiled(device: torch.device, into: list):
    """Profile the block; append its :class:`TraceSummary` to ``into``
    (nothing on a device without CUDA activity to trace)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        yield
        into.append(TraceSummary(time.perf_counter() - t0, [], []))
        return
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "profiler clears events at the end of each cycle"
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        span = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():  # a named range drawn on the device's row is not work
                dev.append(span)
        elif ev.duration_ns() > 0:
            host.append(span)
    into.append(TraceSummary(window, dev, host))
