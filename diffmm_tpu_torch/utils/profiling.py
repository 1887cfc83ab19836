"""Per-phase wall-clock accounting of the training epoch, and traces.

Counterpart of ``diffmm_tpu/utils/profiling.py``:

* :class:`PhaseTimer`, with its phase names (``neg_sampling``,
  ``diffusion``, ``rebuild``, ``joint``, ``eval``, and ``fused`` for a
  chunk of epochs). PyTorch returns before the card finishes, so a phase
  timed on the host clock alone measures what was enqueued; ``fence`` waits
  for the card (``torch.cuda.synchronize``) before the phase's clock stops,
  making each phase's time its own at the cost of the overlap between
  phases. Each phase is also a named range in a trace (:func:`annotate`).
* :func:`trace` (``--trace-dir``): a ``torch.profiler`` session over the
  run, CPU and, where there is a card, CUDA activity, written as a Chrome
  trace (``trace.json``, viewed in Perfetto or ``chrome://tracing``) where
  the JAX package writes a ``jax.profiler`` trace for TensorBoard.
* :func:`annotate`: a named range in the trace
  (``torch.profiler.record_function``); outside a session it records
  nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates wall seconds per named phase across an epoch or a run."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, fence: torch.device | None = None):
        """Time the block as phase ``name``; with ``fence`` a CUDA device,
        wait for it before the clock stops."""
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            if fence is not None and fence.type == "cuda":
                torch.cuda.synchronize(fence)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        return ", ".join(
            f"{name}={self.totals[name]:.2f}s/{self.counts[name]}" for name in sorted(self.totals)
        )

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """A ``torch.profiler`` session written to ``<trace_dir>/trace.json``
    when the block ends; nothing when ``trace_dir`` is empty."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield
