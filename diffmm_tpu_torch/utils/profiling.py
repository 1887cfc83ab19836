"""Per-phase wall-clock accounting of the training epoch.

Counterpart of ``diffmm_tpu/utils/profiling.py`` :class:`PhaseTimer`, with
its phase names (``neg_sampling``, ``diffusion``, ``rebuild``, ``joint``,
``eval``). PyTorch returns before the card finishes, so a phase timed on
the host clock alone measures what was enqueued; ``fence`` waits for the
card (``torch.cuda.synchronize``) before the phase's clock stops, making
each phase's time its own at the cost of the overlap between phases. The
JAX package's trace context (``jax.profiler``) has no counterpart here;
``chip_smoke.py`` traces with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
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
