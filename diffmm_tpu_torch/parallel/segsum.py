"""K4's mesh forms: a segment sum over one rank's edge slice, then a sum
over the ranks.

Counterpart of ``sharded_sorted_segment_sum`` (``diffmm_tpu/ops/pallas/
segsum.py:455``) and ``sharded_ranked_segment_sum`` (``segsum.py:708``).
There each shard reduces its slice of the sorted edges into a local buffer
placed at its first segment (or rank) and a ``psum`` merges the partials.
The port holds CSR offsets per direction in place of the JAX ranks
(``ops/kernels/segsum.py``), which makes both forms one call: the slice's
offsets are ``offsets.clamp(lo, hi) - lo`` over all n segments, so a
segment outside the slice is empty and gives a zero row, and one
``segsum_gather`` launch over ``src[lo:hi]`` sums the slice straight into
the (n, M·d) frame, which ``AllReduceSum`` adds over the ranks. No span
buffer and no placement: the frame is the output.

A segment cut by a slice boundary is summed in two parts and added by the
all-reduce; everything else is summed as the whole call sums it. At one
rank the clamp changes nothing and the call is bitwise the unsharded one.
The tolerance against the whole sum is K4's own rule (``chip_smoke.py``
``TOL``): ``|a - b| <= 1e-6 * sum|terms| + 1e-6``.
"""

from __future__ import annotations

import torch

from diffmm_tpu_torch.ops.kernels.segsum import segsum_gather
from diffmm_tpu_torch.parallel.collectives import AllReduceSum


def local_offsets(offsets: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The CSR offsets of the edge slice ``[lo, hi)`` over all n segments."""
    return offsets.clamp(lo, hi) - lo


def slice_segsum_gather(table: torch.Tensor, src, offsets: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """This rank's partial: ``segsum_gather`` over the edges ``[lo, hi)``
    only (``src`` one index tensor or a sequence, as ``segsum_gather``
    takes them); one K4 launch."""
    src = src[lo:hi] if isinstance(src, torch.Tensor) else [s[lo:hi] for s in src]
    return segsum_gather(table, src, local_offsets(offsets, lo, hi))


def sharded_segsum_gather(table: torch.Tensor, src, offsets: torch.Tensor, lo: int, hi: int,
                          group) -> torch.Tensor:
    """The whole ``segsum_gather`` when the ranks of ``group`` pass slices
    that cover the edges once: :func:`slice_segsum_gather`, then
    :class:`~diffmm_tpu_torch.parallel.collectives.AllReduceSum`."""
    return AllReduceSum.apply(slice_segsum_gather(table, src, offsets, lo, hi), group)
