"""Row gathers whose backward is K4.

Counterpart of ``jnp.take(table, idx, axis=0)`` under ``jax.grad`` where
the JAX package gathers rows of a table that trains: the BPR rows of the
joint step (``diffmm_tpu/train/steps.py:436-438``) and the two views of
``info_nce`` (``diffmm_tpu/ops/losses.py:49-50``). Autograd through
``index_select`` would scatter the cotangent with atomic adds on the card,
in an order that changes from run to run; here the backward is a sorted
segment sum instead:

* :func:`gather_plan` sorts the indices once (a stable ``torch.sort``) and
  keeps the permutation (int32, as K4 takes its indices) and the CSR
  offsets of the sorted indices over the table's n rows. Every gather by
  the same index vector shares one plan.
* :class:`Gather`'s forward is ``table.index_select(0, idx)``; its backward
  is one launch of the gather-fused ``segsum_gather`` (K4): each table
  row's segment sums the cotangent's rows that the permutation names, into
  the whole (n, d) cotangent. Rows no index names get zeros; a duplicate
  index sums its rows in the order the stable sort gives them.

No scatter and no atomics, so the card's gradient repeats bit for bit. On
the CPU the backward runs the plain version, as every K4 call does there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from diffmm_tpu_torch.ops.kernels.segsum import segment_offsets, segsum_gather


class GatherPlan(NamedTuple):
    """The backward's order for one index vector over a table of n rows.

    Attributes:
      perm: (B,) int32 stable argsort of the indices (made once a plan).
      offsets: (n + 1,) int64 CSR offsets of the sorted indices.
    """

    perm: torch.Tensor
    offsets: torch.Tensor


def gather_plan(idx: torch.Tensor, n: int) -> GatherPlan:
    """The :class:`GatherPlan` of ``idx`` (values in ``[0, n)``) over n rows."""
    sorted_idx, perm = torch.sort(idx, stable=True)
    return GatherPlan(perm.to(torch.int32), segment_offsets(sorted_idx, n))


class Gather(torch.autograd.Function):
    """``Gather.apply(table, idx, perm, offsets)`` -> ``table[idx]``; the
    backward is one K4 launch over the plan (``perm``, ``offsets``) of
    ``idx``. The indices and the plan get no gradient."""

    @staticmethod
    def forward(ctx, table, idx, perm, offsets):
        ctx.save_for_backward(perm, offsets)
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        perm, offsets = ctx.saved_tensors
        return segsum_gather(g, perm, offsets), None, None, None


def gather(table: torch.Tensor, idx: torch.Tensor, plan: GatherPlan | None = None) -> torch.Tensor:
    """``table[idx]`` (rows), differentiable in ``table`` through K4. ``plan``
    is ``gather_plan(idx, table.shape[0])``, made here when not given."""
    if plan is None:
        plan = gather_plan(idx, table.shape[0])
    elif plan.offsets.shape[0] != table.shape[0] + 1:
        raise ValueError(
            f"gather: the plan covers {plan.offsets.shape[0] - 1} rows, the table has {table.shape[0]}"
        )
    return Gather.apply(table, idx, plan.perm, plan.offsets)
