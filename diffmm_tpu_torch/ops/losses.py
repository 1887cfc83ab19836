"""Differentiable loss ops shared by the trainer and the models.

Counterpart of ``diffmm_tpu/ops/losses.py`` (reference `Utils/Utils.py:45-98`):
``bpr_loss``, ``info_nce`` and ``l2_reg_loss``, plus :func:`l2_normalize`.
``info_nce`` gathers its rows through :func:`~diffmm_tpu_torch.ops.gather.gather`,
whose backward is K4 (no atomics), as the JAX ``take`` is deterministic.

On the data axis of a mesh each rank computes its own rows of the one
global loss (a :class:`RowSlice`): BPR and InfoNCE are means over the whole
block, so a rank's part is its rows' sum over the block's row count, and
the ranks' parts add up to the single-device loss. InfoNCE's in-batch
negatives span the whole block: the views are the same on every rank, so a
rank gathers every row of the second view and computes its own rows of the
(B, B) logits, with no collective.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple

import torch

from diffmm_tpu_torch.ops.gather import GatherPlan, gather, gather_plan


class RowSlice(NamedTuple):
    """A rank's rows ``[lo, hi)`` of a block of ``total`` rows, with the
    :class:`~diffmm_tpu_torch.ops.gather.GatherPlan` of those rows'
    indices."""

    lo: int
    hi: int
    total: int
    plan: GatherPlan


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization, ``x / max(||x||, eps)`` (as
    `torch.nn.functional.normalize`, p=2)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(norm, eps)


def bpr_loss(user_emb: torch.Tensor, pos_emb: torch.Tensor, neg_emb: torch.Tensor,
             total: int | None = None) -> torch.Tensor:
    """Bayesian Personalized Ranking loss (reference `Utils/Utils.py:78-98`):
    ``-mean(log(1e-5 + sigmoid(<u,p> - <u,n>)))`` (the reference's ``10e-6``
    literal equals 1e-5). With ``total``, the rows are a rank's part of a
    block of ``total`` rows: their sum over ``total``."""
    pos_score = torch.sum(user_emb * pos_emb, dim=1)
    neg_score = torch.sum(user_emb * neg_emb, dim=1)
    terms = torch.log(1e-5 + torch.sigmoid(pos_score - neg_score))
    return -torch.mean(terms) if total is None else -torch.sum(terms) / total


def info_nce(
    view1: torch.Tensor, view2: torch.Tensor, idx: torch.Tensor, temperature: float,
    plan: GatherPlan | None = None,
    own: RowSlice | None = None,
) -> torch.Tensor:
    """In-batch InfoNCE (reference `Utils/Utils.py:57-75`): gather ``idx``
    rows of both full views, L2-normalise, and return ``-mean(diag(
    log_softmax(v1 v2ᵀ / temperature)))``. Duplicate indices are kept: they
    act as extra in-batch negatives, as in the reference. ``plan`` is
    ``gather_plan(idx, n)`` over the views' n rows (made here if not
    given); both gathers share it.

    ``own``: a rank's rows of the block. Its rows of the first view meet
    every row of the second (the in-batch negatives of the whole block),
    and its part of the loss is the sum of its rows' diagonal terms over
    the block's row count."""
    if plan is None:
        plan = gather_plan(idx, view1.shape[0])
    if own is None:
        v1 = l2_normalize(gather(view1, idx, plan), dim=1)
        v2 = l2_normalize(gather(view2, idx, plan), dim=1)
        log_probs = torch.log_softmax((v1 @ v2.T) / temperature, dim=1)
        return -torch.mean(torch.diagonal(log_probs))
    v1 = l2_normalize(gather(view1, idx[own.lo:own.hi], own.plan), dim=1)
    v2 = l2_normalize(gather(view2, idx, plan), dim=1)
    log_probs = torch.log_softmax((v1 @ v2.T) / temperature, dim=1)
    return -torch.sum(torch.diagonal(log_probs, offset=own.lo)) / own.total


def l2_reg_loss(reg: float, embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
    """``reg * sum_i ||E_i||_F^2`` (reference `Utils/Utils.py:45-54`)."""
    return sum(torch.sum(torch.square(emb)) for emb in embeddings) * reg
