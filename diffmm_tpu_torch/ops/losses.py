"""Differentiable loss ops shared by the trainer and the models.

Counterpart of ``diffmm_tpu/ops/losses.py`` (reference `Utils/Utils.py:45-98`):
``bpr_loss``, ``info_nce`` and ``l2_reg_loss``, plus :func:`l2_normalize`.
``info_nce`` gathers its rows through :func:`~diffmm_tpu_torch.ops.gather.gather`,
whose backward is K4 (no atomics), as the JAX ``take`` is deterministic.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from diffmm_tpu_torch.ops.gather import GatherPlan, gather, gather_plan


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization, ``x / max(||x||, eps)`` (as
    `torch.nn.functional.normalize`, p=2)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(norm, eps)


def bpr_loss(user_emb: torch.Tensor, pos_emb: torch.Tensor, neg_emb: torch.Tensor) -> torch.Tensor:
    """Bayesian Personalized Ranking loss (reference `Utils/Utils.py:78-98`):
    ``-mean(log(1e-5 + sigmoid(<u,p> - <u,n>)))`` (the reference's ``10e-6``
    literal equals 1e-5)."""
    pos_score = torch.sum(user_emb * pos_emb, dim=1)
    neg_score = torch.sum(user_emb * neg_emb, dim=1)
    return -torch.mean(torch.log(1e-5 + torch.sigmoid(pos_score - neg_score)))


def info_nce(
    view1: torch.Tensor, view2: torch.Tensor, idx: torch.Tensor, temperature: float,
    plan: GatherPlan | None = None,
) -> torch.Tensor:
    """In-batch InfoNCE (reference `Utils/Utils.py:57-75`): gather ``idx``
    rows of both full views, L2-normalise, and return ``-mean(diag(
    log_softmax(v1 v2ᵀ / temperature)))``. Duplicate indices are kept: they
    act as extra in-batch negatives, as in the reference. ``plan`` is
    ``gather_plan(idx, n)`` over the views' n rows (made here if not
    given); both gathers share it."""
    if plan is None:
        plan = gather_plan(idx, view1.shape[0])
    v1 = l2_normalize(gather(view1, idx, plan), dim=1)
    v2 = l2_normalize(gather(view2, idx, plan), dim=1)
    log_probs = torch.log_softmax((v1 @ v2.T) / temperature, dim=1)
    return -torch.mean(torch.diagonal(log_probs))


def l2_reg_loss(reg: float, embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
    """``reg * sum_i ||E_i||_F^2`` (reference `Utils/Utils.py:45-54`)."""
    return sum(torch.sum(torch.square(emb)) for emb in embeddings) * reg
