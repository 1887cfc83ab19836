"""Loss ops shared by the models. Counterpart of ``diffmm_tpu/ops/losses.py``;
this slice needs only :func:`l2_normalize` (BPR, InfoNCE and L2 come with
the training slice)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization, ``x / max(||x||, eps)`` (as
    `torch.nn.functional.normalize`, p=2)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(norm, eps)
