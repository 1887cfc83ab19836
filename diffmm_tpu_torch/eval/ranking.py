"""Full-catalog ranking evaluation: Recall@K / NDCG@K / Precision@K.

Counterpart of ``diffmm_tpu/eval/ranking.py`` on one device: masked scoring
and top-k (reference `Main.py:403-411`), and the vectorised metric sums
(reference `Main.py:422-448`). ``u @ i_final.T`` stays ``torch.matmul``: the
JAX package computes it outside any Pallas kernel too. The distributed
top-k of a mesh comes with the multi-device slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from diffmm_tpu_torch.data.membership import gather_rows


class EvalBatchSums(NamedTuple):
    recall: torch.Tensor
    ndcg: torch.Tensor
    precision: torch.Tensor


def dcg_table(topk: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``table[j] = sum_{loc < j} 1/log2(loc + 2)`` for j in [0, topk]."""
    gains = 1.0 / np.log2(np.arange(topk, dtype=np.float64) + 2.0)
    return torch.as_tensor(
        np.concatenate([[0.0], np.cumsum(gains)]).astype(np.float32), device=device
    )


def _plain_score_topk(u, i_final, train_store, users, topk):
    """Mask train items, full-row top-k (reference `Main.py:403-411`)."""
    mask = gather_rows(train_store, users, i_final.shape[0])
    scores = (u @ i_final.T) * (1.0 - mask) - mask * 1e8
    return torch.topk(scores, topk, dim=1).indices


def _metric_sums(
    top_idx: torch.Tensor,
    valid: torch.Tensor,
    test_items: torch.Tensor,
    test_counts: torch.Tensor,
    cum_dcg: torch.Tensor,
    topk: int,
) -> EvalBatchSums:
    """Recall/NDCG/Precision sums from the top-k ids; each test item
    matches at most one slot, so ``dcg = sum 1/log2(slot + 2)`` and the
    ideal DCG is ``cum_dcg[min(|test|, K)]``."""
    match = (test_items[:, :, None] == top_idx[:, None, :]) & (test_items[:, :, None] >= 0)
    hits = match.any(dim=2).sum(dim=1).to(torch.float32)
    slot_gain = 1.0 / torch.log2(
        torch.arange(topk, dtype=torch.float32, device=top_idx.device) + 2.0
    )
    dcg = (match.to(torch.float32) * slot_gain[None, None, :]).sum(dim=(1, 2))
    counts = test_counts.to(torch.float32)
    max_dcg = cum_dcg[torch.clamp_max(test_counts.long(), topk)]
    w = valid.to(torch.float32)
    return EvalBatchSums(
        recall=(w * hits / torch.clamp_min(counts, 1.0)).sum(),
        ndcg=(w * dcg / torch.clamp_min(max_dcg, 1e-12)).sum(),
        precision=(w * hits / topk).sum(),
    )


def eval_epoch(
    u_final, i_final, users_blocks, valid_blocks, train_store,
    items_blocks, counts_blocks, cum_dcg, topk: int,
) -> torch.Tensor:
    """Summed (recall, ndcg, precision) over blocks with a leading
    (n_blocks,) dim, one block at a time."""
    acc = torch.zeros(3, dtype=torch.float32, device=u_final.device)
    for users, valid, t_items, t_counts in zip(
        users_blocks, valid_blocks, items_blocks, counts_blocks
    ):
        top_idx = _plain_score_topk(
            u_final.index_select(0, users.long()), i_final, train_store, users, topk
        )
        acc += torch.stack(_metric_sums(top_idx, valid, t_items, t_counts, cum_dcg, topk))
    return acc
