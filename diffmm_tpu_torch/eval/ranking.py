"""Full-catalog ranking evaluation: Recall@K / NDCG@K / Precision@K.

Counterpart of ``diffmm_tpu/eval/ranking.py``: masked scoring and top-k
(reference `Main.py:403-411`), and the vectorised metric sums (reference
`Main.py:422-448`). ``u @ i_final.T`` stays ``torch.matmul``: the JAX
package computes it outside any Pallas kernel too. On a mesh with a model
axis, :func:`make_score_topk` is the JAX package's exact distributed top-k
over catalog shards (``ranking.py:54-120``); the data axis splits the eval
blocks' users in the Coach (``Coach._eval_sums``), which adds the metric
sums over it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from diffmm_tpu_torch.data.membership import TrainCSR, dense_rows, gather_item_lists, gather_rows


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


def local_mask(train_store, users: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """(B, hi - lo) f32: 1 where a user of ``users`` has a train item of the
    catalog range ``[lo, hi)``. A dense store's rows of the range
    (``membership.dense_rows``: of the (U, I) tensor or of a rank's
    ``DenseShard``); a CSR store's seen lists are gathered whole and the
    items of the range kept (JAX ``local_mask_csr``)."""
    width = hi - lo
    if isinstance(train_store, TrainCSR):
        seen, valid = gather_item_lists(train_store, users)
        loc = seen.long() - lo
        loc = torch.where(valid & (loc >= 0) & (loc < width), loc, width)  # out of range: dropped
        mask = torch.zeros((users.shape[0], width + 1), dtype=torch.float32, device=users.device)
        return mask.scatter_(1, loc, 1.0)[:, :width]
    return dense_rows(train_store, users, lo, hi).to(torch.float32)


def make_score_topk(topk: int, mesh=None):
    """``(u, i_final, train_store, users) -> (B, topk)`` global item ids.

    Without a mesh, or with a model axis of 1, the replicated full-catalog
    scoring. On a model axis of m ranks each scores the block's users
    against its own catalog shard only, ``(B, I/m)`` with its part of the
    mask, takes a local top-k, offsets its ids to global ones, and a placed
    all-reduce over the model axis brings every shard's k candidates
    together, ``(B, m·k)`` values and ids, for one final top-k: the top-k
    of the union of the shards' top-ks is the global top-k, so the ids are
    the replicated call's (ties at the -1e8 mask floor may order
    differently; masked items are train items, never test items).

    A dense store's columns are sliced (or are the rank's own, where the
    store is cut on the model axis); a CSR store's seen lists are gathered
    whole and each rank keeps the items of its range (JAX
    ``local_mask_csr``). ``i_final`` is the whole (I, d) table. A catalog
    the axis does not divide, or shards thinner than k, take the replicated
    branch, as in the JAX package (``ranking.py:83-86``)."""
    from diffmm_tpu_torch.parallel.mesh import MODEL_AXIS, axis_index, axis_size

    m = 1 if mesh is None else axis_size(mesh, MODEL_AXIS)
    if m == 1:
        return lambda u, i_final, train_store, users: _plain_score_topk(u, i_final, train_store, users, topk)
    r, group = axis_index(mesh, MODEL_AXIS), mesh.get_group(MODEL_AXIS)

    def sharded(u, i_final, train_store, users):
        from diffmm_tpu_torch.ops.topk import catalog_topk
        from diffmm_tpu_torch.parallel.sharding import Shard

        item_num = i_final.shape[0]
        if item_num % m or topk > item_num // m:
            return _plain_score_topk(u, i_final, train_store, users, topk)
        width = item_num // m
        off = r * width
        mask = local_mask(train_store, users, off, off + width)
        s = (u @ i_final[off:off + width].T) * (1.0 - mask) - mask * 1e8
        return catalog_topk(s, topk, off, Shard(r, m, group))

    return sharded


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
    items_blocks, counts_blocks, cum_dcg, topk: int, cols: tuple[int, int] | None = None, cat=None,
) -> torch.Tensor:
    """Summed (recall, ndcg, precision) over blocks with a leading
    (n_blocks,) dim, one block at a time.

    The trainer's eval (``Coach.test_epoch``) scores the catalog range
    ``cols`` (default: the whole catalog) of the whole ``i_final`` and
    merges over the model axis ``cat`` (``ops/topk.py::catalog_topk``; JAX
    ``ranking.py:54-120``): on a model axis each rank scores its catalog
    shard, and one device takes the same steps over one part."""
    from diffmm_tpu_torch.ops.topk import catalog_topk

    lo, hi = (0, i_final.shape[0]) if cols is None else cols
    items = i_final[lo:hi]
    acc = torch.zeros(3, dtype=torch.float32, device=u_final.device)
    for users, valid, t_items, t_counts in zip(
        users_blocks, valid_blocks, items_blocks, counts_blocks
    ):
        mask = local_mask(train_store, users, lo, hi)
        scores = (u_final.index_select(0, users.long()) @ items.T) * (1.0 - mask) - mask * 1e8
        top_idx = catalog_topk(scores, topk, lo, cat)
        acc += torch.stack(_metric_sums(top_idx, valid, t_items, t_counts, cum_dcg, topk))
    return acc
