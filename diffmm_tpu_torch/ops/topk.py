"""Per-user variable-k top-k for the epoch graph rebuild.

Counterpart of ``diffmm_tpu/ops/topk.py``. Since ``sum_u degree(u) =
nnz(train)``, each rebuilt graph has exactly ``nnz`` edges at the static
train CSR offsets: positions ``indptr[u] : indptr[u+1]`` hold user ``u``'s
top-``degree(u)`` items (reference `Main.py:224-230`). The host plans
(:func:`plan_rebuild_buckets`, :func:`make_csr_gather_layout`) are numpy and
the same as the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def catalog_topk(scores: torch.Tensor, k: int, offset: int = 0, cat=None) -> torch.Tensor:
    """Per-row top-``k`` global item ids, value-sorted descending, of rows
    whose catalog columns ``[offset, offset + width)`` are ``scores`` (B,
    width), the rest held by the other ranks of the model axis ``cat`` (a
    :class:`~diffmm_tpu_torch.parallel.sharding.Shard`; None: the columns
    are the whole catalog).

    Each rank takes the top ``min(k, width)`` of its columns, offsets them
    to global ids, and a placed all-reduce over the axis brings the ranks'
    candidates together for one merge top-k (JAX's distributed eval top-k,
    ``diffmm_tpu/eval/ranking.py:54-120``). The union of the shards' top
    ``min(k, width)`` holds the global top-k, so the merge is exact (the
    ``min`` covers shards narrower than k). Without an axis the merge runs
    on the one top-k, so one device and a mesh of one rank compute alike.

    The JAX package's two ``train.rebuild_topk`` choices, ``approx``
    (``approx_max_k`` at recall 1.0) and ``exact`` (``top_k``), give the
    same values, so the port has this one form. The order of exactly tied
    values is unspecified in all three, as in ``torch.topk``."""
    from diffmm_tpu_torch.parallel.collectives import placed_all_reduce

    kl = min(k, scores.shape[1])
    vals, idx = torch.topk(scores, kl, dim=1, sorted=True)
    idx = idx + offset
    if cat is not None:
        at, total = cat.index * kl, cat.count * kl
        vals = placed_all_reduce(vals, at, total, cat.group, dim=1, site="topk")
        idx = placed_all_reduce(idx, at, total, cat.group, dim=1, site="topk")
    return torch.gather(idx, 1, torch.topk(vals, k, dim=1, sorted=True).indices)


class RebuildBucketPlan(NamedTuple):
    """Static host plan for the degree-ordered bucketed rebuild
    (``train.rebuild_order = "degree"``); fields as in the JAX package."""

    user_blocks: tuple[np.ndarray, ...]
    widths: tuple[int, ...]
    row_starts: tuple[int, ...]
    row_of_user: np.ndarray


def plan_rebuild_buckets(
    degrees: np.ndarray,
    batch: int,
    item_num: int,
    small_cap: int = 32,
) -> RebuildBucketPlan:
    """Degree-descending two-bucket rebuild plan: the leading bucket takes
    the blocks holding any user of degree > ``small_cap`` at the exact
    global ``k_max``; the tail bucket the rest at the pow2-rounded max
    degree of its users."""
    degrees = np.asarray(degrees, dtype=np.int64)
    n = len(degrees)
    if n == 0:
        raise ValueError("plan_rebuild_buckets: degrees is empty")
    order = np.argsort(-degrees, kind="stable").astype(np.int32)
    n_blocks = max(1, -(-n // batch))
    padded = np.empty(n_blocks * batch, dtype=np.int32)
    padded[:n] = order
    # pad with the lightest user: its rows compute but are never gathered
    padded[n:] = order[-1]
    sorted_deg = np.zeros(n_blocks * batch, dtype=np.int64)
    sorted_deg[:n] = degrees[order]
    block_max = sorted_deg.reshape(n_blocks, batch)[:, 0]
    split = int(np.searchsorted(-block_max, -small_cap))

    def width_for(max_deg: int) -> int:
        w = 1 << max(0, int(max_deg) - 1).bit_length()  # pow2 >= max_deg
        return int(min(max(w, max(1, int(max_deg))), item_num))

    blocks = padded.reshape(n_blocks, batch)
    buckets: list[tuple[np.ndarray, int]] = []
    if split > 0:
        buckets.append((blocks[:split], int(block_max[0])))
    if split < n_blocks:
        buckets.append((blocks[split:], width_for(block_max[split])))
    row_of_user = np.empty(n, dtype=np.int32)
    row_of_user[order] = np.arange(n, dtype=np.int32)
    row_starts, start = [], 0
    for blk, _ in buckets:
        row_starts.append(start)
        start += blk.size
    return RebuildBucketPlan(
        user_blocks=tuple(b for b, _ in buckets),
        widths=tuple(w for _, w in buckets),
        row_starts=tuple(row_starts),
        row_of_user=row_of_user,
    )


def make_csr_gather_layout(
    degrees: np.ndarray, buf_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static layout for the gather-form CSR edge-buffer build:
    ``(u_of_pos, lane_of_pos, pad_mask)`` of length ``buf_len``. Position
    ``p`` of user ``u`` reads lane ``p - offsets[u]`` of ``u``'s row; pad
    positions (``p >= nnz``) read row 0 lane 0 and are masked."""
    degrees = np.asarray(degrees, dtype=np.int64)
    nnz = int(degrees.sum())
    if nnz > buf_len:
        raise ValueError(f"make_csr_gather_layout: nnz {nnz} > buf_len {buf_len}")
    u_of_pos = np.zeros(buf_len, dtype=np.int32)
    u_of_pos[:nnz] = np.repeat(np.arange(len(degrees), dtype=np.int32), degrees)
    offsets = np.cumsum(degrees) - degrees
    lane_of_pos = np.zeros(buf_len, dtype=np.int32)
    lane_of_pos[:nnz] = np.arange(nnz, dtype=np.int64) - offsets[u_of_pos[:nnz]]
    pad_mask = np.zeros(buf_len, dtype=bool)
    pad_mask[nnz:] = True
    return u_of_pos, lane_of_pos, pad_mask


def csr_gather_build(
    table: torch.Tensor,
    u_of_pos: torch.Tensor,
    lane_of_pos: torch.Tensor,
    pad_mask: torch.Tensor,
    item_num: int,
) -> torch.Tensor:
    """User-major CSR edge buffer from a (U, k) top-index table by one
    gather; pad positions hold the ``item_num`` sentinel."""
    edges = table[u_of_pos.long(), lane_of_pos.long()]
    return torch.where(pad_mask, torch.full_like(edges, item_num), edges)
