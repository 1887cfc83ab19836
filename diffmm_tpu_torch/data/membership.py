"""Train membership rows for a user batch: dense (U, I) store or O(nnz) CSR.

Counterpart of ``diffmm_tpu/data/membership.py``. The dense store is the
(U, I) int8 matrix (reference `DataHandler.py:128`); a row gather is one
contiguous read. The CSR store (:class:`TrainCSR`) is three O(nnz)/O(U)
tensors the loader already holds, so the sparse graph form carries no
(U, I) tensor anywhere: a block's rows exist only as its (B, I) transient,
built by one scatter of the users' spans. Both stores give bit-identical
0/1 rows, and the same answers from the membership test
(:func:`contains`) of negative sampling.

On a model axis that divides the catalog a rank holds only its catalog
columns ``[lo, hi)`` of the dense store, a :class:`DenseShard` that
carries its range (``to_device``'s ``store_cols``; JAX
``_place_train_store``): its readers take a range inside it, and
:func:`contains` answers for its columns alone. The CSR store stays whole
on every rank, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TrainCSR:
    """O(nnz) train membership: user-major sorted CSR.

    Attributes:
      cols: (nnz_pad,) int32 item ids, user-major with ascending items in
        each user's span (the loader's lexsort order); sentinel pads at the
        tail, never inside a span.
      offsets: (U,) int32 start of each user's span.
      degrees: (U,) int32 span lengths.
      k_max: max user degree, the span gather's width.
      k_cut: head/tail lane split of :func:`gather_rows` (``k_cut ==
        k_max``: no split); see :func:`plan_head_tail`.
      heavy_ids: (n_heavy,) int32 users of degree > k_cut, or None. Only
        its length is read: it caps the tail fixup's rows per block.
    """

    cols: torch.Tensor
    offsets: torch.Tensor
    degrees: torch.Tensor
    k_max: int
    k_cut: int
    heavy_ids: torch.Tensor | None = None


class DenseShard(NamedTuple):
    """A rank's catalog columns ``[lo, hi)`` of the dense (U, I) int8 train
    store: ``block`` is (U, hi - lo). A whole dense store is the (U, I)
    tensor itself."""

    block: torch.Tensor
    lo: int
    hi: int


def _span_lanes(cols: torch.Tensor, off: torch.Tensor, deg: torch.Tensor, lo: int, hi: int):
    """Items and lane mask for lanes ``[lo, hi)`` of each span: the one
    clamped span gather every consumer shares. Positions past the edge
    buffer clamp to its last entry; callers mask the invalid lanes."""
    lanes = torch.arange(lo, hi, dtype=torch.int64, device=cols.device)
    pos = off.long()[:, None] + lanes[None, :]
    valid = lanes[None, :] < deg.long()[:, None]
    items = cols[pos.clamp_max(cols.shape[0] - 1)]
    return items, valid


def gather_item_lists(store: TrainCSR, users: torch.Tensor):
    """``(items, valid)``: the users' spans as a (B, k_max) int32 table
    (arbitrary where invalid) and its (B, k_max) bool lane mask."""
    users = users.long()
    return _span_lanes(store.cols, store.offsets[users], store.degrees[users], 0, store.k_max)


def _scatter_ones(rows: torch.Tensor, row_idx: torch.Tensor, items: torch.Tensor,
                  valid: torch.Tensor) -> None:
    """``rows[row_idx[b], items[b, j]] = 1`` where ``valid[b, j]``, in place.
    The invalid lanes write 0 through ``amax`` into column 0 of their row,
    which leaves it as it is: no lane is filtered out on the host."""
    item_num = rows.shape[1]
    flat = row_idx.long()[:, None] * item_num + torch.where(valid, items.long(), 0)
    rows.view(-1).scatter_reduce_(0, flat.reshape(-1), valid.reshape(-1).to(rows.dtype), "amax")


def dense_rows(store, users: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The users' rows of a dense store (the (U, I) tensor or a
    :class:`DenseShard`) over the catalog range ``[lo, hi)``, in the
    store's type. A range the store does not hold is refused."""
    block, first = (store.block, store.lo) if isinstance(store, DenseShard) else (store, 0)
    if lo < first or hi > first + block.shape[1]:
        raise ValueError(f"the dense store holds the columns [{first}, {first + block.shape[1]}), "
                         f"not [{lo}, {hi})")
    rows = block.index_select(0, users.long())
    return rows if (lo - first, hi - first) == (0, block.shape[1]) else rows[:, lo - first:hi - first]


def gather_rows(store, users: torch.Tensor, item_num: int,
                cols: tuple[int, int] | None = None) -> torch.Tensor:
    """(B, hi - lo) f32 0/1 train rows for a user batch over the catalog
    range ``cols = (lo, hi)`` (default: the whole catalog).

    Dense store: one row gather + cast (:func:`dense_rows`). CSR store:
    span gather + one scatter into (B, item_num) zeros, then the range.
    With a head/tail plan (``k_cut < k_max``) the span gather runs k_cut
    lanes for the whole block plus a (min(n_heavy, B), k_max - k_cut) fixup
    for the block's heavy users, as in the JAX package: the same positions,
    the same value, so the rows are bit-identical either way."""
    lo, hi = (0, item_num) if cols is None else cols
    if not isinstance(store, TrainCSR):
        return dense_rows(store, users, lo, hi).to(torch.float32)
    rows = _csr_rows(store, users, item_num)
    return rows if (lo, hi) == (0, item_num) else rows[:, lo:hi]


def _csr_rows(store: TrainCSR, users: torch.Tensor, item_num: int) -> torch.Tensor:
    """(B, item_num) f32 0/1 rows of a CSR store (:func:`gather_rows`)."""
    users = users.long()
    b = users.shape[0]
    split = store.heavy_ids is not None and store.k_cut < store.k_max
    off = store.offsets[users]
    deg = store.degrees[users]
    row_ids = torch.arange(b, device=users.device)
    rows = torch.zeros((b, item_num), dtype=torch.float32, device=users.device)
    items, valid = _span_lanes(store.cols, off, deg, 0, store.k_cut if split else store.k_max)
    _scatter_ones(rows, row_ids, items, valid)
    if not split:
        return rows
    # the block's heavy rows first (ascending), pad slots (== b) last; each
    # row's own degree decides, so duplicate users get their full rows
    h_cap = min(store.heavy_ids.shape[0], b)
    rows_sel = torch.sort(torch.where(deg > store.k_cut, row_ids, b)).values[:h_cap]
    real = rows_sel < b
    sel = rows_sel.clamp_max(b - 1)
    titems, tvalid = _span_lanes(store.cols, off[sel], deg[sel], store.k_cut, store.k_max)
    _scatter_ones(rows, sel, titems, tvalid & real[:, None])
    return rows


def contains(store, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """Per-lane membership test: is ``(users[e], items[e])`` a train edge?

    Dense store: one 2-D gather. CSR store: a fixed-depth lower-bound
    binary search over each user's ascending span, ``bit_length(k_max)``
    rounds (every lane converges: spans hold at most k_max items), as in
    the JAX package. User ids past the last user (the edge pads) are
    clamped to it, as the JAX dense gather clamps them; their answers are
    never used.

    A :class:`DenseShard` answers for its columns only: an item outside
    them is no hit here (``data/sampling.py`` ORs the model axis's
    answers)."""
    if isinstance(store, DenseShard):
        inside = (items >= store.lo) & (items < store.hi)
        return contains(store.block, users, (items.long() - store.lo).clamp(0, store.hi - store.lo - 1)) & inside
    csr = isinstance(store, TrainCSR)
    users = users.long().clamp_max((store.degrees if csr else store).shape[0] - 1)
    items = items.long()
    if not csr:
        return store[users, items] != 0
    lo = store.offsets[users].long()
    end = hi = lo + store.degrees[users].long()
    last = store.cols.shape[0] - 1
    for _ in range(max(int(store.k_max).bit_length(), 1)):
        mid = (lo + hi) // 2
        go_right = store.cols[mid.clamp(0, last)] < items
        active = lo < hi
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    found = store.cols[lo.clamp(0, last)] == items
    return (lo < end) & found


def plan_head_tail(degrees, k_max: int, block: int = 1024):
    """The head/tail lane split of :func:`gather_rows`, on the host (JAX
    ``plan_head_tail``): the power of two k (or k_max) that minimises the
    scattered lanes of a full user pass in blocks of ``block``,
    ``U·k + ceil(U/block)·H(k)·(k_max − k)`` with ``H(k)`` the users of
    degree > k. Returns ``(k_cut, heavy_ids)``; ``(k_max, None)`` means no
    split."""
    deg = np.asarray(degrees)
    u = int(deg.shape[0])
    k_max = int(k_max)
    blocks = max(1, -(-u // int(block)))
    candidates = [k_max] + [
        1 << i for i in range(3, max(k_max.bit_length(), 4)) if (1 << i) < k_max
    ]
    best_k, best_cost = k_max, u * k_max
    for k in candidates:
        h = int((deg > k).sum())
        cost = u * k + blocks * h * (k_max - k)
        if cost < best_cost:
            best_k, best_cost = k, cost
    if best_k >= k_max:
        return k_max, None
    return best_k, np.flatnonzero(deg > best_k).astype(np.int32)


def make_train_csr(
    cols: torch.Tensor,
    offsets: torch.Tensor,
    degrees: torch.Tensor,
    k_max: int,
    k_cut: int | None = None,
    heavy_ids=None,
) -> TrainCSR:
    """A store over the loader's device tensors (``cols`` is
    ``DeviceData.train_cols``): nothing new beyond the O(n_heavy) plan."""
    k_max = int(k_max)
    if heavy_ids is not None and k_cut is not None and int(k_cut) < k_max:
        heavy_ids = torch.as_tensor(np.array(heavy_ids, dtype=np.int32), device=cols.device)
        k_cut = int(k_cut)
    else:
        k_cut, heavy_ids = k_max, None
    return TrainCSR(cols=cols, offsets=offsets, degrees=degrees, k_max=k_max,
                    k_cut=k_cut, heavy_ids=heavy_ids)
