"""Serving: top-k recommendation from trained embeddings.

Counterpart of ``diffmm_tpu/eval/serving.py`` on one device: export the
final GCN embeddings with the train-seen lists as user-major CSR (O(nnz)),
then answer per-user top-k queries with one matmul and an exact top-k, seen
items masked like eval (reference `Main.py:410`). The npz format is the
same, so an index exported by either package loads in the other. The JAX
package's compile lock and ``approx`` top-k have no counterpart here; the
mesh-sharded index comes with the multi-device slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from diffmm_tpu_torch.utils.device import resolve_device


class RecIndex(NamedTuple):
    """Frozen model state for serving: final embeddings + train-seen CSR."""

    u_final: torch.Tensor  # (U, d)
    i_final: torch.Tensor  # (I, d)
    seen_indptr: torch.Tensor  # (U + 1,) int32
    seen_indices: torch.Tensor  # (nnz,) int32, user-major
    seen_width: int  # max user degree (pad width of a request's seen lists)


def _gather_seen(index: RecIndex, users: torch.Tensor) -> torch.Tensor:
    """(B, width) train-item ids of the requested users, padded with
    ``item_num``."""
    item_num = index.i_final.shape[0]
    width = max(int(index.seen_width), 1)
    n = index.seen_indices.shape[0]
    if n == 0:
        return torch.full((users.shape[0], width), item_num, dtype=torch.long, device=users.device)
    starts = index.seen_indptr[users].long()
    degs = index.seen_indptr[users + 1].long() - starts
    offs = torch.arange(width, device=users.device)[None, :]
    pos = torch.clamp(starts[:, None] + offs, 0, n - 1)
    seen = index.seen_indices[pos].long()
    return torch.where(offs < degs[:, None], seen, torch.full_like(seen, item_num))


def recommend(
    index: RecIndex, users: torch.Tensor, k: int, mask_seen: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` items (ids, scores) for a batch of user ids.

    ``k`` is validated and rounded up to the next power of two for the
    top-k, then sliced back, as in the JAX package. Seen items score
    ``-1e9``, below every real score."""
    item_num = int(index.i_final.shape[0])
    k = int(k)
    if not 1 <= k <= item_num:
        raise ValueError(f"k must be in [1, {item_num}], got {k}")
    k_pad = min(1 << (k - 1).bit_length(), item_num)
    users = users.to(index.u_final.device).long()
    scores = index.u_final[users] @ index.i_final.T  # (B, I)
    if mask_seen:
        seen = _gather_seen(index, users)
        rows = torch.arange(users.shape[0], device=users.device)[:, None].expand_as(seen)
        keep = seen < item_num  # pad entries drop, as mode="drop" in JAX
        scores[rows[keep], seen[keep]] = -1e9
    top_scores, top_ids = torch.topk(scores, k_pad, dim=1, sorted=True)
    return top_ids[:, :k].to(torch.int32), top_scores[:, :k]


def seen_csr_from_edges(
    rows: np.ndarray, cols: np.ndarray, user_num: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side user-major CSR train-item lists: ``(indptr (U+1,),
    indices (nnz,), max_degree)``."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    deg = np.bincount(rows, minlength=user_num)[:user_num]
    order = np.argsort(rows, kind="stable")
    indices = cols[order].astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    width = max(int(deg.max()) if deg.size else 1, 1)
    return indptr, indices, width


def build_index(coach, use_best: bool = True) -> RecIndex:
    """Freeze a Coach into a serving index: the GCN forward over its
    rebuilt modality graphs, like eval.

    ``use_best``: serve the best-Recall epoch's captured model
    (``Coach.best_state``, the reference's model selection, `Main.py:71-78`)
    rather than the last epoch's; the live state when no eval ran, as for
    a Coach that only rebuilt its graphs."""
    if use_best:
        params, modal_adjs = coach.best_state()
        u_final, i_final = coach.forward(params, modal_adjs)
    else:
        u_final, i_final = coach.forward()
    indptr, indices, width = seen_csr_from_edges(
        coach.host.train_rows, coach.host.train_cols, coach.host.user_num
    )
    return RecIndex(
        u_final=u_final,
        i_final=i_final,
        seen_indptr=torch.as_tensor(indptr, device=coach.device),
        seen_indices=torch.as_tensor(indices, device=coach.device),
        seen_width=width,
    )


def save_index(index: RecIndex, path: str) -> None:
    """Export as npz with the train mask in CSR (indptr/indices)."""
    np.savez(
        path,
        u_final=index.u_final.cpu().numpy(),
        i_final=index.i_final.cpu().numpy(),
        seen_indptr=index.seen_indptr.cpu().numpy(),
        seen_indices=index.seen_indices.cpu().numpy(),
    )


def load_index(path: str, device: str | torch.device | None = None) -> RecIndex:
    """Load an npz index (either package's CSR export) onto ``device``
    (``cuda`` unless ``"cpu"`` is passed)."""
    dev = resolve_device(device)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        indptr = data["seen_indptr"].astype(np.int32)
        indices = data["seen_indices"].astype(np.int32)
        deg = np.diff(indptr)
        width = max(int(deg.max()) if deg.size else 1, 1)
        return RecIndex(
            u_final=torch.as_tensor(data["u_final"], device=dev),
            i_final=torch.as_tensor(data["i_final"], device=dev),
            seen_indptr=torch.as_tensor(indptr, device=dev),
            seen_indices=torch.as_tensor(indices, device=dev),
            seen_width=width,
        )
