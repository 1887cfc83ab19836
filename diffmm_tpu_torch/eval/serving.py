"""Serving: top-k recommendation from trained embeddings.

Counterpart of ``diffmm_tpu/eval/serving.py``: export the final GCN
embeddings with the train-seen lists as user-major CSR (O(nnz)), then
answer per-user top-k queries with one matmul and an exact top-k, seen
items masked like eval (reference `Main.py:410`). The npz format is the
same, so an index exported by either package loads in the other. The JAX
package's compile lock has no counterpart here (a request compiles
nothing; :func:`warmup` runs each k once, so cuBLAS's and the allocator's
first-use costs fall before the first request).

``approx=True`` is the JAX package's ``jax.lax.approx_max_k`` at
``recall_target=0.95``. That function is a TPU bucketed top-k; on every
other backend it returns the exact top-k (the ids and values of
``lax.top_k``). Off the TPU, then, ``approx`` does not change what the JAX
package serves, and the port computes that same function: the exact
``torch.topk``, recall 1 against a contract of at least 0.95.

On a mesh with a model axis (JAX ``_make_recommend_sharded``,
``place_index``, ``recommend(mesh=)``, ``serving.py:133-306``) each model
rank keeps its rows of ``i_final`` (:func:`place_index`), scores its
catalog shard, and the shards' candidates meet in a placed all-reduce for
an exact final top-k. Every rank of the axis calls :func:`recommend` with
the same request (``eval/serve_http.py`` broadcasts it).
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
    # the whole catalog's size when i_final holds one model rank's rows
    # (place_index); None when i_final is whole
    item_num: int | None = None


def _gather_seen(index: RecIndex, users: torch.Tensor) -> torch.Tensor:
    """(B, width) train-item ids of the requested users, padded with
    ``item_num``."""
    item_num = _catalog(index)
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


def _catalog(index: RecIndex) -> int:
    return int(index.i_final.shape[0]) if index.item_num is None else int(index.item_num)


def _model_axis(mesh) -> tuple[int, int, object]:
    """(ranks, this rank's index, group) of ``mesh``'s model axis; one rank
    without a mesh."""
    if mesh is None:
        return 1, 0, None
    from diffmm_tpu_torch.parallel.mesh import MODEL_AXIS, axis_index, axis_size

    return axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS), mesh.get_group(MODEL_AXIS)


def recommend(
    index: RecIndex, users: torch.Tensor, k: int, mask_seen: bool = True, mesh=None,
    approx: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` items (ids, scores) for a batch of user ids.

    ``k`` is validated and rounded up to the next power of two for the
    top-k, then sliced back, as in the JAX package. Seen items score
    ``-1e9``, below every real score.

    ``mesh``: serve over its model axis, every rank of which calls with
    the same request. Each rank scores its catalog shard (the rows
    :func:`place_index` kept, or its slice of a whole ``i_final``), masks
    the seen items of its range, takes a local top-k, and a placed
    all-reduce brings the m shards' candidates together for one final
    top-k: exact, the replicated call's ids. A catalog the axis does not
    divide, or a padded k above the shard width, takes the replicated
    call, as in the JAX package; a placed index first brings its rows
    together for it (a placed all-reduce).

    ``approx``: the JAX package's ``approx_max_k`` (recall target 0.95),
    replicated and per shard. Off the TPU that is the exact top-k, which
    every top-k here already is (module docstring): the answer equals the
    ``approx=False`` one."""
    item_num = _catalog(index)
    k = int(k)
    if not 1 <= k <= item_num:
        raise ValueError(f"k must be in [1, {item_num}], got {k}")
    k_pad = min(1 << (k - 1).bit_length(), item_num)
    users = users.to(index.u_final.device).long()
    m, r, group = _model_axis(mesh)
    if m > 1 and item_num % m == 0 and k_pad <= item_num // m:
        return _recommend_sharded(index, users, k, k_pad, mask_seen, m, r, group)
    i_final = index.i_final
    if index.item_num is not None:
        from diffmm_tpu_torch.parallel.collectives import placed_all_reduce

        i_final = placed_all_reduce(i_final, r * i_final.shape[0], item_num, group)
    scores = index.u_final[users] @ i_final.T  # (B, I)
    if mask_seen:
        seen = _gather_seen(index, users)
        rows = torch.arange(users.shape[0], device=users.device)[:, None].expand_as(seen)
        keep = seen < item_num  # pad entries drop, as mode="drop" in JAX
        scores[rows[keep], seen[keep]] = -1e9
    top_scores, top_ids = torch.topk(scores, k_pad, dim=1, sorted=True)
    return top_ids[:, :k].to(torch.int32), top_scores[:, :k]


def _recommend_sharded(index: RecIndex, users, k: int, k_pad: int, mask_seen: bool, m: int, r: int,
                       group) -> tuple[torch.Tensor, torch.Tensor]:
    """The model-axis branch of :func:`recommend` (JAX
    ``_make_recommend_sharded``)."""
    from diffmm_tpu_torch.parallel.collectives import placed_all_reduce

    item_num = _catalog(index)
    width = item_num // m
    off = r * width
    i_loc = index.i_final if index.item_num is not None else index.i_final[off:off + width]
    scores = index.u_final[users] @ i_loc.T  # (B, I/m)
    if mask_seen:
        # seen items outside this shard, and the pads, go to a dropped lane
        loc = _gather_seen(index, users) - off
        loc = torch.where((loc >= 0) & (loc < width), loc, width)
        scores = torch.cat([scores, scores.new_zeros((scores.shape[0], 1))], dim=1)
        scores = scores.scatter_(1, loc, -1e9)[:, :width]
    vals, idx = torch.topk(scores, k_pad, dim=1, sorted=True)
    vals_all = placed_all_reduce(vals, r * k_pad, m * k_pad, group, dim=1)
    ids_all = placed_all_reduce(idx + off, r * k_pad, m * k_pad, group, dim=1)
    top_scores, sel = torch.topk(vals_all, k_pad, dim=1, sorted=True)
    top_ids = torch.gather(ids_all, 1, sel)
    return top_ids[:, :k].to(torch.int32), top_scores[:, :k]


def place_index(index: RecIndex, mesh) -> RecIndex:
    """Lay the index out for serving over ``mesh``'s model axis (JAX
    ``place_index``): this rank keeps its rows of ``i_final``, everything
    else whole (``u_final`` and the seen lists are addressed by any
    request's users). Unchanged without a model axis above 1, or for a
    catalog the axis does not divide."""
    from diffmm_tpu_torch.parallel.sharding import CATALOG, catalog_spec

    m, r, _ = _model_axis(mesh)
    item_num = _catalog(index)
    if m == 1 or catalog_spec(item_num, mesh) != CATALOG or index.item_num is not None:
        return index
    width = item_num // m
    return index._replace(i_final=index.i_final[r * width:(r + 1) * width].clone(), item_num=item_num)


def warmup(index: RecIndex, ks: list[int] | None = None, mesh=None, approx: bool = False) -> None:
    """Run :func:`recommend` once for each ``k`` (default 20) and both mask
    modes on a single-user request and wait for the card (JAX ``warmup``,
    which compiles the variants): the first request of each k pays no
    first-use cost of its own. A new host thread still pays for its cuBLAS
    handle on its first product, which a warmup on another thread cannot
    cover. ``approx`` as the server's requests will take it."""
    users = torch.zeros((1,), dtype=torch.int32, device=index.u_final.device)
    for k in ks or [20]:
        for mask_seen in (True, False):
            recommend(index, users, k, mask_seen, mesh=mesh, approx=approx)
    if index.u_final.device.type == "cuda":
        torch.cuda.synchronize(index.u_final.device)


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


def build_index(coach, use_best: bool = True, place: bool = True) -> RecIndex:
    """Freeze a Coach into a serving index: the GCN forward over its
    rebuilt modality graphs, like eval, placed on the Coach's mesh
    (:func:`place_index`) unless ``place`` is false (an index to export
    whole, :func:`save_index`). On a mesh every rank builds it (the
    forward's collectives need every rank).

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
    index = RecIndex(
        u_final=u_final,
        i_final=i_final,
        seen_indptr=torch.as_tensor(indptr, device=coach.device),
        seen_indices=torch.as_tensor(indices, device=coach.device),
        seen_width=width,
    )
    return place_index(index, getattr(coach, "mesh", None)) if place else index


def save_index(index: RecIndex, path: str) -> None:
    """Export as npz with the train mask in CSR (indptr/indices); a placed
    index (one rank's catalog rows) refuses."""
    if index.item_num is not None:
        raise ValueError("save_index: this index holds one model rank's catalog rows (place_index)")
    np.savez(
        path,
        u_final=index.u_final.cpu().numpy(),
        i_final=index.i_final.cpu().numpy(),
        seen_indptr=index.seen_indptr.cpu().numpy(),
        seen_indices=index.seen_indices.cpu().numpy(),
    )


def load_index(path: str, device: str | torch.device | None = None, mesh=None) -> RecIndex:
    """Load an npz index (either package's CSR export) onto ``device``
    (``cuda`` unless ``"cpu"`` is passed), placed on ``mesh``
    (:func:`place_index`)."""
    dev = resolve_device(device)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        indptr = data["seen_indptr"].astype(np.int32)
        indices = data["seen_indices"].astype(np.int32)
        deg = np.diff(indptr)
        width = max(int(deg.max()) if deg.size else 1, 1)
        return place_index(RecIndex(
            u_final=torch.as_tensor(data["u_final"], device=dev),
            i_final=torch.as_tensor(data["i_final"], device=dev),
            seen_indptr=torch.as_tensor(indptr, device=dev),
            seen_indices=torch.as_tensor(indices, device=dev),
            seen_width=width,
        ), mesh)
