"""KNN modality-graph ablation (reference C15, `Main.py:118-134`).

Counterpart of ``diffmm_tpu/ops/knn.py`` (``knn_edges``, ``build_knn_adj``):
in place of the diffusion rebuild, each modality's graph links every user
to the ``knn_topk`` items most similar to the user's prototype, the mean of
the modality features of the user's train items. Enabled with
``hyper.use_knn_adj``; the graphs depend only on the features and the
train edges, so a Coach builds them once a run.

* Prototypes: the f32 features gathered by ``train_cols`` (one row per train
  edge), summed per user by K4 (``ops/kernels/segsum.py``) over the train
  rows' CSR offsets; the sentinel pads past ``offsets[U]`` are never read,
  and the counts are the offsets' spans.
* Cosine similarity: both sides l2-normalised, then one f32
  ``torch.matmul`` (TF32 off), a plain large product that the JAX package
  also leaves to its compiler.
* ``torch.topk`` per user, then a user-major sparse-form ``BiAdj`` from
  ``build_bi_adj_device``, whatever the run's graph form (the JAX package
  builds ``BiAdj`` too): on the dense form a joint step then mixes K1 on the
  user-item block with K4 on these graphs.

At tiktok's shape the transients are the gathered features, (59,541, 768)
f32 = 183 MB, and the similarities, (9,308, 6,710) f32 = 250 MB, once a
run, outside every captured graph.
"""

from __future__ import annotations

import torch

from diffmm_tpu_torch.ops.graph import BiAdj, build_bi_adj_device
from diffmm_tpu_torch.ops.kernels.segsum import segment_offsets, segsum
from diffmm_tpu_torch.ops.losses import l2_normalize


def knn_prototypes(train_rows: torch.Tensor, train_cols: torch.Tensor, feats: torch.Tensor,
                   user_num: int) -> torch.Tensor:
    """(U, d) f32 mean of each user's train items' features: K4 over the
    ascending train rows' offsets (sentinel pads ``row == user_num`` at the
    tail drop out); a user without edges gets zeros."""
    offsets = segment_offsets(train_rows, user_num)
    # a pad's item index is one past the catalog: clamped, its row is never read
    gathered = feats.index_select(0, train_cols.long().clamp_max(feats.shape[0] - 1))
    counts = offsets.diff().to(torch.float32)
    return segsum(gathered, offsets) / torch.clamp_min(counts, 1.0)[:, None]


def knn_edges(train_rows: torch.Tensor, train_cols: torch.Tensor, item_feats: torch.Tensor,
              user_num: int, topk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``topk`` most similar items per user prototype: ``(rows, cols)``
    int32, (user_num * topk,), user-major (JAX ``knn_edges``)."""
    feats = item_feats.to(torch.float32)
    proto = knn_prototypes(train_rows, train_cols, feats, user_num)
    sim = l2_normalize(proto, dim=1) @ l2_normalize(feats, dim=1).T  # (U, I)
    top_idx = torch.topk(sim, topk, dim=1).indices
    rows = torch.arange(user_num, dtype=torch.int32, device=feats.device).repeat_interleave(topk)
    return rows, top_idx.to(torch.int32).reshape(-1)


def build_knn_adj(train_rows: torch.Tensor, train_cols: torch.Tensor, item_feats: torch.Tensor,
                  user_num: int, item_num: int, topk: int) -> BiAdj:
    """The KNN modality adjacency, normalised like every other graph (JAX
    ``build_knn_adj``)."""
    rows, cols = knn_edges(train_rows, train_cols, item_feats, user_num, topk)
    return build_bi_adj_device(rows, cols, user_num, item_num)
