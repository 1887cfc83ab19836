"""Bipartite-graph propagation, dense form.

Counterpart of the dense form in ``diffmm_tpu/ops/graph.py``: the
symmetric-normalised bipartite adjacency ``D^-1/2 (A + I) D^-1/2`` over the
(user, item) nodes (reference `DataHandler.py:68-93`) with the self-loop
folded analytically, ``y = s * (A (s * x)) + s^2 * x``, and the 0/1 block A
held as a dense (U, I) matrix. Both propagation directions go through the
``spmm_dual`` kernel (K1) on the card, with bf16 operands and f32
accumulation as in the JAX package. The sparse form (``BiAdj``, segment
sums, kernel K4) comes with a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from diffmm_tpu_torch.ops.kernels.spmm_dual import dense_storage, spmm_dual


class DenseBiAdj(NamedTuple):
    """The normalised bipartite operator in dense form.

    Attributes:
      mat: (U, I) 0/1 interaction matrix (no normalisation folded in),
        stored int8 or bf16 (``train.dense_store``).
      s_user: (U,) f32 ``(deg_u + 1)^-1/2``.
      s_item: (I,) f32 ``(deg_i + 1)^-1/2``.
    """

    mat: torch.Tensor
    s_user: torch.Tensor
    s_item: torch.Tensor

    @property
    def user_num(self) -> int:
        return self.mat.shape[0]

    @property
    def item_num(self) -> int:
        return self.mat.shape[1]


def build_dense_bi_adj_device(
    ui_rows: torch.Tensor,
    ui_cols: torch.Tensor,
    user_num: int,
    item_num: int,
    store_dtype: torch.dtype = torch.int8,
) -> DenseBiAdj:
    """Dense-form adjacency from (possibly sentinel-padded) device edges.

    The JAX package drops the sentinel pad edges ``(user_num, item_num)``
    with ``mode="drop"`` in its scatter and degree sums; ``index_put_`` has
    no drop mode, so they are filtered out first. Edges are unique (one per
    train interaction or per rebuilt top-k slot), so the degrees count
    them."""
    keep = (ui_rows < user_num) & (ui_cols < item_num)
    rows = ui_rows[keep].long()
    cols = ui_cols[keep].long()
    deg_u = torch.bincount(rows, minlength=user_num).to(torch.float32)
    deg_i = torch.bincount(cols, minlength=item_num).to(torch.float32)
    # rows on 16-byte boundaries, so the spmm_dual kernel reads them in
    # 16-byte vectors (a (U, I) view of padded storage)
    mat = dense_storage(user_num, item_num, store_dtype, ui_rows.device)
    mat[rows, cols] = 1
    return DenseBiAdj(
        mat=mat,
        s_user=torch.rsqrt(deg_u + 1.0),
        s_item=torch.rsqrt(deg_i + 1.0),
    )


def spmm_bi(adj: DenseBiAdj, x_user: torch.Tensor, x_item: torch.Tensor):
    """``y = D^-1/2 (A + I) D^-1/2 x`` on the split (user, item) embedding
    pair (reference `Model.py:90`), dense form (JAX ``_spmm_bi_dense``).
    Returns ``(y_user, y_item)``."""
    if not isinstance(adj, DenseBiAdj):
        raise NotImplementedError(
            "the sparse graph form is not ported yet (ROADMAP.md A, slice 3)"
        )
    z_u = x_user * adj.s_user[:, None]
    z_i = x_item * adj.s_item[:, None]
    m_u, m_i = spmm_dual(adj.mat, z_u, z_i)
    y_u = adj.s_user[:, None] * (m_u + z_u)
    y_i = adj.s_item[:, None] * (m_i + z_i)
    return y_u, y_i
