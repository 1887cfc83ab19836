"""Multi-modal LightGCN-style model: parameters + functional forward.

Counterpart of ``diffmm_tpu/models/gcn.py`` (reference `Model.py:15-134`).
Parameters are a dict of plain tensors: ``u_embs`` (U, d), ``i_embs`` (I, d),
``modal_proj`` a list of ``{"w": (feat_dim, d), "b": (d,)}`` and
``modal_weight`` (M,).

Dataflow of :func:`gcn_mm`: project each modality's features, propagate
``[u_embs ; l2norm(proj)]`` one hop over that modality's rebuilt graph,
propagate ``[u_embs ; i_embs]`` once over the main graph, mix, fuse with the
softmax modality weights, then one more hop with the residual quirk
``final = (1 + rw) * (fused + A@fused)`` (the reference's in-place chain
aliases ``modal_embs``, `Model.py:129-131`). On the sparse form with more
than one modality the modal loop runs stacked
(``ops/graph.py::spmm_bi_modal_stacked``) when the modality graphs share one
rows tensor, as the rebuilt ones share the train rows; the KNN ablation's
graphs, laid out per user and k, each have their own and propagate one by
one, as the JAX package keeps them off its stacked path.
``train.stack_modal``, the JAX package's opt-out from a gate it measured on
the TPU, is read and ignored (``train/coach.py``). ``segsum_compute`` sets the messages' type. The JAX
function's static plans have no counterpart (the K4 kernel needs none).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from diffmm_tpu_torch.ops.graph import BiAdj, spmm_bi, spmm_bi_modal_stacked
from diffmm_tpu_torch.ops.losses import l2_normalize

Params = dict[str, Any]


class GCNOutput(NamedTuple):
    """``modal_u/modal_i`` stack the per-modality one-hop views (M, U, d) /
    (M, I, d); ``id_u/id_i`` are the one-hop ID propagation."""

    u_final: torch.Tensor
    i_final: torch.Tensor
    modal_u: torch.Tensor
    modal_i: torch.Tensor
    id_u: torch.Tensor
    id_i: torch.Tensor


def _uniform(gen, shape, bound, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2 * bound) - bound


def init_gcn_params(
    gen: torch.Generator,
    user_num: int,
    item_num: int,
    latdim: int,
    feat_dims: list[int],
    device: torch.device | str = "cpu",
) -> Params:
    """Parameters of the main model (reference `Model.py:16-39`):
    xavier-uniform embeddings, torch-default uniform projections, and
    uniform modality weights."""
    n_modal = len(feat_dims)

    def xavier(shape):
        return _uniform(gen, shape, math.sqrt(6.0 / (shape[0] + shape[1])), device)

    def linear(d_in, d_out):
        bound = 1.0 / math.sqrt(d_in)
        return {
            "w": _uniform(gen, (d_in, d_out), bound, device),
            "b": _uniform(gen, (d_out,), bound, device),
        }

    fill = 1.0 / n_modal if n_modal == 3 else 0.5
    return {
        "u_embs": xavier((user_num, latdim)),
        "i_embs": xavier((item_num, latdim)),
        "modal_proj": [linear(feat_dims[m], latdim) for m in range(n_modal)],
        "modal_weight": torch.full((n_modal,), fill, dtype=torch.float32, device=device),
    }


def project_features(params: Params, raw_feats: list[torch.Tensor]) -> list[torch.Tensor]:
    """Per-modality Linear projections (reference `Model.py:47-58`)."""
    return [f @ p["w"] + p["b"] for f, p in zip(raw_feats, params["modal_proj"])]


def gcn_mm(
    params: Params,
    adj,
    modal_adjs: list,
    raw_feats: list[torch.Tensor],
    modal_adj_weight: float,
    residual_weight: float,
    segsum_compute: str = "f32",
) -> GCNOutput:
    """Multi-modal graph aggregation (reference `Model.py:60-134`): one
    propagation per modality graph and two over the main graph, on
    ``DenseBiAdj``s or ``BiAdj``s."""
    u_embs = params["u_embs"]
    i_embs = params["i_embs"]
    feats = project_features(params, raw_feats)
    weight = torch.softmax(params["modal_weight"], dim=0)

    feats_n = [l2_normalize(f, dim=1) for f in feats]
    rows = modal_adjs[0].ui_rows if modal_adjs and isinstance(modal_adjs[0], BiAdj) else None
    if len(modal_adjs) > 1 and rows is not None and all(a.ui_rows is rows for a in modal_adjs):
        modal_u, modal_i = spmm_bi_modal_stacked(modal_adjs, u_embs, feats_n, segsum_compute)
    else:
        modal_u, modal_i = [], []
        for m_adj, f in zip(modal_adjs, feats_n):
            mu, mi = spmm_bi(m_adj, u_embs, f, segsum_compute)
            modal_u.append(mu)
            modal_i.append(mi)
        modal_u = torch.stack(modal_u)  # (M, U, d)
        modal_i = torch.stack(modal_i)  # (M, I, d)

    id_u, id_i = spmm_bi(adj, u_embs, i_embs, segsum_compute)

    aware_u = id_u[None] + modal_adj_weight * modal_u
    aware_i = id_i[None] + modal_adj_weight * modal_i
    fused_u = torch.einsum("m,mud->ud", weight, aware_u)
    fused_i = torch.einsum("m,mid->id", weight, aware_i)

    hop_u, hop_i = spmm_bi(adj, fused_u, fused_i, segsum_compute)
    final_u = (1.0 + residual_weight) * (fused_u + hop_u)
    final_i = (1.0 + residual_weight) * (fused_i + hop_i)
    return GCNOutput(
        u_final=final_u, i_final=final_i, modal_u=modal_u, modal_i=modal_i,
        id_u=id_u, id_i=id_i,
    )
