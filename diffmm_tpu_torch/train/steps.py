"""The serving path's step functions: the phase-2 graph rebuild and the GCN
forward.

Counterpart of ``diffmm_tpu/train/steps.py`` ``rebuild_epoch`` (lines
296-372) and ``gcn_forward`` (487-498). The JAX package compiles these into
scanned programs; here they are plain functions and the block loop is a
Python loop. The training steps come with the training slice.
"""

from __future__ import annotations

import torch

from diffmm_tpu_torch.data.membership import gather_rows
from diffmm_tpu_torch.diffusion.gaussian import generate_view
from diffmm_tpu_torch.diffusion.schedule import DiffusionSchedule
from diffmm_tpu_torch.models.gcn import gcn_mm
from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
    PreparedDenoiser,
    denoise_forward_fused,
    prepare_denoiser,
)
from diffmm_tpu_torch.ops.topk import csr_gather_build, topk_table


def rebuild_block_tables(
    schedule: DiffusionSchedule,
    denoisers: list[PreparedDenoiser],
    train_store,
    users: torch.Tensor,
    item_num: int,
    sampling_step: int,
    k_table: int,
    generator: torch.Generator | None = None,
) -> list[torch.Tensor]:
    """Reverse-diffuse a user block per modality -> value-sorted (B,
    k_table) top-index tables, one per modality. The denoiser runs through
    the denoise_mlp kernels (K2, K3) on the card, on ``denoisers`` as
    :func:`rebuild_epoch` prepares them (only prepared forms: a params dict
    would be put in the kernels' layout again at every step)."""
    if not all(isinstance(p, PreparedDenoiser) for p in denoisers):
        raise TypeError("rebuild_block_tables takes prepare_denoiser forms")
    x0 = gather_rows(train_store, users, item_num)
    tables = []
    for params in denoisers:
        denoised = generate_view(
            schedule, params, x0, sampling_step, generator=generator,
            denoise_apply=denoise_forward_fused,
        )
        tables.append(topk_table(denoised, k_table))
    return tables


def rebuild_epoch(
    schedule: DiffusionSchedule,
    dn_params_list: list,
    train_store,
    bucket_blocks: tuple[torch.Tensor, ...],
    widths: tuple[int, ...],
    starts: tuple[int, ...],
    row_of_pos: torch.Tensor,
    lane_of_pos: torch.Tensor,
    pad_mask: torch.Tensor,
    item_num: int,
    sampling_step: int,
    generator: torch.Generator | None = None,
) -> list[torch.Tensor]:
    """All rebuild blocks of one epoch -> one CSR edge buffer per modality.

    ``bucket_blocks[b]`` holds bucket b's (n_blocks_b, batch) user ids, to
    take a top-``widths[b]`` per user; its rows start at ``starts[b]`` of
    the stacked table. Identity order is the single bucket ``(k_max,)``
    from row 0; degree order is the two-bucket plan of
    ``ops/topk.py::plan_rebuild_buckets``. ``row_of_pos``/``lane_of_pos``
    map each CSR position to its (row, lane) of the stacked table. Each
    denoiser's weights are put in the kernels' layout once, here, for all
    blocks and steps."""
    denoisers = [prepare_denoiser(p) for p in dn_params_list]
    n_modal = len(denoisers)
    bucket_tables = []  # [bucket][modality] -> (rows_b, k_b)
    for blocks_b, k_b in zip(bucket_blocks, widths):
        per_block = [
            rebuild_block_tables(
                schedule, denoisers, train_store, users, item_num,
                sampling_step, k_b, generator,
            )
            for users in blocks_b
        ]
        bucket_tables.append(
            [torch.cat([blk[m] for blk in per_block]) for m in range(n_modal)]
        )

    row_of_pos = row_of_pos.long()
    buffers = []
    for m in range(n_modal):
        if len(bucket_tables) == 1:
            buffers.append(
                csr_gather_build(bucket_tables[0][m], row_of_pos, lane_of_pos, pad_mask, item_num)
            )
            continue
        edges = None
        for tab_m, k_b, start in zip(bucket_tables, widths, starts):
            tab = tab_m[m]
            local_row = torch.clamp(row_of_pos - start, 0, tab.shape[0] - 1)
            # in-bucket lanes are < k_b; the clamp only covers other
            # buckets' positions, which the select masks out
            local_lane = torch.clamp_max(lane_of_pos.long(), k_b - 1)
            cand = tab[local_row, local_lane]
            edges = cand if edges is None else torch.where(row_of_pos >= start, cand, edges)
        buffers.append(torch.where(pad_mask, torch.full_like(edges, item_num), edges))
    return buffers


def gcn_forward(gcn_params, adj, modal_adjs, raw_feats, hp: dict, segsum_compute: str = "f32"):
    """Final (user, item) embeddings for eval and serving."""
    out = gcn_mm(
        gcn_params, adj, list(modal_adjs), raw_feats,
        modal_adj_weight=hp["modal_adj_weight"],
        residual_weight=hp["residual_weight"],
        segsum_compute=segsum_compute,
    )
    return out.u_final, out.i_final
