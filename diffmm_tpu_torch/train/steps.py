"""The training epoch's step functions: the diffusion training (phase 1),
the graph rebuild (phase 2), the joint GCN training (phase 3), and the GCN
forward for eval and serving.

Counterpart of ``diffmm_tpu/train/steps.py``: ``_diffusion_block`` and
``_diffusion_epoch`` (lines 171-260), ``rebuild_epoch`` (296-372),
``_cross_layer_cl``, ``_modal_cl``, ``_joint_block`` and ``_joint_epoch``
(375-484), ``gcn_forward`` (487-498). The JAX package compiles these into
scanned programs; here they are plain functions and each block loop is a
Python loop. Each training step builds its loss on detached views of the
parameters that require grad, takes the gradients with
``torch.autograd.grad`` and updates the parameters and their Adam state in
place (``train/optim.py``).

The denoiser trains through the plain ``models/denoise.py`` forward
under autograd, as the JAX package trains it through XLA and not through
its Pallas kernel (``steps.py:115-124``); K2/K3 stay the rebuild's kernels.
The joint step's propagations go through K1 (dense form) or K4 (sparse
form) in both passes (``ops/graph.py``).

Randomness is injected: every step takes its draws (diffusion timesteps
and noise, the cross-layer CL noise) as optional tensors and draws them
from a ``torch.Generator`` otherwise.
"""

from __future__ import annotations

import torch

from diffmm_tpu_torch.data.membership import gather_rows
from diffmm_tpu_torch.diffusion.gaussian import generate_view, training_losses
from diffmm_tpu_torch.diffusion.schedule import DiffusionSchedule
from diffmm_tpu_torch.models.gcn import gcn_mm, project_features
from diffmm_tpu_torch.ops.graph import spmm_bi
from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
    PreparedDenoiser,
    denoise_forward_fused,
    prepare_denoiser,
)
from diffmm_tpu_torch.ops.losses import bpr_loss, info_nce, l2_normalize, l2_reg_loss
from diffmm_tpu_torch.ops.topk import csr_gather_build, topk_table
from diffmm_tpu_torch.train.optim import AdamState, adam_update, tree_leaves, tree_map


def _trainable(params):
    """Views of ``params`` (sharing their storage) that require grad: the
    loss is built on them, and the in-place update writes the parameters."""
    return tree_map(lambda p: p.detach().requires_grad_(), params)


# ------------------------------------------------------------------ phase 1
def diffusion_block(
    schedule: DiffusionSchedule,
    dn_params_list: list,
    dn_states: list[AdamState],
    feats: list[torch.Tensor],
    i_embs: torch.Tensor,
    train_store,
    users: torch.Tensor,
    weights: torch.Tensor,
    lr: float,
    hp: dict,
    item_num: int,
    t: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """One Adam step for every modality's denoiser on one block of user
    rows (JAX ``_diffusion_block``); returns the (M,) per-modality losses.

    ``feats`` are the projected modality features and ``i_embs`` the item
    embeddings, both constants here (the JAX package stops their
    gradients). ``weights`` (B,) masks the block's pad rows: each loss is
    the weighted sum over ``max(sum(weights), 1)``. The gradient is that of
    ``sum(losses) / sum(losses)`` with the denominator detached (reference
    `Main.py:174-185`). ``t`` (M, B) and ``noise`` (M, B, I) are the
    modalities' draws."""
    x0 = gather_rows(train_store, users, item_num)
    live = [_trainable(p) for p in dn_params_list]
    w_sum = torch.clamp_min(weights.sum(), 1.0)
    with torch.enable_grad():
        losses = [
            torch.sum(training_losses(
                schedule, live[m], x0, i_embs, feats[m], hp["sim_weight"], hp["reg"],
                t=None if t is None else t[m], noise=None if noise is None else noise[m],
                generator=generator,
            ) * weights) / w_sum
            for m in range(len(live))
        ]
        total = sum(losses)
        leaves = [tree_leaves(p) for p in live]
        grads = torch.autograd.grad(total / total.detach(), [g for ls in leaves for g in ls])
    at = 0
    for params, state, ls in zip(dn_params_list, dn_states, leaves):
        adam_update(params, list(grads[at:at + len(ls)]), state, lr)
        at += len(ls)
    return torch.stack(losses).detach()


def diffusion_epoch(
    schedule: DiffusionSchedule,
    dn_params_list: list,
    dn_states: list[AdamState],
    gcn_params: dict,
    raw_feats: list[torch.Tensor],
    train_store,
    users_blocks: torch.Tensor,
    weight_blocks: torch.Tensor,
    lr: float,
    hp: dict,
    item_num: int,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """All diffusion blocks of one epoch, (n_blocks, B) users and weights;
    returns the (M,) loss accumulator with the reference's quirk
    ``acc = (acc + losses) / max(sum(losses), 1e-12)`` per block (JAX
    ``_diffusion_epoch``, line 249). The features are projected once: the
    GCN parameters do not change in this phase."""
    with torch.no_grad():
        feats = project_features(gcn_params, raw_feats)
    acc = torch.zeros(len(dn_params_list), dtype=torch.float32, device=users_blocks.device)
    for users, weights in zip(users_blocks, weight_blocks):
        losses = diffusion_block(
            schedule, dn_params_list, dn_states, feats, gcn_params["i_embs"], train_store,
            users, weights, lr, hp, item_num, generator=generator,
        )
        acc = (acc + losses) / torch.clamp_min(losses.sum(), 1e-12)
    return acc


# ------------------------------------------------------------------ phase 2
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


# ------------------------------------------------------------------ phase 3
def cross_layer_cl(id_u, id_i, adj, users, pos_items, hp: dict, compute: str = "f32",
                   noise: list[torch.Tensor] | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Three noisy propagations and the layer-0-vs-mean InfoNCE (JAX
    ``_cross_layer_cl``, reference `Main.py:314-334`). ``id_u``/``id_i``
    are the first, pre-noise propagation, reused from the GCN forward;
    layers 1 and 2 propagate again. ``noise`` holds the six uniform draws
    ``[u0, i0, u1, i1, u2, i2]`` (the order of the JAX package's six
    subkeys), each the shape of its layer's embeddings."""
    ju, ji = id_u, id_i
    acc_u = acc_i = layer0_u = layer0_i = None
    for k in range(3):
        if k > 0:
            ju, ji = spmm_bi(adj, ju, ji, compute)
        if noise is None:
            noise_u = torch.rand(ju.shape, generator=generator, device=ju.device)
            noise_i = torch.rand(ji.shape, generator=generator, device=ji.device)
        else:
            noise_u, noise_i = noise[2 * k], noise[2 * k + 1]
        ju = ju + torch.sign(ju) * l2_normalize(noise_u, dim=1) * hp["noise_degree"]
        ji = ji + torch.sign(ji) * l2_normalize(noise_i, dim=1) * hp["noise_degree"]
        if k == 0:
            acc_u, acc_i, layer0_u, layer0_i = ju, ji, ju, ji
        else:
            acc_u, acc_i = acc_u + ju, acc_i + ji
    temp = hp["cross_cl_temp"]
    return (
        info_nce(acc_u / 3.0, layer0_u, users, temp) + info_nce(acc_i / 3.0, layer0_i, pos_items, temp)
    ) * hp["cross_cl_rate"]


def modal_cl(out, users, pos_items, hp: dict, cl_method: int) -> torch.Tensor:
    """Cross-modal CL (JAX ``_modal_cl``, reference `Main.py:339-368`):
    ``cl_method == 1`` pairs the modalities with each other; any other
    value sets each modality against the final view."""
    temp, rate = hp["modal_cl_temp"], hp["modal_cl_rate"]
    n_modal = out.modal_u.shape[0]
    loss = 0.0
    if cl_method == 1:
        for a in range(n_modal):
            for b in range(a + 1, n_modal):
                loss = loss + (
                    info_nce(out.modal_u[a], out.modal_u[b], users, temp)
                    + info_nce(out.modal_i[a], out.modal_i[b], pos_items, temp)
                ) * rate
    else:
        for m in range(n_modal):
            loss = loss + (
                info_nce(out.u_final, out.modal_u[m], users, temp)
                + info_nce(out.i_final, out.modal_i[m], pos_items, temp)
            ) * rate
    return loss


def joint_block(
    gcn_params: dict,
    opt_state: AdamState,
    adj,
    modal_adjs: list,
    raw_feats: list[torch.Tensor],
    users: torch.Tensor,
    pos_items: torch.Tensor,
    neg_items: torch.Tensor,
    lr: float,
    hp: dict,
    cl_method: int,
    compute: str = "f32",
    cl_noise: list[torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """One Adam step of the main model on one block of interactions (JAX
    ``_joint_block``): the GCN forward, BPR, L2 on the ID embeddings, the
    cross-layer and the cross-modal CL. Returns the (4,) metrics
    ``[total, bpr, reg, cl]``."""
    live = _trainable(gcn_params)
    with torch.enable_grad():
        out = gcn_mm(live, adj, list(modal_adjs), raw_feats, hp["modal_adj_weight"],
                     hp["residual_weight"], compute)
        rec = bpr_loss(out.u_final.index_select(0, users), out.i_final.index_select(0, pos_items),
                       out.i_final.index_select(0, neg_items))
        reg = l2_reg_loss(hp["reg"], [live["u_embs"], live["i_embs"]])
        cl = cross_layer_cl(out.id_u, out.id_i, adj, users, pos_items, hp, compute, cl_noise, generator)
        cl = cl + modal_cl(out, users, pos_items, hp, cl_method)
        total = rec + reg + cl
        grads = torch.autograd.grad(total, tree_leaves(live))
    adam_update(gcn_params, list(grads), opt_state, lr)
    return torch.stack([total, rec, reg, cl]).detach()


def joint_epoch(
    gcn_params: dict,
    opt_state: AdamState,
    adj,
    modal_adjs: list,
    raw_feats: list[torch.Tensor],
    users_blocks: torch.Tensor,
    pos_blocks: torch.Tensor,
    neg_blocks: torch.Tensor,
    lr: float,
    hp: dict,
    cl_method: int,
    compute: str = "f32",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """All joint blocks of one epoch, (n_blocks, B) each; returns the
    summed (4,) metrics (JAX ``_joint_epoch``)."""
    acc = torch.zeros(4, dtype=torch.float32, device=users_blocks.device)
    for users, pos, neg in zip(users_blocks, pos_blocks, neg_blocks):
        acc = acc + joint_block(gcn_params, opt_state, adj, modal_adjs, raw_feats, users, pos,
                                neg, lr, hp, cl_method, compute, generator=generator)
    return acc


# --------------------------------------------------------------------- eval
def gcn_forward(gcn_params, adj, modal_adjs, raw_feats, hp: dict, segsum_compute: str = "f32"):
    """Final (user, item) embeddings for eval and serving."""
    out = gcn_mm(
        gcn_params, adj, list(modal_adjs), raw_feats,
        modal_adj_weight=hp["modal_adj_weight"],
        residual_weight=hp["residual_weight"],
        segsum_compute=segsum_compute,
    )
    return out.u_final, out.i_final
