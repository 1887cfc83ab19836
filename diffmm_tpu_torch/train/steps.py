"""The training epoch's step functions: the diffusion training (phase 1),
the graph rebuild (phase 2), the joint GCN training (phase 3), and the GCN
forward for eval and serving.

Counterpart of ``diffmm_tpu/train/steps.py``: ``_diffusion_block`` and
``_diffusion_epoch`` (lines 171-260), ``rebuild_epoch`` (296-372),
``_cross_layer_cl``, ``_modal_cl``, ``_joint_block`` and ``_joint_epoch``
(375-484), ``gcn_forward`` (487-498). The JAX package compiles these into
scanned programs; here each block loop is a Python loop over a step
function that writes its results into tensors outside it. On the card the
loops replay each step from a captured CUDA graph (``train/graphs.py``,
``graphs=`` a Coach's :class:`~diffmm_tpu_torch.train.graphs.GraphCache`);
with ``graphs=None``, and always on the CPU, they run it eagerly. Each
training step builds its loss on detached views of the parameters that
require grad, takes the gradients with ``torch.autograd.grad`` and updates
the parameters and their Adam state in place (``train/optim.py``), with
the learning rate and the bias corrections as device scalars; a phase
advances the Adam step counts by its block count.

The denoiser trains through the plain ``models/denoise.py`` forward
under autograd, as the JAX package trains it through XLA and not through
its Pallas kernel (``steps.py:115-124``); K2/K3 stay the rebuild's kernels.
The joint step's propagations go through K1 (dense form) or K4 (sparse
form) in both passes (``ops/graph.py``), and its loss gathers (BPR and
every InfoNCE) go through ``ops/gather.py``, whose backward is K4 on both
forms: no atomics anywhere in the step, so it repeats bit for bit.

Randomness is injected: every step takes its draws (diffusion timesteps
and noise, the cross-layer CL noise) as optional tensors and draws them
from a ``torch.Generator`` otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from diffmm_tpu_torch.data.membership import gather_rows
from diffmm_tpu_torch.diffusion.gaussian import generate_view, training_losses
from diffmm_tpu_torch.diffusion.schedule import DiffusionSchedule
from diffmm_tpu_torch.models.gcn import gcn_mm, project_features
from diffmm_tpu_torch.ops.gather import gather, gather_plan
from diffmm_tpu_torch.ops.graph import spmm_bi
from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
    KernelWeight,
    PreparedDenoiser,
    denoise_forward_fused,
    prepare_denoiser,
)
from diffmm_tpu_torch.ops.losses import bpr_loss, info_nce, l2_normalize, l2_reg_loss
from diffmm_tpu_torch.ops.topk import csr_gather_build, topk_table
from diffmm_tpu_torch.train.graphs import GraphCache, buffer, hold, run_step
from diffmm_tpu_torch.train.optim import AdamState, adam_scalars, adam_update, tree_leaves, tree_map


def _trainable(params):
    """Views of ``params`` (sharing their storage) that require grad: the
    loss is built on them, and the in-place update writes the parameters."""
    return tree_map(lambda p: p.detach().requires_grad_(), params)


def _hp_key(hp: dict) -> tuple:
    """The hyperparameters a captured step bakes in, as part of its key."""
    return tuple(sorted(hp.items()))


def _scalars(lr: float, states: list[AdamState], n: int, device) -> torch.Tensor:
    """(n, len(states), 3) Adam scalars of a phase's n steps, one row per
    state (``train/optim.py::adam_scalars``), in one upload (the Coach makes
    them for a whole epoch or chunk at once instead)."""
    rows = np.stack([adam_scalars(lr, s.count, n) for s in states], axis=1)
    return torch.as_tensor(rows, device=device)


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
    modalities' draws. ``lr`` is a float or an (M, 3) tensor, a row of
    :func:`~diffmm_tpu_torch.train.optim.adam_scalars` per modality (the
    caller then advances the counts)."""
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
    for m, (params, state, ls) in enumerate(zip(dn_params_list, dn_states, leaves)):
        adam_update(params, list(grads[at:at + len(ls)]), state,
                    lr[m] if isinstance(lr, torch.Tensor) else lr)
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
    graphs: GraphCache | None = None,
) -> torch.Tensor:
    """All diffusion blocks of one epoch, (n_blocks, B) users and weights;
    returns the (M,) loss accumulator with the reference's quirk
    ``acc = (acc + losses) / max(sum(losses), 1e-12)`` per block (JAX
    ``_diffusion_epoch``, line 249), which each step updates in place. The
    features are projected once: the GCN parameters do not change in this
    phase. ``lr`` is a float or the phase's (n_blocks, M, 3) Adam scalars
    (``_scalars``, made ahead by the caller). Advances each denoiser's Adam
    count by the block count."""
    dev = users_blocks.device
    n_modal, n = len(dn_params_list), users_blocks.shape[0]
    with torch.no_grad():
        feats = [hold(graphs, ("feats", m), f)
                 for m, f in enumerate(project_features(gcn_params, raw_feats))]
    acc = buffer(graphs, ("diffusion_acc",), (n_modal,), torch.float32, dev).zero_()
    scalars = lr if isinstance(lr, torch.Tensor) else _scalars(lr, dn_states, n, dev)
    i_embs = gcn_params["i_embs"]

    def step(users, weights, sc):
        losses = diffusion_block(
            schedule, dn_params_list, dn_states, feats, i_embs, train_store,
            users, weights, sc, hp, item_num, generator=generator,
        )
        acc.copy_((acc + losses) / torch.clamp_min(losses.sum(), 1e-12))

    key = ("diffusion", users_blocks.shape[1], _hp_key(hp))
    for j in range(n):
        run_step(graphs, key, step, users_blocks[j], weight_blocks[j], scalars[j])
    for state in dn_states:
        state.count += n
    return acc.clone()


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


def _hold_denoiser(graphs: GraphCache | None, m: int, p: PreparedDenoiser) -> PreparedDenoiser:
    """``p`` with its two prepared weights in buffers of ``graphs`` (its
    other fields are views of the denoiser's parameters, which stay put)."""
    if graphs is None or not isinstance(p.w1x, KernelWeight):
        return p
    return PreparedDenoiser(
        p.emb_w, p.emb_b, p.w1_time, p.b1,
        KernelWeight(graphs.hold(("w1x", m), p.w1x.data), p.w1x.k, p.w1x.n),
        KernelWeight(graphs.hold(("w2", m), p.w2.data), p.w2.k, p.w2.n), p.b2,
    )


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
    graphs: GraphCache | None = None,
) -> list[torch.Tensor]:
    """All rebuild blocks of one epoch -> one CSR edge buffer per modality.

    ``bucket_blocks[b]`` holds bucket b's (n_blocks_b, batch) user ids, to
    take a top-``widths[b]`` per user; its rows start at ``starts[b]`` of
    the stacked table. Identity order is the single bucket ``(k_max,)``
    from row 0; degree order is the two-bucket plan of
    ``ops/topk.py::plan_rebuild_buckets``. ``row_of_pos``/``lane_of_pos``
    map each CSR position to its (row, lane) of the stacked table. Each
    denoiser's weights are put in the kernels' layout once, here, for all
    blocks and steps. A step (one block of one bucket; a graph per bucket on
    the card) writes its users' tables into the bucket's rows."""
    denoisers = [_hold_denoiser(graphs, m, prepare_denoiser(p)) for m, p in enumerate(dn_params_list)]
    n_modal = len(denoisers)
    dev = row_of_pos.device
    bucket_tables = []  # [bucket][modality] -> (rows_b, k_b)
    for b, (blocks_b, k_b) in enumerate(zip(bucket_blocks, widths)):
        nb, batch = blocks_b.shape
        tables = [buffer(graphs, ("rebuild_table", b, m), (nb * batch, k_b), torch.int32, dev)
                  for m in range(n_modal)]
        rows = torch.arange(nb * batch, dtype=torch.int64, device=dev).view(nb, batch)
        inputs = torch.stack([blocks_b.long(), rows], dim=1)  # (nb, 2, batch): users, table rows

        def step(blk, tables=tables, k_b=k_b):
            out = rebuild_block_tables(schedule, denoisers, train_store, blk[0], item_num,
                                       sampling_step, k_b, generator)
            for table, o in zip(tables, out):
                table.index_copy_(0, blk[1], o)

        key = ("rebuild", b, batch, k_b, sampling_step)
        for j in range(nb):
            run_step(graphs, key, step, inputs[j])
        bucket_tables.append(tables)

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
                   generator: torch.Generator | None = None, plans=(None, None)) -> torch.Tensor:
    """Three noisy propagations and the layer-0-vs-mean InfoNCE (JAX
    ``_cross_layer_cl``, reference `Main.py:314-334`). ``id_u``/``id_i``
    are the first, pre-noise propagation, reused from the GCN forward;
    layers 1 and 2 propagate again. ``noise`` holds the six uniform draws
    ``[u0, i0, u1, i1, u2, i2]`` (the order of the JAX package's six
    subkeys), each the shape of its layer's embeddings. ``plans`` holds the
    ``gather_plan`` of the users and of the items (made per gather if None)."""
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
        info_nce(acc_u / 3.0, layer0_u, users, temp, plans[0])
        + info_nce(acc_i / 3.0, layer0_i, pos_items, temp, plans[1])
    ) * hp["cross_cl_rate"]


def modal_cl(out, users, pos_items, hp: dict, cl_method: int, plans=(None, None)) -> torch.Tensor:
    """Cross-modal CL (JAX ``_modal_cl``, reference `Main.py:339-368`):
    ``cl_method == 1`` pairs the modalities with each other; any other
    value sets each modality against the final view. ``plans`` as in
    :func:`cross_layer_cl`."""
    temp, rate = hp["modal_cl_temp"], hp["modal_cl_rate"]
    n_modal = out.modal_u.shape[0]
    loss = 0.0
    if cl_method == 1:
        for a in range(n_modal):
            for b in range(a + 1, n_modal):
                loss = loss + (
                    info_nce(out.modal_u[a], out.modal_u[b], users, temp, plans[0])
                    + info_nce(out.modal_i[a], out.modal_i[b], pos_items, temp, plans[1])
                ) * rate
    else:
        for m in range(n_modal):
            loss = loss + (
                info_nce(out.u_final, out.modal_u[m], users, temp, plans[0])
                + info_nce(out.i_final, out.modal_i[m], pos_items, temp, plans[1])
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
    ``[total, bpr, reg, cl]``. Every row gather of the losses goes through
    ``ops/gather.py`` (backward: K4), with one sort a block's users, positive
    and negative items, shared by all the gathers of each. ``lr`` is a
    float or a (3,) row of ``adam_scalars``, as ``adam_update`` takes it."""
    live = _trainable(gcn_params)
    n_users, n_items = gcn_params["u_embs"].shape[0], gcn_params["i_embs"].shape[0]
    plans = (gather_plan(users, n_users), gather_plan(pos_items, n_items))
    with torch.enable_grad():
        out = gcn_mm(live, adj, list(modal_adjs), raw_feats, hp["modal_adj_weight"],
                     hp["residual_weight"], compute)
        rec = bpr_loss(gather(out.u_final, users, plans[0]), gather(out.i_final, pos_items, plans[1]),
                       gather(out.i_final, neg_items, gather_plan(neg_items, n_items)))
        reg = l2_reg_loss(hp["reg"], [live["u_embs"], live["i_embs"]])
        cl = cross_layer_cl(out.id_u, out.id_i, adj, users, pos_items, hp, compute, cl_noise, generator,
                            plans)
        cl = cl + modal_cl(out, users, pos_items, hp, cl_method, plans)
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
    graphs: GraphCache | None = None,
) -> torch.Tensor:
    """All joint blocks of one epoch, (n_blocks, B) each; returns the
    summed (4,) metrics (JAX ``_joint_epoch``), which each step adds in
    place. ``lr`` is a float or the phase's (n_blocks, 3) Adam scalars.
    Advances the Adam count by the block count."""
    dev = users_blocks.device
    n = users_blocks.shape[0]
    blocks = torch.stack([users_blocks, pos_blocks, neg_blocks], dim=1)  # (n, 3, B)
    scalars = lr if isinstance(lr, torch.Tensor) else _scalars(lr, [opt_state], n, dev)[:, 0]
    acc = buffer(graphs, ("joint_acc",), (4,), torch.float32, dev).zero_()

    def step(blk, sc):
        acc.add_(joint_block(gcn_params, opt_state, adj, modal_adjs, raw_feats, blk[0], blk[1],
                             blk[2], sc, hp, cl_method, compute, generator=generator))

    key = ("joint", blocks.shape[2], cl_method, compute, _hp_key(hp))
    for j in range(n):
        run_step(graphs, key, step, blocks[j], scalars[j])
    opt_state.count += n
    return acc.clone()


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
