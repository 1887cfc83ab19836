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

On a mesh (``split``, this rank's
:class:`~diffmm_tpu_torch.parallel.sharding.Split`; None on one device)
every step computes the JAX mesh's function, which is the single-device one
(``tests/test_parallel.py:58-79``). Each rank's loss is its share of the
step's one loss, and so are its gradients:

* a diffusion block's rows go over ``split.rows`` and, where the model
  axis cuts the catalog, its catalog columns over the model axis: the
  rank's x0 (from its columns of the dense train store, which holds no
  others), noise and denoiser shards, the catalog products summed over
  the axis before anything nonlinear (``models/denoise.py``), the row
  losses the rank's columns' shares (``diffusion/gaussian.py``);
* a joint block's rows go over the world (``split.world``): the step
  first gathers ``i_embs`` whole over the model axis
  (:class:`~diffmm_tpu_torch.parallel.collectives.AllGatherRows`, whose
  backward returns each rank's rows of the summed cotangent), and the GCN's
  outputs are then whole on every rank (K1's and K4's mesh forms,
  ``ops/graph.py``); the L2 term is counted on rank 0;
* the gradients are summed once a step: a replicated parameter's over the
  world, a cut one's over ``split.rows``
  (:func:`~diffmm_tpu_torch.parallel.sharding.reduce_grads`), and every
  rank updates its own slices with Adam.

Every random draw is made whole on every rank from the same generator
state, and each rank takes its rows and columns of it, so a rank draws
what the one-device run draws. The rebuild's ranks run K2's partial
product on their catalog columns, sum it over the model axis, run K3 on
their columns, merge their top-k candidates over the model axis
(``ops/topk.py::catalog_topk``) and assemble their rows of the top-k
tables with a placed int32 all-reduce over ``split.rows``.

One device runs the same steps with no collective (the sums over one part
are the parts; its rebuild takes K2's tanh in the kernel's epilogue, the
same f32 add and ``tanhf``), so that a mesh of one rank computes what one
device does, bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from diffmm_tpu_torch.data.membership import gather_rows
from diffmm_tpu_torch.diffusion.gaussian import generate_view, training_losses
from diffmm_tpu_torch.diffusion.schedule import DiffusionSchedule
from diffmm_tpu_torch.models.denoise import denoise_forward
from diffmm_tpu_torch.models.gcn import gcn_mm, project_features
from diffmm_tpu_torch.ops.gather import gather, gather_plan
from diffmm_tpu_torch.ops.graph import spmm_bi
from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
    KernelWeight,
    PreparedDenoiser,
    denoise_forward_fused,
    prepare_denoiser,
)
from diffmm_tpu_torch.ops.losses import RowSlice, bpr_loss, info_nce, l2_normalize, l2_reg_loss
from diffmm_tpu_torch.ops.topk import catalog_topk, csr_gather_build
from diffmm_tpu_torch.parallel.collectives import AllGatherRows, all_reduce_sum_
from diffmm_tpu_torch.parallel.sharding import REPLICATED, ROWS, reduce_grads
from diffmm_tpu_torch.train.graphs import GraphCache, buffer, hold, run_step
from diffmm_tpu_torch.train.optim import AdamState, adam_scalars, adam_update, tree_leaves, tree_map
from diffmm_tpu_torch.utils.profiling import StepParts


# the parts that tile a diffusion and a joint step (utils/profiling.py): each
# phase's span takes its last block's, in device seconds
DIFFUSION_PARTS = StepParts("diffusion", ("forward", "backward", "adam"))
JOINT_PARTS = StepParts("joint", ("forward", "loss", "backward", "adam"))


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


def _cols(split, item_num: int) -> tuple[int, int]:
    """The rank's catalog range (the whole catalog on one device)."""
    return (0, item_num) if split is None else (split.lo, split.hi)


def _group(split):
    """The model axis's group where it cuts the catalog, else None."""
    return None if split is None or split.cat is None else split.cat.group


def local_leaf(leaf: torch.Tensor, place: str, split, dim: int = 0) -> torch.Tensor:
    """The rank's catalog part of a catalog-wide leaf whose catalog runs
    along ``dim``, differentiable: the leaf itself where it is stored cut
    (or there is no split), else its catalog range (along dim 0 keeping any
    rows past the catalog)."""
    if split is None or place != REPLICATED or (split.lo, split.hi) == (0, split.item_num):
        return leaf
    if dim == 1:
        return leaf[:, split.lo:split.hi]
    if leaf.shape[0] == split.item_num:
        return leaf[split.lo:split.hi]
    return torch.cat([leaf[split.lo:split.hi], leaf[split.item_num:]])


def local_denoiser(params: dict, split) -> dict:
    """A denoiser's tree with its catalog-wide layers (the first in-layer's
    x rows, the last out-layer) as the rank's catalog part
    (:func:`local_leaf`); identity on one device."""
    if split is None:
        return params
    first, last = params["in_layers"][0], params["out_layers"][-1]
    place = split.dn_place
    return {
        **params,
        "in_layers": [{**first, "w": local_leaf(first["w"], place["in_layers"][0]["w"], split)},
                      *params["in_layers"][1:]],
        "out_layers": [*params["out_layers"][:-1],
                       {"w": local_leaf(last["w"], place["out_layers"][-1]["w"], split, dim=1),
                        "b": local_leaf(last["b"], place["out_layers"][-1]["b"], split)}],
    }


def whole_gcn(gcn_params: dict, split) -> dict:
    """The GCN parameters with ``i_embs`` whole: gathered over the model
    axis where it is cut (:class:`AllGatherRows`: its backward gives each
    rank its rows of the summed cotangent); as they are otherwise."""
    if split is None or split.gcn_place["i_embs"] != ROWS:
        return gcn_params
    i_embs = AllGatherRows.apply(gcn_params["i_embs"], split.lo, split.item_num, split.cat.group)
    return {**gcn_params, "i_embs": i_embs}


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
    split=None,
) -> torch.Tensor:
    """One Adam step for every modality's denoiser on one block of user
    rows (JAX ``_diffusion_block``); returns the (M,) per-modality losses.

    ``feats`` are the projected modality features and ``i_embs`` the item
    embeddings (as stored: on a model axis the rank's rows), both
    constants here (the JAX package stops their gradients). ``weights``
    (B,) masks the block's pad rows: each loss is the weighted sum over
    ``max(sum(weights), 1)``. The gradient is that of ``sum(losses) /
    sum(losses)`` with the denominator detached (reference
    `Main.py:174-185`). ``t`` (M, B) and ``noise`` (M, B, I) are the
    modalities' draws. ``lr`` is a float or an (M, 3) tensor, a row of
    :func:`~diffmm_tpu_torch.train.optim.adam_scalars` per modality (the
    caller then advances the counts).

    ``split``: a mesh. The step takes the rank's rows (``split.rows``) and
    catalog columns of the block and of its draws (drawn whole here when
    not given, in the order ``training_losses`` draws them: each modality's
    timesteps, then its noise), the weights' sum over the whole block, the
    (M,) losses as the ranks' shares summed over the world (one all-reduce)
    for the loss and the gradient's denominator; then the gradients'
    all-reduces."""
    n_modal = len(dn_params_list)
    w_sum = torch.clamp_min(weights.sum(), 1.0)
    lo, hi = _cols(split, item_num)
    group = _group(split)
    own_sim = split is None or split.cat is None or split.cat.index == 0
    if split is not None:
        a, b = split.rows.span(users.shape[0])
        if t is None or noise is None:
            draws = [(torch.randint(0, schedule.steps, (users.shape[0],), generator=generator,
                                    device=users.device),
                      torch.randn((users.shape[0], item_num), generator=generator, device=users.device))
                     for _ in range(n_modal)]
            t, noise = (torch.stack(d) for d in zip(*draws))
        users, weights, t, noise = users[a:b], weights[a:b], t[:, a:b], noise[:, a:b, lo:hi]
    x0 = gather_rows(train_store, users, item_num, (lo, hi))
    i_embs = i_embs if split is None else local_leaf(i_embs, split.gcn_place["i_embs"], split)
    live = [_trainable(p) for p in dn_params_list]
    with torch.enable_grad():
        losses = [
            torch.sum(training_losses(
                schedule, local_denoiser(live[m], split), x0, i_embs, feats[m][lo:hi], hp["sim_weight"],
                hp["reg"], t=None if t is None else t[m], noise=None if noise is None else noise[m],
                generator=generator, item_num=item_num, group=group, own_sim=own_sim,
            ) * weights) / w_sum
            for m in range(n_modal)
        ]
        total = sum(losses)
        if split is None:
            whole = torch.stack(losses).detach()
            denom = total.detach()
        else:
            whole = all_reduce_sum_(torch.stack(losses).detach(), split.world.group)
            denom = sum(whole.unbind())
        leaves = [tree_leaves(p) for p in live]
        DIFFUSION_PARTS.mark(1, users.device)
        grads = torch.autograd.grad(total / denom, [g for ls in leaves for g in ls])
    grads = reduce_grads(grads, None if split is None else [split.dn_place] * n_modal, split)
    DIFFUSION_PARTS.mark(2, users.device)
    at = 0
    for m, (params, state, ls) in enumerate(zip(dn_params_list, dn_states, leaves)):
        adam_update(params, list(grads[at:at + len(ls)]), state,
                    lr[m] if isinstance(lr, torch.Tensor) else lr)
        at += len(ls)
    return whole


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
    split=None,
) -> torch.Tensor:
    """All diffusion blocks of one epoch, (n_blocks, B) users and weights;
    returns the (M,) loss accumulator with the reference's quirk
    ``acc = (acc + losses) / max(sum(losses), 1e-12)`` per block (JAX
    ``_diffusion_epoch``, line 249), which each step updates in place. The
    features are projected once: the GCN parameters do not change in this
    phase. ``lr`` is a float or the phase's (n_blocks, M, 3) Adam scalars
    (``_scalars``, made ahead by the caller). Advances each denoiser's Adam
    count by the block count. ``split``: as :func:`diffusion_block` (every
    rank's accumulator is the global one)."""
    dev = users_blocks.device
    n_modal, n = len(dn_params_list), users_blocks.shape[0]
    with torch.no_grad():
        feats = [hold(graphs, ("feats", m), f)
                 for m, f in enumerate(project_features(gcn_params, raw_feats))]
    acc = buffer(graphs, ("diffusion_acc",), (n_modal,), torch.float32, dev).zero_()
    scalars = lr if isinstance(lr, torch.Tensor) else _scalars(lr, dn_states, n, dev)
    i_embs = gcn_params["i_embs"]

    def step(users, weights, sc):
        DIFFUSION_PARTS.mark(0, dev)
        losses = diffusion_block(
            schedule, dn_params_list, dn_states, feats, i_embs, train_store,
            users, weights, sc, hp, item_num, generator=generator, split=split,
        )
        acc.copy_((acc + losses) / torch.clamp_min(losses.sum(), 1e-12))
        DIFFUSION_PARTS.mark(3, dev)

    DIFFUSION_PARTS.claim(dev)
    key = ("diffusion", users_blocks.shape[1], _hp_key(hp))
    for j in range(n):
        run_step(graphs, key, step, users_blocks[j], weight_blocks[j], scalars[j])
    for state in dn_states:
        state.count += n
    return acc.clone()


# ------------------------------------------------------------------ phase 2
def rebuild_block_tables(
    schedule: DiffusionSchedule,
    denoisers: list,
    train_store,
    users: torch.Tensor,
    item_num: int,
    sampling_step: int,
    k_table: int,
    generator: torch.Generator | None = None,
    denoise_apply=denoise_forward_fused,
    split=None,
) -> list[torch.Tensor]:
    """Reverse-diffuse a user block per modality -> value-sorted (B,
    k_table) top-index tables, one per modality, with ``denoise_apply`` on
    ``denoisers`` as :func:`rebuild_forward` makes them. The default runs
    the denoise_mlp kernels (K2, K3) on the card, on prepared forms only (a
    params dict would be put in the kernels' layout again at every step).

    ``split``: a mesh. The rank takes its rows (``split.rows``) and its
    catalog columns of the block (the denoisers are then its shards); each
    modality's noise is drawn for the whole block, as on one device, and
    normalised over whole rows; each table is the top-k over the whole
    catalog of the rank's rows (:func:`~diffmm_tpu_torch.ops.topk.
    catalog_topk`, merged over the model axis)."""
    fused = denoise_apply is denoise_forward_fused or getattr(denoise_apply, "func", None) is denoise_forward_fused
    if fused and not all(isinstance(p, PreparedDenoiser) for p in denoisers):
        raise TypeError("rebuild_block_tables runs K2/K3 on prepare_denoiser forms only")
    batch = users.shape[0]
    lo, hi = _cols(split, item_num)
    a, b = (0, batch) if split is None else split.rows.span(batch)
    x0 = gather_rows(train_store, users[a:b], item_num, (lo, hi))
    tables = []
    for params in denoisers:
        raw = None
        if sampling_step > 0:
            raw = torch.randn((batch, item_num), generator=generator, device=x0.device, dtype=x0.dtype)[a:b]
        denoised = generate_view(
            schedule, params, x0, sampling_step, generator=generator, noise=raw,
            denoise_apply=denoise_apply, cols=(lo, hi),
        )
        tables.append(catalog_topk(denoised, k_table, lo, None if split is None else split.cat).to(torch.int32))
    return tables


def _hold_tree(graphs: GraphCache | None, key: tuple, tree):
    """``tree`` with each tensor in a buffer of ``graphs`` (what a captured
    rebuild reads keeps its address from rebuild to rebuild)."""
    leaves = iter(range(len(tree_leaves(tree))))
    return tree_map(lambda a: hold(graphs, (*key, next(leaves)), a), tree)


def _bf16_apply(params, x_t: torch.Tensor, t: torch.Tensor, group=None) -> torch.Tensor:
    """The plain forward with bf16 products, back in f32 (JAX
    ``rebuild_apply`` under ``train.rebuild_compute="bf16"``)."""
    return denoise_forward(params, x_t, t, compute_dtype=torch.bfloat16, group=group).to(torch.float32)


def _on_axis(apply, split):
    """``apply`` with the model axis's group bound, where there is one."""
    group = _group(split)
    return apply if split is None else functools.partial(apply, group=group)


def rebuild_forward(dn_params_list: list, compute: str = "f32", graphs: GraphCache | None = None,
                    split=None):
    """The rebuild's denoisers and forward, chosen as the JAX package
    chooses them (``diffmm_tpu/train/steps.py:115-168``), put in their form
    once per rebuild: ``(denoisers, denoise_apply)``. On a mesh
    (``split``) the denoisers are the rank's catalog shards and the forward
    sums its catalog products over the model axis.

    * ``compute="bf16"`` (``train.rebuild_compute``, its spelling checked
      by ``config.check_slice_support``): the plain forward in bf16 (f32 accumulation on
      the card), on the parameters cast to bf16 once, into buffers of
      ``graphs``; its output cast back to f32. No kernel: the JAX package
      runs its XLA forward here too.
    * f32 and one hidden layer: K2/K3 on :func:`prepare_denoiser` forms
      (bf16 parameters widened to f32 first: exact, and the function the
      JAX forward computes on them).
    * f32 and more hidden layers: the plain f32 forward (TF32 off) on the
      parameters as they are; K2/K3 take one hidden layer, and the JAX
      package runs its XLA forward there too."""
    dn_params_list = [local_denoiser(p, split) for p in dn_params_list]
    if compute == "bf16":
        cast = [_hold_tree(graphs, ("rebuild_bf16", m), tree_map(lambda a: a.to(torch.bfloat16), p))
                for m, p in enumerate(dn_params_list)]
        return cast, _on_axis(_bf16_apply, split)
    if any(len(p["in_layers"]) != 1 or len(p["out_layers"]) != 1 for p in dn_params_list):
        if split is not None:  # a local part may be a new tensor: held where a graph reads it
            dn_params_list = [_hold_tree(graphs, ("rebuild_local", m), p) for m, p in enumerate(dn_params_list)]
        return dn_params_list, _on_axis(denoise_forward, split)
    wide = [tree_map(lambda a: a.to(torch.float32), p) for p in dn_params_list]
    return ([_hold_denoiser(graphs, m, prepare_denoiser(p)) for m, p in enumerate(wide)],
            _on_axis(denoise_forward_fused, split))


def _hold_denoiser(graphs: GraphCache | None, m: int, p: PreparedDenoiser) -> PreparedDenoiser:
    """``p`` with its tensors in buffers of ``graphs`` (for f32 parameters
    the small ones are views of them, which stay put anyway; widened bf16
    parameters are new tensors at every rebuild)."""
    if graphs is None or not isinstance(p.w1x, KernelWeight):
        return p
    small = [graphs.hold(("denoiser", m, j), t)
             for j, t in enumerate((p.emb_w, p.emb_b, p.w1_time, p.b1, p.b2))]
    return PreparedDenoiser(
        *small[:4],
        KernelWeight(graphs.hold(("w1x", m), p.w1x.data), p.w1x.k, p.w1x.n),
        KernelWeight(graphs.hold(("w2", m), p.w2.data), p.w2.k, p.w2.n), small[4],
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
    compute: str = "f32",
    split=None,
) -> list[torch.Tensor]:
    """All rebuild blocks of one epoch -> one CSR edge buffer per modality.

    ``bucket_blocks[b]`` holds bucket b's (n_blocks_b, batch) user ids, to
    take a top-``widths[b]`` per user; its rows start at ``starts[b]`` of
    the stacked table. Identity order is the single bucket ``(k_max,)``
    from row 0; degree order is the two-bucket plan of
    ``ops/topk.py::plan_rebuild_buckets``. ``row_of_pos``/``lane_of_pos``
    map each CSR position to its (row, lane) of the stacked table. The
    denoisers are put in the form their forward takes once, here, for all
    blocks and steps (:func:`rebuild_forward`, ``compute`` is
    ``train.rebuild_compute``). A step (one block of one bucket; a graph per
    bucket on the card) writes its users' tables into the bucket's rows.

    ``split``: a mesh. Each rank runs K2/K3 on its rows and catalog
    columns of every block (its part of each block's noise drawn as the
    whole) and the merged top-k (:func:`rebuild_block_tables`) into zeroed
    tables, and one placed int32 all-reduce a table over ``split.rows``
    assembles them (JAX ``coach.py:858-859``): every rank then builds the
    same edge buffers."""
    denoisers, apply = rebuild_forward(dn_params_list, compute, graphs, split)
    n_modal = len(denoisers)
    dev = row_of_pos.device
    bucket_tables = []  # [bucket][modality] -> (rows_b, k_b)
    for b, (blocks_b, k_b) in enumerate(zip(bucket_blocks, widths)):
        nb, batch = blocks_b.shape
        tables = [buffer(graphs, ("rebuild_table", b, m), (nb * batch, k_b), torch.int32, dev)
                  for m in range(n_modal)]
        rows = torch.arange(nb * batch, dtype=torch.int64, device=dev).view(nb, batch)
        inputs = torch.stack([blocks_b.long(), rows], dim=1)  # (nb, 2, batch): users, table rows
        own = (0, batch) if split is None else split.rows.span(batch)
        if split is not None:
            for table in tables:
                table.zero_()

        def step(blk, tables=tables, k_b=k_b, own=own):
            out = rebuild_block_tables(schedule, denoisers, train_store, blk[0], item_num,
                                       sampling_step, k_b, generator, apply, split)
            at = blk[1, own[0]:own[1]]
            for table, o in zip(tables, out):
                table.index_copy_(0, at, o)

        key = ("rebuild", b, batch, k_b, sampling_step, compute)
        for j in range(nb):
            run_step(graphs, key, step, inputs[j])
        if split is not None:
            for table in tables:
                all_reduce_sum_(table, split.rows.group)
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
                   generator: torch.Generator | None = None, plans=(None, None),
                   own=(None, None)) -> torch.Tensor:
    """Three noisy propagations and the layer-0-vs-mean InfoNCE (JAX
    ``_cross_layer_cl``, reference `Main.py:314-334`). ``id_u``/``id_i``
    are the first, pre-noise propagation, reused from the GCN forward;
    layers 1 and 2 propagate again. ``noise`` holds the six uniform draws
    ``[u0, i0, u1, i1, u2, i2]`` (the order of the JAX package's six
    subkeys), each the shape of its layer's embeddings. ``plans`` holds the
    ``gather_plan`` of the users and of the items (made per gather if None);
    ``own`` a rank's :class:`~diffmm_tpu_torch.ops.losses.RowSlice` of each
    on a mesh's data axis (``info_nce``)."""
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
        info_nce(acc_u / 3.0, layer0_u, users, temp, plans[0], own[0])
        + info_nce(acc_i / 3.0, layer0_i, pos_items, temp, plans[1], own[1])
    ) * hp["cross_cl_rate"]


def modal_cl(out, users, pos_items, hp: dict, cl_method: int, plans=(None, None),
             own=(None, None)) -> torch.Tensor:
    """Cross-modal CL (JAX ``_modal_cl``, reference `Main.py:339-368`):
    ``cl_method == 1`` pairs the modalities with each other; any other
    value sets each modality against the final view. ``plans`` and ``own``
    as in :func:`cross_layer_cl`."""
    temp, rate = hp["modal_cl_temp"], hp["modal_cl_rate"]
    n_modal = out.modal_u.shape[0]
    loss = 0.0
    if cl_method == 1:
        for a in range(n_modal):
            for b in range(a + 1, n_modal):
                loss = loss + (
                    info_nce(out.modal_u[a], out.modal_u[b], users, temp, plans[0], own[0])
                    + info_nce(out.modal_i[a], out.modal_i[b], pos_items, temp, plans[1], own[1])
                ) * rate
    else:
        for m in range(n_modal):
            loss = loss + (
                info_nce(out.u_final, out.modal_u[m], users, temp, plans[0], own[0])
                + info_nce(out.i_final, out.modal_i[m], pos_items, temp, plans[1], own[1])
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
    split=None,
) -> torch.Tensor:
    """One Adam step of the main model on one block of interactions (JAX
    ``_joint_block``): the GCN forward, BPR, L2 on the ID embeddings, the
    cross-layer and the cross-modal CL. Returns the (4,) metrics
    ``[total, bpr, reg, cl]``. Every row gather of the losses goes through
    ``ops/gather.py`` (backward: K4), with one sort a block's users, positive
    and negative items, shared by all the gathers of each. ``lr`` is a
    float or a (3,) row of ``adam_scalars``, as ``adam_update`` takes it.

    ``split``: a mesh. ``i_embs`` gathered whole (:func:`whole_gcn`); the
    rank's BPR rows and its rows of each InfoNCE over the world, all as
    parts of the block's means; the L2 term on rank 0; the gradients summed
    (:func:`~diffmm_tpu_torch.parallel.sharding.reduce_grads`). The metrics
    are the rank's parts (``joint_epoch`` sums them over the world once an
    epoch)."""
    live = _trainable(gcn_params)
    n_users = gcn_params["u_embs"].shape[0]
    own, total_rows = (None, None), None
    with torch.enable_grad():
        whole = whole_gcn(live, split)
        n_items = whole["i_embs"].shape[0]
        plans = (gather_plan(users, n_users), gather_plan(pos_items, n_items))
        bpr_rows, bpr_plans = (users, pos_items, neg_items), plans
        if split is not None:
            lo, hi = split.world.span(users.shape[0])
            total_rows = users.shape[0]
            bpr_rows = (users[lo:hi], pos_items[lo:hi], neg_items[lo:hi])
            own = (RowSlice(lo, hi, total_rows, gather_plan(bpr_rows[0], n_users)),
                   RowSlice(lo, hi, total_rows, gather_plan(bpr_rows[1], n_items)))
            bpr_plans = (own[0].plan, own[1].plan)
        out = gcn_mm(whole, adj, list(modal_adjs), raw_feats, hp["modal_adj_weight"],
                     hp["residual_weight"], compute)
        JOINT_PARTS.mark(1, users.device)
        rec = bpr_loss(gather(out.u_final, bpr_rows[0], bpr_plans[0]),
                       gather(out.i_final, bpr_rows[1], bpr_plans[1]),
                       gather(out.i_final, bpr_rows[2], gather_plan(bpr_rows[2], n_items)), total_rows)
        if split is None or split.world.index == 0:
            reg = l2_reg_loss(hp["reg"], [whole["u_embs"], whole["i_embs"]])
        else:
            reg = torch.zeros((), device=rec.device)
        cl = cross_layer_cl(out.id_u, out.id_i, adj, users, pos_items, hp, compute, cl_noise, generator,
                            plans, own)
        cl = cl + modal_cl(out, users, pos_items, hp, cl_method, plans, own)
        total = rec + reg + cl
        JOINT_PARTS.mark(2, users.device)
        grads = torch.autograd.grad(total, tree_leaves(live))
    grads = reduce_grads(grads, None if split is None else split.gcn_place, split)
    JOINT_PARTS.mark(3, users.device)
    adam_update(gcn_params, grads, opt_state, lr)
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
    split=None,
) -> torch.Tensor:
    """All joint blocks of one epoch, (n_blocks, B) each; returns the
    summed (4,) metrics (JAX ``_joint_epoch``), which each step adds in
    place. ``lr`` is a float or the phase's (n_blocks, 3) Adam scalars.
    Advances the Adam count by the block count. ``split``: a mesh
    (:func:`joint_block`); the ranks' sums are added once, at the end."""
    dev = users_blocks.device
    n = users_blocks.shape[0]
    blocks = torch.stack([users_blocks, pos_blocks, neg_blocks], dim=1)  # (n, 3, B)
    scalars = lr if isinstance(lr, torch.Tensor) else _scalars(lr, [opt_state], n, dev)[:, 0]
    acc = buffer(graphs, ("joint_acc",), (4,), torch.float32, dev).zero_()

    def step(blk, sc):
        JOINT_PARTS.mark(0, dev)
        acc.add_(joint_block(gcn_params, opt_state, adj, modal_adjs, raw_feats, blk[0], blk[1],
                             blk[2], sc, hp, cl_method, compute, generator=generator, split=split))
        JOINT_PARTS.mark(4, dev)

    JOINT_PARTS.claim(dev)
    key = ("joint", blocks.shape[2], cl_method, compute, _hp_key(hp))
    for j in range(n):
        run_step(graphs, key, step, blocks[j], scalars[j])
    opt_state.count += n
    if split is not None:
        all_reduce_sum_(acc, split.world.group)
    return acc.clone()


# --------------------------------------------------------------------- eval
def gcn_forward(gcn_params, adj, modal_adjs, raw_feats, hp: dict, segsum_compute: str = "f32",
                split=None):
    """Final (user, item) embeddings for eval and serving, whole on every
    rank of a mesh (``split``: ``i_embs`` gathered first)."""
    out = gcn_mm(
        whole_gcn(gcn_params, split), adj, list(modal_adjs), raw_feats,
        modal_adj_weight=hp["modal_adj_weight"],
        residual_weight=hp["residual_weight"],
        segsum_compute=segsum_compute,
    )
    return out.u_final, out.i_final
