"""Bipartite-graph propagation, dense and sparse forms.

Counterpart of ``diffmm_tpu/ops/graph.py``: the symmetric-normalised
bipartite adjacency ``D^-1/2 (A + I) D^-1/2`` over the (user, item) nodes
(reference `DataHandler.py:68-93`) with the self-loop folded analytically,
``y = s * (A (s * x)) + s^2 * x``. The 0/1 block A is held either

* dense (:class:`DenseBiAdj`): a (U, I) int8, bf16 or packed int4 matrix; both
  propagation directions go through the ``spmm_dual`` kernel (K1) on the
  card, with bf16 operands and f32 accumulation as in the JAX package; or
* sparse (:class:`BiAdj`): the edges sorted user-major plus a permutation
  to item-major order; each direction sums, per segment of ascending ids,
  the rows its edges name, in one launch of the gather-fused ``segsum``
  kernel (K4) on the card, in f32 (or from a bf16 table,
  ``compute="bf16"``). Nothing of size O(U·I), and no per-edge message
  tensor, exists in this form. On a mesh (``BiAdj.shard``) each rank sums
  its own range of the edges in either order and the ranks' partials are
  added (K4's mesh forms, ``parallel/segsum.py``; the JAX package's
  ``sharded_sorted_segment_sum`` and ``sharded_ranked_segment_sum``).

Both forms differentiate through their kernels: K1's backward is
:class:`~diffmm_tpu_torch.ops.kernels.spmm_dual.SpmmDual`, and the sparse
form's three ``torch.autograd.Function``\\ s (:class:`Propagate`,
:class:`StackedUserPropagate`, :class:`MultiItemPropagate`) run each
backward as K4 reductions in the opposite edge order, never through
autograd of ``index_select`` (whose backward scatters with atomics and
would not launch K4).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from diffmm_tpu_torch.ops.kernels.segsum import segment_offsets, segsum_gather
from diffmm_tpu_torch.ops.kernels.spmm_dual import SpmmDual, dense_storage, spmm_dual
from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_
from diffmm_tpu_torch.parallel.segsum import slice_segsum_gather


class DenseBiAdj(NamedTuple):
    """The normalised bipartite operator in dense form.

    Attributes:
      mat: (U, I) 0/1 interaction matrix (no normalisation folded in),
        stored int8 or bf16, or packed int4 as (U, ceil(I / 2)) uint8
        (``train.dense_store``; ``ops/kernels/spmm_dual.py`` gives the
        nibble order).
      s_user: (U,) f32 ``(deg_u + 1)^-1/2``.
      s_item: (I,) f32 ``(deg_i + 1)^-1/2``.
      shard: None on one device; on a mesh's data axis, this rank's
        :class:`~diffmm_tpu_torch.parallel.sharding.Shard`: the blocks stay
        whole on every rank, and the backward keeps the rank's rows of the
        gradients (:class:`MeshSpmmDual`).
    """

    mat: torch.Tensor
    s_user: torch.Tensor
    s_item: torch.Tensor
    shard: object = None

    @property
    def user_num(self) -> int:
        return self.s_user.shape[0]

    @property
    def item_num(self) -> int:
        return self.s_item.shape[0]


class BiAdj(NamedTuple):
    """The normalised bipartite operator in sparse form: the JAX package's
    fields, with per-direction CSR offsets in place of its ``rank_aux``.

    Attributes:
      ui_rows: (nnz,) int32 user per edge, ascending; sentinel pads
        ``(user_num, item_num)`` sit at the tail.
      ui_cols: (nnz,) int32 item per edge.
      iu_perm: (nnz,) int32 stable permutation with ``ui_cols[iu_perm]``
        ascending (the item-major order of the same edges).
      s_user: (U,) f32 ``(deg_u + 1)^-1/2``.
      s_item: (I,) f32 ``(deg_i + 1)^-1/2``.
      iu_inv: (nnz,) int32 inverse of ``iu_perm`` (the backward's order).
      iu_rows: (nnz,) int32 ``ui_cols[iu_perm]``, the item-major segment ids.
      iu_cols: (nnz,) int32 ``ui_rows[iu_perm]``, the user per item-major edge.
      ui_offsets: (U + 1,) int64 CSR offsets of ``ui_rows``.
      iu_offsets: (I + 1,) int64 CSR offsets of ``iu_rows``.
      shard: None on one device; on a mesh, this rank's
        :class:`~diffmm_tpu_torch.parallel.sharding.Shard` of the edges
        (``parallel/sharding.py::edge_shard``): its ``span(nnz)`` is the
        range of positions the rank sums, in the user-major order and in
        the item-major order alike (the JAX package shards ``ui_rows``,
        ``ui_cols`` and ``iu_perm`` over the same axes).

    The item-major pair and both offsets are fixed per build, so they are
    made once there (the JAX package recomputes the pair per call inside its
    compiled program and hoists ``rank_aux`` the same way).
    """

    ui_rows: torch.Tensor
    ui_cols: torch.Tensor
    iu_perm: torch.Tensor
    s_user: torch.Tensor
    s_item: torch.Tensor
    iu_inv: torch.Tensor
    iu_rows: torch.Tensor
    iu_cols: torch.Tensor
    ui_offsets: torch.Tensor
    iu_offsets: torch.Tensor
    shard: object = None

    @property
    def user_num(self) -> int:
        return self.s_user.shape[0]

    @property
    def item_num(self) -> int:
        return self.s_item.shape[0]


def build_dense_bi_adj_device(
    ui_rows: torch.Tensor,
    ui_cols: torch.Tensor,
    user_num: int,
    item_num: int,
    store_dtype: torch.dtype = torch.int8,
    out: DenseBiAdj | None = None,
) -> DenseBiAdj:
    """Dense-form adjacency from (possibly sentinel-padded) device edges,
    into ``out`` in place when given (a captured graph that reads ``out``
    then reads the new graph). ``store_dtype`` int8, bf16, or uint8 for
    packed int4 (``ops/kernels/spmm_dual.py``).

    The JAX package drops the sentinel pad edges ``(user_num, item_num)``
    with ``mode="drop"`` in its scatter and degree sums. Here nothing is
    filtered (a filter's output size depends on the data, and the card
    would have to report it to the host): each pad edge writes into the
    spare row of :func:`dense_storage`, which nothing reads, and adds its
    count to an extra degree slot that is cut off. Edges are unique (one per
    train interaction or per rebuilt top-k slot), so the degrees count
    them; integer counts in f32 are exact in any order of adds.

    Packed int4 is built in place with no (U, I) transient: each edge adds
    ``1 << 4 * (col % 2)`` to its byte (``index_add_``). Two edges of one
    user can share a byte; the edges are unique, so the adds set distinct
    nibbles, and integer adds give the same byte in any order: the build is
    deterministic (the JAX package scatters at int8 and narrows,
    ``diffmm_tpu/ops/graph.py:291-297``; the port's extra memory is the
    O(nnz) index and value vectors)."""
    rows, cols = ui_rows.long(), ui_cols.long()
    pad = (rows >= user_num) | (cols >= item_num)
    rows = torch.where(pad, user_num, rows)
    cols = torch.where(pad, item_num, cols)
    dev = ui_rows.device
    # rows on 16-byte boundaries, so the spmm_dual kernel reads them in
    # 16-byte vectors (a (U, I) view of padded storage, the spare row past it)
    mat = dense_storage(user_num, item_num, store_dtype, dev) if out is None else out.mat
    ld = mat.stride(0)
    flat = mat.as_strided((user_num + 1, ld), (ld, 1)).view(-1)
    flat.zero_()
    col = torch.where(pad, 0, cols)
    if store_dtype == torch.uint8:
        nibble = torch.where(col % 2 == 0, 1, 16).to(torch.uint8)
        flat.index_add_(0, rows * ld + col // 2, nibble)
    else:
        flat.index_fill_(0, rows * ld + col, 1)
    ones = torch.ones(rows.shape[0], dtype=torch.float32, device=dev)
    deg_u = torch.zeros(user_num + 1, dtype=torch.float32, device=dev).index_add_(0, rows, ones)
    deg_i = torch.zeros(item_num + 1, dtype=torch.float32, device=dev).index_add_(0, cols, ones)
    s_user = torch.rsqrt(deg_u[:user_num] + 1.0)
    s_item = torch.rsqrt(deg_i[:item_num] + 1.0)
    if out is None:
        return DenseBiAdj(mat=mat, s_user=s_user, s_item=s_item)
    out.s_user.copy_(s_user)
    out.s_item.copy_(s_item)
    return out


def assemble_bi_adj(ui_rows, ui_cols, iu_perm, user_num, item_num, scales=None) -> BiAdj:
    """Complete a :class:`BiAdj` from its user-major edges and item-major
    permutation: the inverse permutation, the item-major pair, the offsets
    and, unless given, the scales from the CSR span lengths (the degrees)."""
    perm = iu_perm.long()
    iu_inv = torch.empty_like(iu_perm)
    iu_inv[perm] = torch.arange(perm.shape[0], dtype=iu_perm.dtype, device=iu_perm.device)
    iu_rows = ui_cols[perm]
    ui_offsets = segment_offsets(ui_rows, user_num)
    iu_offsets = segment_offsets(iu_rows, item_num)
    if scales is None:
        scales = [torch.rsqrt(o.diff().to(torch.float32) + 1.0) for o in (ui_offsets, iu_offsets)]
    return BiAdj(
        ui_rows=ui_rows,
        ui_cols=ui_cols,
        iu_perm=iu_perm,
        s_user=scales[0],
        s_item=scales[1],
        iu_inv=iu_inv,
        iu_rows=iu_rows,
        iu_cols=ui_rows[perm],
        ui_offsets=ui_offsets,
        iu_offsets=iu_offsets,
    )


def build_bi_adj_host(
    rows: np.ndarray, cols: np.ndarray, user_num: int, item_num: int,
    device: torch.device | str = "cpu",
) -> BiAdj:
    """Sparse-form adjacency from host edges (JAX ``build_bi_adj_host``):
    a stable sort by user, a stable item-major permutation, and the scales
    in f64 rounded to f32, as the JAX package computes them. Duplicate
    edges must already be removed; sentinel pads ``(user_num, item_num)``
    at the tail are excluded from the degrees."""
    order = np.argsort(rows, kind="stable")
    rows = np.asarray(rows, dtype=np.int32)[order]
    cols = np.asarray(cols, dtype=np.int32)[order]
    iu_perm = np.argsort(cols, kind="stable").astype(np.int32)
    deg_u = np.bincount(rows, minlength=user_num)[:user_num].astype(np.float64)
    deg_i = np.bincount(cols, minlength=item_num)[:item_num].astype(np.float64)
    scales = [
        torch.as_tensor(((deg + 1.0) ** -0.5).astype(np.float32), device=device)
        for deg in (deg_u, deg_i)
    ]
    return assemble_bi_adj(
        torch.as_tensor(rows, device=device), torch.as_tensor(cols, device=device),
        torch.as_tensor(iu_perm, device=device), user_num, item_num, scales,
    )


def build_bi_adj_device(
    ui_rows: torch.Tensor, ui_cols: torch.Tensor, user_num: int, item_num: int,
    out: BiAdj | None = None,
) -> BiAdj:
    """Sparse-form adjacency from device edges sorted by user (JAX
    ``build_bi_adj_device``, the epoch's graph rebuild): a stable argsort
    for the item-major order and the degrees as CSR span lengths. Sentinel
    pads sort past the last segment in both orders, so they fall out of the
    degrees and out of every reduction. With ``out`` (of the same shapes),
    the fields are copied into its tensors in place, which a captured graph
    then reads; a field that is the same tensor (the shared train rows) is
    left as it is, and so is ``out``'s edge shard. Every size here is the
    edge count's, so nothing waits for the card."""
    ui_cols = ui_cols.to(torch.int32)
    iu_perm = torch.argsort(ui_cols, stable=True).to(torch.int32)
    adj = assemble_bi_adj(ui_rows.to(torch.int32), ui_cols, iu_perm, user_num, item_num)
    if out is None:
        return adj
    for dst, src in zip(out, adj):
        if isinstance(dst, torch.Tensor) and dst is not src:
            dst.copy_(src)
    return out


def _cast(z: torch.Tensor, compute: str) -> torch.Tensor:
    """The gathered rows' type: ``compute="bf16"`` rounds the table once
    before the gather (JAX ``_get_propagator``: bf16 messages, f32 sums)."""
    return z.to(torch.bfloat16) if compute == "bf16" else z


def _sum(table: torch.Tensor, src, offsets: torch.Tensor, shard) -> torch.Tensor:
    """One direction's K4 launch: the whole sum on one device; on a mesh the
    rank's edge range, summed over the ranks (K4's mesh form, with the
    all-reduce in place on the launch's own output)."""
    if shard is None:
        return segsum_gather(table, src, offsets)
    nnz = (src if isinstance(src, torch.Tensor) else src[0]).shape[0]
    lo, hi = shard.span(nnz)
    return all_reduce_sum_(slice_segsum_gather(table, src, offsets, lo, hi), shard.group)


def _partial(table: torch.Tensor, src, offsets: torch.Tensor, shard) -> torch.Tensor:
    """A backward's K4 launch: the whole sum on one device; on a mesh the
    rank's edge range only (its part of the parameters' gradient, which the
    step's gradient all-reduce adds up)."""
    if shard is None:
        return segsum_gather(table, src, offsets)
    nnz = (src if isinstance(src, torch.Tensor) else src[0]).shape[0]
    lo, hi = shard.span(nnz)
    return slice_segsum_gather(table, src, offsets, lo, hi)


def _total(g: torch.Tensor, shard) -> torch.Tensor:
    """The cotangent a backward reduces: its own on one device; on a mesh
    the sum of every rank's (each rank's loss covers its own rows, and the
    edge range's transpose must see the whole cotangent)."""
    if shard is None:
        return g
    return all_reduce_sum_(g.contiguous().clone(), shard.group)


class Propagate(torch.autograd.Function):
    """One direction of the sparse form, ``y[r] = sum_{e in segment r}
    z[src[e]]`` over the CSR ``offsets``: one K4 launch that gathers the
    rows itself (JAX ``_get_propagator``, ``graph.py:339-392``).

    ``Propagate.apply(z, src, offsets, bwd_src, bwd_offsets, compute,
    shard)``: the backward is the same sorted reduction in the opposite
    order, one K4 launch: the cotangent's rows named by ``bwd_src`` (the
    forward's segment of each edge, in the other direction's edge order)
    reduced over ``bwd_offsets``. An edge that is a pad in the forward's
    segments names the row one past the cotangent's last, which K4 reads as
    zeros (the JAX backward masks ``src_rows < n_out``); the pads of the
    forward's own order (source index one past z's rows) lie past
    ``offsets[n]`` and are never read. No scatter and no atomics in either
    pass. ``compute="bf16"`` rounds z, and in the backward the cotangent,
    to bf16 before the gather, as the JAX code does.

    ``shard`` (the adjacency's, None on one device): the forward sums the
    rank's edge range and all-reduces the partials; the backward first
    all-reduces the cotangent, then sums the rank's range of the opposite
    order, so that every edge's term enters the gradient sum of the ranks
    exactly once (the JAX mesh forms' VJP, ``graph.py:339-520``)."""

    @staticmethod
    def forward(ctx, z, src, offsets, bwd_src, bwd_offsets, compute, shard=None):
        ctx.save_for_backward(bwd_src, bwd_offsets)
        ctx.compute, ctx.shard = compute, shard
        return _sum(_cast(z, compute), src, offsets, shard)

    @staticmethod
    def backward(ctx, g):
        bwd_src, bwd_offsets = ctx.saved_tensors
        dz = _partial(_cast(_total(g, ctx.shard), ctx.compute), bwd_src, bwd_offsets, ctx.shard)
        return dz, None, None, None, None, None, None


class StackedUserPropagate(torch.autograd.Function):
    """The user direction of M modality graphs that share the train rows
    (JAX ``_get_stacked_user_prop``, ``graph.py:404-463``).

    ``StackedUserPropagate.apply(z, adjs, compute)`` with z (M, I, d) ->
    (M, U, d): one K4 launch over the shared user-major offsets that
    gathers each modality's rows by its own columns into an (U, M·d)
    output. The backward reduces by each modality's own item-major layout,
    one K4 launch a modality. On a mesh (the adjacencies' ``shard``), both
    passes take the rank's edge range as :class:`Propagate` does, the
    forward with one all-reduce of the (U, M·d) partial."""

    @staticmethod
    def forward(ctx, z, adjs, compute):
        ctx.adjs, ctx.compute = adjs, compute
        M, d, U = z.shape[0], z.shape[2], adjs[0].user_num
        wide = _sum(_cast(z, compute), [a.ui_cols for a in adjs], adjs[0].ui_offsets, adjs[0].shard)
        return wide.view(U, M, d).permute(1, 0, 2)

    @staticmethod
    def backward(ctx, g):
        shard = ctx.adjs[0].shard
        g = _cast(_total(g, shard), ctx.compute)
        dz = torch.stack([_partial(g[m], a.iu_cols, a.iu_offsets, shard) for m, a in enumerate(ctx.adjs)])
        return dz, None, None


class MultiItemPropagate(torch.autograd.Function):
    """The item direction of M modality graphs (JAX
    ``_get_multi_item_prop``, ``graph.py:467-520``).

    ``MultiItemPropagate.apply(z, adjs, compute)`` with z (M, U, d) ->
    (M, I, d): one K4 launch a modality, each over its own item-major
    layout. The backward reduces by the shared user-major layout: one K4
    launch over all M cotangents at once. On a mesh, the rank's edge range
    in both passes, as :class:`Propagate`."""

    @staticmethod
    def forward(ctx, z, adjs, compute):
        ctx.adjs, ctx.compute = adjs, compute
        z = _cast(z, compute)
        return torch.stack([_sum(z[m], a.iu_cols, a.iu_offsets, a.shard) for m, a in enumerate(adjs)])

    @staticmethod
    def backward(ctx, g):
        adjs = ctx.adjs
        M, d, U = g.shape[0], g.shape[2], adjs[0].user_num
        g = _cast(_total(g, adjs[0].shard), ctx.compute)
        wide = _partial(g, [a.ui_cols for a in adjs], adjs[0].ui_offsets, adjs[0].shard)
        return wide.view(U, M, d).permute(1, 0, 2), None, None


class MeshSpmmDual(torch.autograd.Function):
    """K1 on a mesh's data axis: ``MeshSpmmDual.apply(mat, z_u, z_i,
    shard)``. The forward is the one-device call, the same on every rank
    (the blocks are replicated). The backward first sums the two cotangents
    over the ranks (one all-reduce; each rank's is its own share of the
    loss's), launches K1 on the totals, so that the bf16 rounding of K1's
    operands falls on the whole cotangent as on one device, and keeps the
    rank's rows of each gradient (zeros elsewhere): the step's gradient
    all-reduce then adds every row once."""

    @staticmethod
    def forward(ctx, mat, z_u, z_i, shard):
        ctx.save_for_backward(mat)
        ctx.shard = shard
        return spmm_dual(mat, z_u, z_i)

    @staticmethod
    def backward(ctx, g_u, g_i):
        (mat,) = ctx.saved_tensors
        shard = ctx.shard
        total = all_reduce_sum_(torch.cat([g_u.reshape(-1), g_i.reshape(-1)]), shard.group)
        dz_u, dz_i = spmm_dual(mat, *(t.view(g.shape) for t, g in zip(total.split([g_u.numel(), g_i.numel()]),
                                                                        (g_u, g_i))))
        for dz in (dz_u, dz_i):
            lo, hi = shard.span(dz.shape[0])
            dz[:lo] = 0.0
            dz[hi:] = 0.0
        return None, dz_u, dz_i, None


def spmm_bi(adj, x_user: torch.Tensor, x_item: torch.Tensor, compute: str = "f32"):
    """``y = D^-1/2 (A + I) D^-1/2 x`` on the split (user, item) embedding
    pair (reference `Model.py:90`), dispatched on the adjacency's form:
    K1 on a :class:`DenseBiAdj`, K4 in both directions on a
    :class:`BiAdj`, forward and backward (:class:`SpmmDual`,
    :class:`Propagate`; on a mesh :class:`MeshSpmmDual` and the mesh form of
    :class:`Propagate`). ``compute`` sets the sparse form's message type
    (the dense form always rounds z to bf16). Returns ``(y_user, y_item)``."""
    z_u = x_user * adj.s_user[:, None]
    z_i = x_item * adj.s_item[:, None]
    if isinstance(adj, DenseBiAdj):
        if adj.shard is None:
            m_u, m_i = SpmmDual.apply(adj.mat, z_u, z_i)
        else:
            m_u, m_i = MeshSpmmDual.apply(adj.mat, z_u, z_i, adj.shard)
    else:
        m_u = Propagate.apply(z_i, adj.ui_cols, adj.ui_offsets, adj.iu_cols, adj.iu_offsets, compute,
                              adj.shard)
        m_i = Propagate.apply(z_u, adj.iu_cols, adj.iu_offsets, adj.ui_cols, adj.ui_offsets, compute,
                              adj.shard)
    y_u = adj.s_user[:, None] * (m_u + z_u)
    y_i = adj.s_item[:, None] * (m_i + z_i)
    return y_u, y_i


def spmm_bi_modal_stacked(
    adjs: list[BiAdj], x_user: torch.Tensor, x_items: list[torch.Tensor], compute: str = "f32",
):
    """All M modality propagations of ``gcn_mm``'s modal loop at once:
    ``(modal_u (M, U, d), modal_i (M, I, d))``, equal to M :func:`spmm_bi`
    calls up to f32 summation order (JAX ``spmm_bi_modal_stacked``).

    The rebuilt modality graphs share the train rows (``ops/topk.py``), so
    the M user-direction reductions run as ONE K4 launch at width M·d over
    the shared ``ui_rows`` (:class:`StackedUserPropagate`); the item
    direction has a layout per modality and runs one launch each
    (:class:`MultiItemPropagate`); their backwards swap the two. The
    shared rows are asserted (the JAX docstring states the precondition
    without checking it)."""
    rows = adjs[0].ui_rows
    for a in adjs[1:]:
        if a.ui_rows is not rows and not torch.equal(a.ui_rows, rows):
            raise ValueError("spmm_bi_modal_stacked: the adjacencies must share ui_rows")
    adjs = tuple(adjs)
    z_u = torch.stack([x_user * a.s_user[:, None] for a in adjs])
    z_i = torch.stack([x * a.s_item[:, None] for x, a in zip(x_items, adjs)])
    m_u = StackedUserPropagate.apply(z_i, adjs, compute)
    m_i = MultiItemPropagate.apply(z_u, adjs, compute)
    s_u = torch.stack([a.s_user for a in adjs])[:, :, None]
    s_i = torch.stack([a.s_item for a in adjs])[:, :, None]
    return s_u * (m_u + z_u), s_i * (m_i + z_i)
