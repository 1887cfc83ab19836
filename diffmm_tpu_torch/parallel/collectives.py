"""The collectives of the mesh: sum all-reduces and their placed forms.

In the JAX package XLA inserts these (the gradient ``psum`` over the data
axis, the ``psum`` of K4's placed partials, the ``all_gather`` of the
distributed top-k); here they are explicit, and only two
``torch.distributed`` calls are used, ``all_reduce`` (sum) and
``broadcast``, which NCCL and gloo both take on CUDA tensors, so one code
path runs under either. An all-gather is a *placed* all-reduce: each rank
writes its part into a frame of zeros and the frames are summed, as the JAX
mesh form of K4 places its partial with ``dynamic_update_slice`` before its
``psum`` (``segsum.py:483-487``).
Adding zeros leaves every f32 and integer value as it is, so the result is
exact.

The autograd forms share one convention: a rank's loss is its share of the
one global loss (its rows of a block, its catalog columns of a row), so
its cotangents are shares too, and the ranks' shares add up to the whole.
A sum over ranks (:class:`AllReduceSum`) then sums its cotangent again in
the backward, and the all-gather of row shards (:class:`AllGatherRows`)
sums it and keeps the rank's rows, which is what JAX's ``shard_map``
transposes give. A replicated value whose cotangent every rank holds whole
would be counted once a rank: that is why every loss term that the ranks
of an axis would compute alike is counted on one rank of it only
(``train/steps.py``).

Every sum goes through :func:`all_reduce_sum_`, which counts it in the
kernels' work counters (``ops/kernels``: ``allreduce.<site>.calls`` and
``allreduce.<site>.bytes``, through graph replays too) under the site its
caller names: ``grads`` (:func:`all_reduce_grads`), ``propagate`` (K1's and
K4's mesh forms and their backward), ``gather`` (a placed all-reduce),
``topk`` (the merge of a catalog-sharded top-k) or ``other``. A sum over
a group of one rank (a model axis of 1) moves nothing and is not counted.

A ``None`` group is one device, with no process group (the one-device
:class:`~diffmm_tpu_torch.parallel.sharding.Split`): every helper here then
returns its input as it is, before it allocates anything, and counts
nothing. No caller passes ``None`` for the default group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from diffmm_tpu_torch.ops.kernels import count_allreduce


def all_reduce_sum_(x: torch.Tensor, group, site: str = "other") -> torch.Tensor:
    """Sum ``x`` (contiguous) over ``group`` in place, counted under
    ``site`` where the group has more than one rank; returns it (as it is
    without a group)."""
    if group is None:
        return x
    if dist.get_world_size(group) > 1:
        count_allreduce(site, x.numel() * x.element_size())
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class AllReduceSum(torch.autograd.Function):
    """``AllReduceSum.apply(x, group, site="other")``: the sum of every
    rank's ``x``, counted under ``site``.

    The backward all-reduces the cotangent too: each rank's cotangent is
    its own share of the loss's, and the input of the sum needs the whole
    of it (the sum's transpose, with every rank's loss a part of the one
    global loss)."""

    @staticmethod
    def forward(ctx, x, group, site="other"):
        ctx.group, ctx.site = group, site
        if group is None:
            return x
        return all_reduce_sum_(x.contiguous().clone(), group, site)

    @staticmethod
    def backward(ctx, g):
        if ctx.group is None:
            return g, None, None
        return all_reduce_sum_(g.contiguous().clone(), ctx.group, ctx.site), None, None


def placed_all_reduce(local: torch.Tensor, offset: int, total: int, group, dim: int = 0,
                      site: str = "gather") -> torch.Tensor:
    """The all-gather of the mesh: ``local`` written at ``offset`` along
    ``dim`` of a zero frame ``total`` long there, summed over ``group``
    (counted under ``site``). The ranks' parts must not overlap."""
    if group is None:
        return local
    shape = list(local.shape)
    shape[dim] = total
    frame = local.new_zeros(shape)
    frame.narrow(dim, offset, local.shape[dim]).copy_(local)
    return all_reduce_sum_(frame, group, site)


class AllGatherRows(torch.autograd.Function):
    """``AllGatherRows.apply(x, offset, total, group)``: the (total, ...)
    table whose rows ``[offset, offset + len(x))`` are this rank's ``x``
    (:func:`placed_all_reduce`). The backward sums the cotangent's shares
    over ``group`` and keeps the rank's rows: the adjoint of the gather."""

    @staticmethod
    def forward(ctx, x, offset, total, group):
        ctx.offset, ctx.n, ctx.group = offset, x.shape[0], group
        if group is None:
            return x
        return placed_all_reduce(x.contiguous(), offset, total, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.group is None:
            return g, None, None, None
        whole = all_reduce_sum_(g.contiguous().clone(), ctx.group, "gather")
        return whole[ctx.offset:ctx.offset + ctx.n], None, None, None


def all_reduce_grads(grads: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Every gradient summed over ``group`` with one all-reduce of one flat
    buffer a dtype (one for f32 parameters; the bf16 denoisers of
    ``base.denoise_param_dtype="bf16"`` add a second). Returns new tensors
    in the gradients' shapes (the gradients themselves without a group)."""
    if group is None:
        return list(grads)
    out: list[torch.Tensor | None] = [None] * len(grads)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = all_reduce_sum_(torch.cat([grads[i].reshape(-1) for i in idx]), group, "grads")
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view(grads[i].shape)
    return out
