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
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` (contiguous) over ``group`` in place; returns it."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class AllReduceSum(torch.autograd.Function):
    """``AllReduceSum.apply(x, group)``: the sum of every rank's ``x``.

    The backward all-reduces the cotangent too: each rank's cotangent is
    its own share of the loss's, and the input of the sum needs the whole
    of it (the sum's transpose, with every rank's loss a part of the one
    global loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.contiguous().clone(), ctx.group), None


def placed_all_reduce(local: torch.Tensor, offset: int, total: int, group, dim: int = 0) -> torch.Tensor:
    """The all-gather of the mesh: ``local`` written at ``offset`` along
    ``dim`` of a zero frame ``total`` long there, summed over ``group``.
    The ranks' parts must not overlap."""
    shape = list(local.shape)
    shape[dim] = total
    frame = local.new_zeros(shape)
    frame.narrow(dim, offset, local.shape[dim]).copy_(local)
    return all_reduce_sum_(frame, group)


def all_reduce_grads(grads: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Every gradient summed over ``group`` with one all-reduce of one flat
    buffer a dtype (one for f32 parameters; the bf16 denoisers of
    ``base.denoise_param_dtype="bf16"`` add a second). Returns new tensors
    in the gradients' shapes."""
    out: list[torch.Tensor | None] = [None] * len(grads)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = all_reduce_sum_(torch.cat([grads[i].reshape(-1) for i in idx]), group)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view(grads[i].shape)
    return out
