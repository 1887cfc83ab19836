"""Adam with the learning rate as a runtime scalar, and the cosine schedule.

Counterpart of ``diffmm_tpu/train/optim.py``: one Adam (betas 0.9/0.999,
eps 1e-8, no weight decay) per model, the main GCN and each modality's
denoiser, with the learning rate of CosineAnnealingLR (T_max = the epoch
count, eta_min = 1e-4) stepped once per epoch (reference `Main.py:59-66,
92-110`). The JAX package takes the moments from ``optax.scale_by_adam``
and applies ``p - lr * update`` itself; :func:`adam_update` is that
update, bias correction included, in place over the parameter tree's
leaves (the port updates in place: the parameters and both moments are
catalog-sized, and a functional update would hold two copies of each).

On the card a training step is replayed from a captured CUDA graph
(``train/graphs.py``), so nothing the step reads may be a host number baked
in at capture: the learning rate and the two bias corrections reach
:func:`adam_update` as a (3,) device tensor, one row per step of
:func:`adam_scalars`. The step count stays a host integer: it advances by
one a step, so the host knows it without reading the card, and
:func:`adam_scalars` computes each step's bias corrections from it in f32
as optax does (the same numbers on the CPU and the card).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a parameter tree (dicts and lists), dicts in sorted
    key order: the order ``jax.tree_util.tree_leaves`` gives the same tree,
    so a JAX optimizer state converts leaf by leaf."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor, the structure kept."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, sub) for sub in tree]
    return fn(tree)


@dataclass
class AdamState:
    """``optax.ScaleByAdamState`` over :func:`tree_leaves` of a parameter
    tree: the step count (a host integer, the steps taken) and the two
    moments."""

    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


def adam_init(params) -> AdamState:
    leaves = tree_leaves(params)
    return AdamState(0, [torch.zeros_like(p) for p in leaves], [torch.zeros_like(p) for p in leaves])


def _bias_correction(decay: float, count: int) -> np.float32:
    """``1 - decay**count`` in f32, as optax computes it."""
    one = np.float32(1)
    return one - np.power(np.float32(decay), np.float32(count), dtype=np.float32)


def adam_scalars(lr: float, count: int, n: int) -> np.ndarray:
    """(n, 3) f32: row j holds ``[lr, 1 - 0.9**c, 1 - 0.999**c]`` for step
    count ``c = count + j + 1``, the scalars of the n steps that follow a
    state at ``count``; ``lr`` rounded to f32 as the update applies it."""
    rows = np.empty((n, 3), dtype=np.float32)
    rows[:, 0] = np.float32(lr)
    for j in range(n):
        rows[j, 1] = _bias_correction(B1, count + j + 1)
        rows[j, 2] = _bias_correction(B2, count + j + 1)
    return rows


@torch.no_grad()
def adam_update(params, grads: list[torch.Tensor], state: AdamState, lr) -> AdamState:
    """One Adam step in place: the moments as ``optax.scale_by_adam(0.9,
    0.999, 1e-8)`` updates them, then ``p -= lr * mu_hat / (sqrt(nu_hat) +
    eps)`` for each leaf of ``params``; ``grads`` are in leaf order.

    ``lr`` is a float, or a (3,) tensor on the parameters' device: a row of
    :func:`adam_scalars` (the learning rate and this step's two bias
    corrections). With a float the step's scalars are made here and the
    count advances by one; with a row the caller made them from the count
    and advances it (a captured step runs no host code). Returns the state
    (its tensors updated in place).

    A tree with leaves narrower than f32 (bf16 denoisers, ``base.
    denoise_param_dtype``) takes the step in their type, op by op as optax
    takes it there: the moments are of the leaves' type (optax's
    ``zeros_like``), each operation rounds to it, its constants are cast to
    it as JAX casts a Python scalar against a bf16 array (0.9 becomes
    0.8984375), and so are the bias corrections (``optax.tree.
    bias_correction``); the update is applied as ``(p - lr * u).astype(
    p.dtype)``, in f32, rounded once."""
    leaves = tree_leaves(params)
    if not isinstance(lr, torch.Tensor):
        scalars = torch.as_tensor(adam_scalars(lr, state.count, 1)[0], device=leaves[0].device)
        state.count += 1
    else:
        scalars = lr
    lr_t, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    if all(p.dtype == torch.float32 for p in leaves):
        _adam_f32(leaves, grads, state.mu, state.nu, lr_t, bc1, bc2)
        return state
    for p, g, mu, nu in zip(leaves, grads, state.mu, state.nu):
        c = functools.partial(_weak, dtype=p.dtype)
        mu.copy_(g * c(1 - B1) + mu * c(B1))
        nu.copy_(torch.square(g) * c(1 - B2) + nu * c(B2))
        u = (mu / bc1.to(p.dtype)) / (torch.sqrt(nu / bc2.to(p.dtype)) + c(EPS))
        p.copy_(p.float() - lr_t * u.float())
    return state


def _weak(x: float, dtype: torch.dtype) -> float:
    """The Python constant ``x`` rounded to ``dtype``, as JAX casts a
    weakly typed scalar to the array's type before the operation."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _adam_f32(leaves, grads, mu, nu, lr_t, bc1, bc2) -> None:
    """The step of a tree of f32 leaves, fused over them (``torch._foreach_*``)."""
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, grads, alpha=1 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - B2)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    update = torch._foreach_div(mu, bc1)
    torch._foreach_div_(update, denom)
    torch._foreach_mul_(update, lr_t)
    torch._foreach_sub_(leaves, update)


def cosine_lr(epoch: int, base_lr: float, total_epochs: int, eta_min: float = 1e-4) -> float:
    """LR used during ``epoch``: torch CosineAnnealingLR stepped once per
    epoch (reference `Main.py:59-66,93`)."""
    if total_epochs <= 0:
        return base_lr
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / total_epochs)) / 2
