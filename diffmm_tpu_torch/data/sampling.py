"""Negative sampling: one non-interacted item per train interaction.

Counterpart of ``diffmm_tpu/data/sampling.py``, which replaces the
reference's per-interaction rejection loop against a DOK hash (reference
`DataHandler.py:159-169`) with a fixed number of vectorised rounds: draw a
uniform item for every lane that still needs one, test membership against
the train store (:func:`~diffmm_tpu_torch.data.membership.contains`, dense
or CSR: the same answers), and keep drawing only for the lanes that hit a
train item. At catalog densities up to about 1%, 8 rounds leave a lane
colliding with probability below 1e-16; a survivor keeps its last draw.

On a model axis that cuts the dense store, each rank holds only its catalog
columns of it (a ``DenseShard``): every rank draws the same candidates (one
generator state), answers for its own columns, and one all-reduce of the
0/1 hits over the axis a round ORs the answers, so the negatives are
bitwise those of the whole store.
"""

from __future__ import annotations

import torch

from diffmm_tpu_torch.data.membership import DenseShard, contains
from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_


def negative_sampling(
    users: torch.Tensor,
    train_store,
    item_num: int,
    rounds: int = 8,
    draws: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    group=None,
) -> torch.Tensor:
    """(nnz,) int32 negative items for the (nnz,) ``users`` of the train
    interactions. ``draws`` (rounds, nnz) are the candidate items of each
    round, drawn uniformly from ``generator`` when not given (a test passes
    the JAX package's ``jax.random.randint`` draws, one row per subkey of
    ``jax.random.split(key, rounds)``). ``group``: the model axis's group
    where ``train_store`` is a ``DenseShard``, the other columns held by
    its other ranks (and only there)."""
    if isinstance(train_store, DenseShard) != (group is not None):
        raise ValueError("a DenseShard store, and only such a store, takes the model axis's group")
    n = users.shape[0]
    if draws is None:
        draws = torch.randint(0, item_num, (rounds, n), generator=generator, device=users.device)
    negs = torch.zeros(n, dtype=torch.int32, device=users.device)
    needs = torch.ones(n, dtype=torch.bool, device=users.device)
    for r in range(draws.shape[0]):
        negs = torch.where(needs, draws[r].to(torch.int32), negs)
        hit = contains(train_store, users, negs)
        if group is not None:
            hit = all_reduce_sum_(hit.to(torch.int32), group) > 0
        needs = needs & hit
    return negs
