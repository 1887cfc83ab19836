"""The benchmark's inputs, made from ``--seed`` on the device.

The interaction graph and the modality features follow the arithmetic of the
port's synthetic generator (``diffmm_tpu_torch/data/synthetic.py::
make_synthetic_host_data``), frozen here so that a later change to the
program cannot change the yardstick, with changes that give every seed the
same work and the published datasets' sizes:

* Users' degrees are a long-tailed sequence fixed by the configuration
  (:func:`degree_sequence`): a floor, plus a lognormal excess taken at
  evenly spaced quantiles and brought exactly to the configuration's
  ``train_edges``. The test items (``test_edges`` in all) are shared out in
  proportion to the degrees, so users with few edges have none and are not
  evaluated, as in the published splits. The seed permutes which user has
  which degree, so the edge count, the block count of every phase, the
  rebuild's top-k width and the hubs are the same for every seed.
* ``uniform`` graphs (TikTok's) draw each user's items uniformly without
  replacement, as the Bernoulli draw of the original does.
* ``latent`` graphs (Sports') are the original's large-shape structured
  branch (``_structured_large``): a rank-r preference model with Gumbel
  noise, each user's top items its train edges and the next ones its test
  items.

Both are drawn with a ``torch.Generator`` on the device in a few large
calls; nothing of size (U, I) lives longer than one block. The edges come
back to the host user-major, items ascending within a user, as the
program's loader keeps them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np
import torch

_BLOCK_CELLS = 1 << 26  # (users x items) cells drawn at once


def derive_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of the run's streams, from ``--seed``."""
    state = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1)


@dataclass
class Inputs:
    """What the benchmark hands to the program and to the reference."""

    user_num: int
    item_num: int
    modalities: list[str]
    feat_dims: list[int]
    rows: np.ndarray  # (nnz,) int32 user-major
    cols: np.ndarray  # (nnz,) int32, ascending within each user
    degrees: np.ndarray  # (U,) int32
    feats: list[torch.Tensor]  # (I, d_m) f32 on the device, empty when not asked for
    test_items: np.ndarray  # (U, max test) int32, padded with -1
    test_counts: np.ndarray  # (U,) int32, 0 for users without test items

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def offsets(self) -> np.ndarray:
        """(U,) int32 start of each user's span."""
        return (np.cumsum(self.degrees) - self.degrees).astype(np.int32)

    @property
    def test_users(self) -> np.ndarray:
        """The evaluated users: those with test items, ascending."""
        return np.flatnonzero(self.test_counts > 0).astype(np.int32)


def _share(total: int, weights: np.ndarray) -> np.ndarray:
    """``total`` split in proportion to ``weights`` in whole parts (largest
    remainders first, ties to the lower index)."""
    exact = total * weights / weights.sum()
    out = np.floor(exact).astype(np.int64)
    rest = int(total - out.sum())
    out[np.argsort(-(exact - out), kind="stable")[:rest]] += 1
    return out


def degree_sequence(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's fixed (train degrees, test counts) per user,
    before the seed permutes the users: ``graph.degrees``' floor ``min``
    plus a lognormal excess (``sigma``) at the quantiles (j + 1/2) / U,
    summed to ``train_edges``; ``test_edges`` shared in proportion to the
    degrees. No user takes more than the catalog."""
    users, items = int(spec["users"]), int(spec["items"])
    graph = spec["graph"]
    lo, sigma = int(graph["degrees"]["min"]), float(graph["degrees"]["sigma"])
    target, n_test = int(graph["train_edges"]), int(graph["test_edges"])
    if not lo * users <= target <= items * users:
        raise ValueError(f"{target} train edges do not fit {users} users of at least {lo} of {items} items")
    z = np.array([NormalDist().inv_cdf((j + 0.5) / users) for j in range(users)])
    deg = lo + _share(target - lo * users, np.exp(sigma * z))
    if deg.max() > items:
        raise ValueError(f"a degree of {deg.max()} exceeds the {items} items")
    test = np.minimum(_share(n_test, deg.astype(np.float64)), items - deg)
    if test.sum() != n_test:
        raise ValueError(f"{n_test} test edges do not fit beside the train edges")
    return deg, test


def make_inputs(spec: dict, seed: int, device: torch.device, with_feats: bool = True) -> Inputs:
    """The graph, test items and (``with_feats``) features of ``spec``
    (a configuration's ``data`` section) for ``seed``."""
    users, items = int(spec["users"]), int(spec["items"])
    mods = [m for m, _ in spec["modalities"]]
    dims = [int(d) for _, d in spec["modalities"]]
    graph = spec["graph"]
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 1))
    deg, n_test = degree_sequence(spec)
    perm = np.random.default_rng(derive_seed(seed, 2)).permutation(users)
    deg, n_test = deg[perm], n_test[perm]
    k = int((deg + n_test).max())
    z_i = None
    if graph["kind"] == "latent":
        rank = int(graph["rank"])
        z_u = torch.randn((users, rank), generator=gen, device=device)
        z_i = torch.randn((items, rank), generator=gen, device=device)
    blk = max(1, _BLOCK_CELLS // items)
    picks = []
    for lo in range(0, users, blk):
        hi = min(lo + blk, users)
        if z_i is None:
            keys = torch.rand((hi - lo, items), generator=gen, device=device)
        else:
            u01 = torch.rand((hi - lo, items), generator=gen, device=device).clamp_(1e-12, 1 - 1e-7)
            keys = (z_u[lo:hi] @ z_i.T) / math.sqrt(rank) - 0.25 * torch.log(-torch.log(u01))
        picks.append(torch.topk(keys, k, dim=1, sorted=True).indices.to(torch.int32))
        del keys
    top = torch.cat(picks)
    deg_t = torch.as_tensor(deg, device=device)
    lanes = torch.arange(k, device=device)[None, :]
    train = torch.where(lanes < deg_t[:, None], top, items)[:, : int(deg.max())]
    train = torch.sort(train, dim=1).values
    keep = lanes[:, : train.shape[1]] < deg_t[:, None]
    cols = train[keep].cpu().numpy().astype(np.int32)
    t_max = max(1, int(n_test.max()))
    lanes_t = deg_t[:, None] + torch.arange(t_max, device=device)[None, :]
    test_t = torch.as_tensor(n_test, device=device)
    in_test = lanes_t < (deg_t + test_t)[:, None]
    test = torch.where(in_test, top.gather(1, lanes_t.clamp_max(k - 1)), -1).cpu().numpy().astype(np.int32)
    rows = np.repeat(np.arange(users, dtype=np.int32), deg)
    feats = []
    if with_feats:
        for d in dims:
            if z_i is None:
                feats.append(torch.randn((items, d), generator=gen, device=device))
            else:
                proj = torch.randn((rank, d), generator=gen, device=device) / math.sqrt(rank)
                feats.append(z_i @ proj + 0.3 * torch.randn((items, d), generator=gen, device=device))
    return Inputs(users, items, mods, dims, rows, cols, deg.astype(np.int32), feats, test,
                  n_test.astype(np.int32))
