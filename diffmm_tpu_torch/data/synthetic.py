"""Synthetic dataset generator (numpy only).

Counterpart of ``diffmm_tpu/data/synthetic.py``: the same numpy draws in the
same order, so one seed gives bit-identical arrays under both packages.

:data:`SHAPES` names the datasets the measuring programs synthesise where the
real files are not in the repository (``bench.py``, ``tools/``,
``chip_smoke.py``), and :func:`host_data` gives a measuring run its data:
a named shape, made explicitly, or the config's dataset.
"""

from __future__ import annotations

import numpy as np

from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.loader import HostData, load_host_data

# A dataset's catalog at its train density, with its modalities' feature
# widths. tiktok: conf/test.toml's dataset. yelp: conf/yelp.toml's (307,180
# train edges at this density and seed 125). sports: the structured
# synthetic of tests/test_scale_accuracy.py (sports' 256,308 edges over the
# catalog as its density, which keeps 7 a user, 249,186; rank-8 latent
# preferences; its narrow features), which learns, so its Recall means
# something.
SHAPES = {
    "tiktok": {"user_num": 9308, "item_num": 6710, "density": 0.000953,
               "modalities": ["image", "text", "audio"], "feat_dims": [128, 768, 128]},
    "yelp": {"user_num": 38403, "item_num": 20000, "density": 0.0004,
             "modalities": ["image", "text"], "feat_dims": [4096, 1024]},
    "sports": {"user_num": 35598, "item_num": 18357, "density": 256308 / (35598 * 18357),
               "modalities": ["image", "text"], "feat_dims": [32, 32], "structure_rank": 8},
}


def synthesize_shape(config: Config, name: str) -> HostData:
    """The named shape of :data:`SHAPES`, drawn from ``config.base.seed``."""
    if name not in SHAPES:
        raise ValueError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return make_synthetic_host_data(config, seed=config.base.seed, **SHAPES[name])


def host_data(config: Config, shape: str | None = None, data_root: str | None = None) -> HostData:
    """A measuring run's data: ``shape`` synthesised (:func:`synthesize_shape`)
    when given, else the config's dataset (under ``data_root``, as
    :func:`load_host_data` finds it), whose absence is an error that names
    the ``--synthetic`` option (never a silent stand-in)."""
    if shape is not None:
        return synthesize_shape(config, shape)
    try:
        return load_host_data(config, data_root=data_root)
    except FileNotFoundError as e:
        raise SystemExit(
            f"{e}\nThe {config.data.name!r} data is not here: --synthetic "
            f"{{{'|'.join(SHAPES)}}} runs on data synthesised at a dataset's shape."
        ) from e


def make_synthetic_host_data(
    config: Config,
    user_num: int = 50,
    item_num: int = 40,
    density: float = 0.06,
    test_per_user: int = 2,
    seed: int = 0,
    modalities: list[str] | None = None,
    feat_dims: list[int] | None = None,
    structure_rank: int | None = None,
) -> HostData:
    """Random bipartite graph + gaussian features, same invariants as real
    data: every user has >= 1 train interaction. ``structure_rank`` draws
    interactions from a rank-r latent preference model and holds out each
    user's highest-affinity non-train items as test items."""
    rng = np.random.default_rng(seed)
    mods = modalities or ["image", "text", "audio"]
    dims = feat_dims or [16, 24, 16][: len(mods)]

    affinity = None
    z_u = z_i = None
    if structure_rank is not None:
        z_u = rng.standard_normal((user_num, structure_rank))
        z_i = rng.standard_normal((item_num, structure_rank))
        if user_num * item_num > 2 * 10**8:
            return _structured_large(
                config, rng, user_num, item_num, density, test_per_user,
                mods, dims, z_u, z_i, structure_rank,
            )
        affinity = z_u @ z_i.T / np.sqrt(structure_rank)

    if user_num * item_num <= 2 * 10**8:
        if affinity is not None:
            noisy = affinity + rng.gumbel(0, 0.25, affinity.shape)
            dense = (noisy > np.quantile(noisy, 1.0 - density)).astype(np.int8)
        else:
            dense = (rng.random((user_num, item_num)) < density).astype(np.int8)
        for u in range(user_num):
            if dense[u].sum() == 0:
                dense[u, rng.integers(item_num)] = 1
        rows, cols = np.nonzero(dense)
        rows = rows.astype(np.int32)
        cols = cols.astype(np.int32)
    else:
        # large shapes: draw edges sparsely, never a (U, I) array
        n_draw = int(user_num * item_num * density)
        r = rng.integers(0, user_num, n_draw, dtype=np.int64)
        c = rng.integers(0, item_num, n_draw, dtype=np.int64)
        flat = np.unique(r * item_num + c)
        have = np.zeros(user_num, dtype=bool)
        have[(flat // item_num).astype(np.int64)] = True
        missing = np.nonzero(~have)[0]
        if missing.size:
            extra = missing * item_num + rng.integers(0, item_num, missing.size, dtype=np.int64)
            flat = np.unique(np.concatenate([flat, extra]))
        rows = (flat // item_num).astype(np.int32)
        cols = (flat % item_num).astype(np.int32)
        dense = None
    degrees = np.bincount(rows, minlength=user_num).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(degrees[:-1])]).astype(np.int32)

    if structure_rank is not None:
        raw_feats = [
            (
                z_i @ rng.standard_normal((structure_rank, d)) / np.sqrt(structure_rank)
                + 0.3 * rng.standard_normal((item_num, d))
            ).astype(np.float32)
            for d in dims
        ]
    else:
        raw_feats = [rng.standard_normal((item_num, d), dtype=np.float32) for d in dims]

    if affinity is None and user_num > 20_000:
        test_users = np.arange(user_num, dtype=np.int32)
        test_items = rng.integers(0, item_num, (user_num, test_per_user)).astype(np.int32)
        test_counts = np.full(user_num, test_per_user, dtype=np.int32)
        return _assemble(
            config, user_num, item_num, mods, dims, rows, cols, degrees,
            offsets, dense, raw_feats, test_users, test_items, test_counts,
        )
    t_users, t_items, t_counts = [], [], []
    for u in range(user_num):
        if affinity is not None:
            order = np.argsort(-affinity[u])
            cand = order[dense[u, order] == 0]
            its = cand[:test_per_user]
            t_counts.append(int(its.size))
            if its.size < test_per_user:
                its = np.concatenate([its, np.full(test_per_user - its.size, -1)])
        else:
            its = rng.choice(item_num, size=test_per_user, replace=False)
            t_counts.append(test_per_user)
        t_users.append(u)
        t_items.append(its.astype(np.int32))
    return _assemble(
        config, user_num, item_num, mods, dims, rows, cols, degrees,
        offsets, dense, raw_feats, np.array(t_users, dtype=np.int32),
        np.stack(t_items), np.array(t_counts, dtype=np.int32),
    )


def _structured_large(
    config, rng, user_num, item_num, density, test_per_user, mods, dims,
    z_u, z_i, structure_rank,
) -> HostData:
    """Structured synthetic at shapes where the (U, I) affinity cannot be
    materialised: per user block, each user's top-k affinity items are its
    train edges and the next ``test_per_user`` its test items."""
    k_train = max(1, int(round(item_num * density)))
    blk = max(1, (64 << 20) // (item_num * 8))
    rows_parts, cols_parts, test_parts = [], [], []
    scale = 1.0 / np.sqrt(structure_rank)
    for lo in range(0, user_num, blk):
        hi = min(lo + blk, user_num)
        aff = (z_u[lo:hi] @ z_i.T) * scale
        aff += rng.gumbel(0, 0.25, aff.shape)
        top = np.argpartition(-aff, k_train + test_per_user - 1, axis=1)[
            :, : k_train + test_per_user
        ]
        order = np.take_along_axis(aff, top, axis=1).argsort(axis=1)[:, ::-1]
        top = np.take_along_axis(top, order, axis=1)
        train_blk = np.sort(top[:, :k_train], axis=1).astype(np.int32)
        test_parts.append(top[:, k_train : k_train + test_per_user].astype(np.int32))
        rows_parts.append(np.repeat(np.arange(lo, hi, dtype=np.int32), k_train))
        cols_parts.append(train_blk.reshape(-1))
    rows = np.concatenate(rows_parts)
    cols = np.concatenate(cols_parts)
    degrees = np.full(user_num, k_train, dtype=np.int32)
    offsets = (np.arange(user_num, dtype=np.int64) * k_train).astype(np.int32)
    raw_feats = [
        (
            z_i @ rng.standard_normal((structure_rank, d)) / np.sqrt(structure_rank)
            + 0.3 * rng.standard_normal((item_num, d))
        ).astype(np.float32)
        for d in dims
    ]
    return _assemble(
        config, user_num, item_num, mods, dims, rows, cols, degrees,
        offsets, None, raw_feats, np.arange(user_num, dtype=np.int32),
        np.concatenate(test_parts, axis=0),
        np.full(user_num, test_per_user, dtype=np.int32),
    )


def _assemble(
    config, user_num, item_num, mods, dims, rows, cols, degrees, offsets,
    dense, raw_feats, test_users, test_items, test_counts,
) -> HostData:
    config.data.name = "synthetic"
    config.data.user_num = user_num
    config.data.item_num = item_num
    dim_fields = {"image": "image_feat_dim", "text": "text_feat_dim", "audio": "audio_feat_dim"}
    for mod, d in zip(mods, dims):
        setattr(config.data, dim_fields[mod], d)
    return HostData(
        name="synthetic",
        user_num=user_num,
        item_num=item_num,
        modalities=mods,
        feat_dims=list(dims),
        train_rows=rows,
        train_cols=cols,
        user_degrees=degrees,
        csr_offsets=offsets,
        k_max=int(degrees.max()),
        raw_feats=raw_feats,
        test_users=test_users,
        test_items=test_items,
        test_counts=test_counts,
        _train_dense=dense,
    )
