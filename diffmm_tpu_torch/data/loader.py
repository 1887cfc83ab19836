"""Host-side dataset ingest -> device-resident tensors.

Counterpart of ``diffmm_tpu/data/loader.py`` (reference `DataHandler.py`):
pickled scipy COO train/test matrices plus ``.npy`` modality features,
binarised; user-major sorted edges, per-user degrees and CSR offsets; missing
feature blobs synthesised deterministically (zeros, drop, randn, svd,
svd_tfidf). The host arrays are numpy and equal to the JAX package's.

:func:`to_device` places them on a torch device with the dense (U, I) int8
train store or the O(nnz) CSR store, and the sparse-form main adjacency
when the run asks for it.
"""

from __future__ import annotations

import os
import pickle
import warnings
import zlib
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.membership import DenseShard, make_train_csr, plan_head_tail
from diffmm_tpu_torch.ops.graph import build_bi_adj_host

# Modality layout per dataset (reference `DataHandler.py:33-37`)
MODALITIES = {"tiktok": ["image", "text", "audio"]}
DEFAULT_MODALITIES = ["image", "text"]

# Documented feature dims for synthesizing missing blobs
_SYNTH_FEAT_DIMS = {
    ("tiktok", "image"): 128,
    ("tiktok", "text"): 768,
    ("tiktok", "audio"): 128,
    ("baby", "image"): 4096,
    ("baby", "text"): 1024,
    ("sports", "image"): 4096,
    ("sports", "text"): 1024,
    ("yelp", "image"): 4096,
    ("yelp", "text"): 1024,
    ("ifashion", "image"): 4096,
    ("ifashion", "text"): 1024,
}


def modality_names(dataset: str) -> list[str]:
    return MODALITIES.get(dataset, DEFAULT_MODALITIES)


def resolve_data_dir(name: str, explicit_root: str | None = None) -> str:
    """Locate ``<root>/<name>/`` among the usual candidates."""
    candidates = []
    if explicit_root:
        candidates.append(explicit_root)
    env_root = os.environ.get("DIFFMM_DATA_ROOT")
    if env_root:
        candidates.append(env_root)
    candidates.append("./Datasets")
    for root in candidates:
        path = os.path.join(root, name)
        if os.path.isdir(path):
            return path
    raise FileNotFoundError(
        f"Dataset {name!r} not found under any of {candidates}; "
        "set DIFFMM_DATA_ROOT or pass data_root."
    )


def load_interactions(path: str) -> sp.coo_matrix:
    """Unpickle + binarize an interaction matrix (reference `DataHandler.py:41-50`).
    The files are the repository's own dataset pickles."""
    with open(path, "rb") as fh:
        mat = pickle.load(fh)
    mat = (mat != 0).astype(np.float32)
    if not isinstance(mat, sp.coo_matrix):
        mat = sp.coo_matrix(mat)
    return mat


def _synthesize_features(
    name: str,
    modality: str,
    item_num: int,
    mode: str = "zeros",
    train: "sp.spmatrix | None" = None,
    svd_rank: int = 0,
) -> np.ndarray:
    """Stand-in for an unshipped feature blob: ``zeros``; ``randn`` fixed
    gaussian pseudo-features seeded by a content hash; ``svd`` the top
    singular directions of the train matrix (scaled by singular values,
    variance-normalised); ``svd_tfidf`` the same of the IDF-weighted matrix.
    ``svd_rank`` caps the decomposition rank (zero-padded to the blob dim)."""
    dim = _SYNTH_FEAT_DIMS.get((name, modality), 64)
    if mode == "zeros":
        return np.zeros((item_num, dim), dtype=np.float32)
    if mode in ("svd", "svd_tfidf"):
        if train is None:
            raise ValueError(f"missing_modalities={mode!r} needs the train matrix")
        mat = sp.csr_matrix(train, dtype=np.float32)
        if mode == "svd_tfidf":
            deg_i = np.asarray(mat.sum(axis=0)).ravel()
            idf = np.log((mat.shape[0] + 1.0) / (deg_i + 1.0)).astype(np.float32)
            mat = sp.csr_matrix(mat.multiply(idf[None, :]))
        k = min(dim, min(mat.shape) - 1)
        if svd_rank and svd_rank > 0:
            k = min(k, svd_rank)
        if k < 1:  # degenerate 1-user/1-item matrix: nothing to decompose
            return np.zeros((item_num, dim), dtype=np.float32)
        feats = _train_svd_feats(mat, k)
        if k < dim:
            feats = np.pad(feats, ((0, 0), (0, dim - k)))
        return feats
    # stable content seed — builtin hash() is salted per process
    seed = zlib.crc32(f"{name}/{modality}".encode())
    rng = np.random.default_rng(seed)
    return rng.standard_normal((item_num, dim), dtype=np.float32)


def _svd_cache_dir() -> str | None:
    """``DIFFMM_FEAT_CACHE`` (``0`` disables) or ``<repo>/data/.feat_cache``,
    the same cache the JAX package keeps: its key is exact content, so a hit
    returns bit-identical features."""
    cache_env = os.environ.get("DIFFMM_FEAT_CACHE")
    if cache_env == "0":
        return None
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return cache_env or os.path.join(repo, "data", ".feat_cache")


def _train_svd_feats(mat: "sp.csr_matrix", k: int) -> np.ndarray:
    """Variance-normalised top-``k`` right singular directions of the train
    matrix, scaled by singular values; deterministic Lanczos (fixed start
    vector), disk cached."""
    crcs = (
        zlib.crc32(mat.indices.tobytes()),
        zlib.crc32(mat.indptr.tobytes()),
        zlib.crc32(mat.data.tobytes()),
    )
    tag = (
        f"{mat.shape[0]}x{mat.shape[1]}_{mat.nnz}"
        f"_{crcs[0]:08x}{crcs[1]:08x}{crcs[2]:08x}_k{k}"
    )
    cache_dir = _svd_cache_dir()
    path = cache_dir and os.path.join(cache_dir, f"svd_{tag}.npy")
    if path and os.path.exists(path):
        return np.load(path)
    from scipy.sparse.linalg import svds

    _, s, vt = svds(mat, k=k, v0=np.ones(min(mat.shape), dtype=np.float32))
    feats = (vt.T * s).astype(np.float32)  # (I, k), top directions last
    feats /= max(float(feats.std()), 1e-8)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:  # np.save(path) would append .npy
            np.save(fh, feats)
        os.replace(tmp, path)
    return feats


@dataclass
class HostData:
    """Everything loaded/derived on host, as numpy."""

    name: str
    user_num: int
    item_num: int
    modalities: list[str]
    feat_dims: list[int]
    train_rows: np.ndarray  # (nnz,) int32, user-major sorted
    train_cols: np.ndarray  # (nnz,) int32
    user_degrees: np.ndarray  # (U,) int32
    csr_offsets: np.ndarray  # (U,) int32
    k_max: int  # max user degree
    raw_feats: list[np.ndarray]  # per modality (I, dim) f32
    test_users: np.ndarray  # (Tu,) int32
    test_items: np.ndarray  # (Tu, maxT) int32, padded with -1
    test_counts: np.ndarray  # (Tu,) int32
    synthesized: list[str] = field(default_factory=list)
    val_users: np.ndarray | None = None
    val_items: np.ndarray | None = None
    val_counts: np.ndarray | None = None
    _train_dense: np.ndarray | None = None

    @property
    def nnz(self) -> int:
        return int(self.train_rows.shape[0])

    @property
    def train_dense(self) -> np.ndarray:
        """(U, I) int8 train matrix, built on first use."""
        if self._train_dense is None:
            dense = np.zeros((self.user_num, self.item_num), dtype=np.int8)
            dense[self.train_rows, self.train_cols] = 1
            self._train_dense = dense
        return self._train_dense


class DeviceData(NamedTuple):
    """Device-resident tensors. ``adj`` is the main-graph adjacency: a
    ``BiAdj`` built here on the sparse form, a ``DenseBiAdj`` set by the
    Coach on the dense form."""

    adj: object
    train_rows: torch.Tensor  # (nnz_pad,) int32, sentinel-padded
    train_cols: torch.Tensor
    user_degrees: torch.Tensor
    csr_offsets: torch.Tensor
    train_store: object  # (U, I) int8 tensor, membership.DenseShard or membership.TrainCSR
    raw_feats: list[torch.Tensor]
    test_users: torch.Tensor
    test_items: torch.Tensor
    test_counts: torch.Tensor
    val_users: torch.Tensor | None
    val_items: torch.Tensor | None
    val_counts: torch.Tensor | None


def load_host_data(config: Config, data_root: str | None = None) -> HostData:
    """Load a dataset and fill ``config.data`` shape fields
    (reference `DataHandler.py:107-131`). ``name = "synthetic"`` (or
    ``synthetic:<users>x<items>[x<density>]``) generates a random dataset."""
    name = config.data.name
    if name.startswith("synthetic"):
        from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data

        if ":" in name:
            parts = name.split(":", 1)[1].lower().split("x")
            kwargs = {"user_num": int(parts[0]), "item_num": int(parts[1])}
            if len(parts) > 2:
                kwargs["density"] = float(parts[2])
            return make_synthetic_host_data(config, seed=config.base.seed, **kwargs)
        return make_synthetic_host_data(config, seed=config.base.seed)
    data_dir = resolve_data_dir(name, data_root)

    train = load_interactions(os.path.join(data_dir, "trnMat.pkl"))
    test = load_interactions(os.path.join(data_dir, "tstMat.pkl"))
    user_num, item_num = train.shape
    config.data.user_num, config.data.item_num = int(user_num), int(item_num)

    order = np.lexsort((train.col, train.row))
    rows = train.row.astype(np.int32)[order]
    cols = train.col.astype(np.int32)[order]
    degrees = np.bincount(rows, minlength=user_num).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(degrees[:-1])]).astype(np.int32)

    missing_mode = config.data.missing_modalities
    env_mode = os.environ.get("DIFFMM_SYNTH_MODE")
    if env_mode and env_mode != missing_mode:
        warnings.warn(
            f"DIFFMM_SYNTH_MODE={env_mode!r} overrides "
            f"data.missing_modalities={missing_mode!r}",
            stacklevel=2,
        )
        missing_mode = env_mode
    if missing_mode not in ("zeros", "drop", "randn", "svd", "svd_tfidf"):
        raise ValueError(
            "data.missing_modalities must be zeros|drop|randn|svd|svd_tfidf, "
            f"got {missing_mode!r}"
        )
    mods, raw_feats, feat_dims, synthesized = [], [], [], []
    for mod in modality_names(name):
        path = os.path.join(data_dir, f"{mod}_feat.npy")
        if os.path.exists(path):
            feats = np.load(path).astype(np.float32)
            if feats.shape[0] != item_num:
                raise ValueError(f"{path}: expected {item_num} rows, got {feats.shape[0]}")
        elif missing_mode == "drop":
            synthesized.append(f"{mod} (dropped)")
            continue
        else:
            feats = _synthesize_features(
                name, mod, item_num, missing_mode, train,
                svd_rank=config.data.synth_svd_rank,
            )
            synthesized.append(mod)
        mods.append(mod)
        raw_feats.append(feats)
        feat_dims.append(int(feats.shape[1]))
    if not mods:
        raise FileNotFoundError(
            f"{name}: no modality feature blobs found and "
            "data.missing_modalities='drop' removed them all"
        )

    dim_fields = {"image": "image_feat_dim", "text": "text_feat_dim", "audio": "audio_feat_dim"}
    for mod, dim in zip(mods, feat_dims):
        setattr(config.data, dim_fields[mod], dim)

    test_users, test_items, t_counts = group_eval_split(test)
    val_users = val_items = val_counts = None
    val_path = os.path.join(data_dir, "valMat.pkl")
    if os.path.exists(val_path):
        val_users, val_items, val_counts = group_eval_split(load_interactions(val_path))

    return HostData(
        name=name,
        user_num=int(user_num),
        item_num=int(item_num),
        modalities=mods,
        feat_dims=feat_dims,
        train_rows=rows,
        train_cols=cols,
        user_degrees=degrees,
        csr_offsets=offsets,
        k_max=int(degrees.max()),
        raw_feats=raw_feats,
        test_users=test_users,
        test_items=test_items,
        test_counts=t_counts,
        synthesized=synthesized,
        val_users=val_users,
        val_items=val_items,
        val_counts=val_counts,
    )


def group_eval_split(mat: sp.coo_matrix):
    """COO eval matrix -> (users, padded per-user item lists, counts)."""
    rows = mat.row.astype(np.int32)
    cols = mat.col.astype(np.int32)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    users, counts = np.unique(rows, return_counts=True)
    max_n = int(counts.max()) if len(counts) else 1
    items = np.full((len(users), max_n), -1, dtype=np.int32)
    start = 0
    for i, c in enumerate(counts):
        items[i, :c] = cols[start : start + c]
        start += c
    return users.astype(np.int32), items, counts.astype(np.int32)


# Edge arrays are padded to this multiple with sentinel (user_num, item_num)
# entries, as in the JAX package (there for even sharding over a mesh); the
# port keeps the layout so edge buffers compare position by position.
EDGE_ALIGN = 256


def pad_edges(
    rows: np.ndarray, cols: np.ndarray, user_num: int, item_num: int,
    multiple: int = EDGE_ALIGN,
) -> tuple[np.ndarray, np.ndarray]:
    pad = -len(rows) % multiple
    if pad:
        rows = np.concatenate([rows, np.full(pad, user_num, dtype=np.int32)])
        cols = np.concatenate([cols, np.full(pad, item_num, dtype=np.int32)])
    return rows, cols


def to_device(
    host: HostData,
    device: torch.device | str,
    train_store: str = "dense",
    with_sparse_adj: bool = False,
    batch: int = 1024,
    store_cols: tuple[int, int] | None = None,
) -> DeviceData:
    """Place the host arrays on ``device`` (JAX ``to_device``).

    ``train_store``: "dense" places the (U, I) int8 matrix (reference
    `DataHandler.py:128`), or a ``membership.DenseShard`` of its catalog
    columns ``store_cols = (lo, hi)`` where they are not the whole catalog,
    cut on the host (a rank's range on the model axis,
    ``parallel/sharding.py::catalog_range``; JAX ``_place_train_store``);
    "csr" a ``TrainCSR`` over the same padded columns, offsets and degrees
    placed here, whole whatever ``store_cols`` says, with the head/tail
    split planned for rebuild blocks of ``batch`` users; the host's dense
    matrix is then never built. ``with_sparse_adj`` builds the sparse-form
    main adjacency from the host edges."""
    rows_p, cols_p = pad_edges(host.train_rows, host.train_cols, host.user_num, host.item_num)

    def put(a):
        return None if a is None else torch.as_tensor(a, device=device)

    cols_dev = put(cols_p)
    degrees_dev = put(host.user_degrees)
    offsets_dev = put(host.csr_offsets)
    if train_store == "dense":
        lo, hi = (0, host.item_num) if store_cols is None else store_cols
        if (lo, hi) == (0, host.item_num):
            store = put(host.train_dense)
        else:
            store = DenseShard(put(np.ascontiguousarray(host.train_dense[:, lo:hi])), lo, hi)
    elif train_store == "csr":
        k_cut, heavy_ids = plan_head_tail(host.user_degrees, host.k_max, block=batch)
        store = make_train_csr(cols_dev, offsets_dev, degrees_dev, host.k_max, k_cut, heavy_ids)
    else:
        raise ValueError(f"train_store must be dense|csr, got {train_store!r}")
    adj = None
    if with_sparse_adj:
        adj = build_bi_adj_host(rows_p, cols_p, host.user_num, host.item_num, device)
    return DeviceData(
        adj=adj,
        train_rows=put(rows_p),
        train_cols=cols_dev,
        user_degrees=degrees_dev,
        csr_offsets=offsets_dev,
        train_store=store,
        raw_feats=[put(f) for f in host.raw_feats],
        test_users=put(host.test_users),
        test_items=put(host.test_items),
        test_counts=put(host.test_counts),
        val_users=put(host.val_users),
        val_items=put(host.val_items),
        val_counts=put(host.val_counts),
    )
