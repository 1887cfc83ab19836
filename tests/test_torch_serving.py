"""Port serving (diffmm_tpu_torch/eval/serving.py) against
diffmm_tpu/eval/serving.py: an index saved by either package loads in the
other and answers with the same top-k (ids exactly on tie-free scores,
scores at rtol 1e-6); seen items are never served."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.eval import serving as js
from diffmm_tpu_torch.eval import serving as ts


def _edges(rng, U, I):
    dense = rng.random((U, I)) < 0.15
    dense[:, 0] = True  # every user has a seen item
    rows, cols = np.nonzero(dense)
    return rows.astype(np.int32), cols.astype(np.int32)


def _jax_index(rng, U=30, I=50, d=8):
    rows, cols = _edges(rng, U, I)
    indptr, indices, width = js.seen_csr_from_edges(rows, cols, U)
    return js.RecIndex(
        u_final=jnp.asarray(rng.standard_normal((U, d)).astype(np.float32)),
        i_final=jnp.asarray(rng.standard_normal((I, d)).astype(np.float32)),
        seen_indptr=jnp.asarray(indptr), seen_indices=jnp.asarray(indices), seen_width=width,
    )


def _same_answers(t_index, j_index, users, k, mask_seen=True):
    ids_t, sc_t = ts.recommend(t_index, torch.as_tensor(users), k, mask_seen)
    ids_j, sc_j = js.recommend(j_index, jnp.asarray(users), k, mask_seen)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-6)
    return ids_t.numpy()


def test_seen_csr_matches(rng):
    rows, cols = _edges(rng, 20, 30)
    perm = rng.permutation(len(rows))
    for a, b in zip(ts.seen_csr_from_edges(rows[perm], cols[perm], 20),
                    js.seen_csr_from_edges(rows[perm], cols[perm], 20)):
        np.testing.assert_array_equal(a, b)


def test_jax_export_loads_in_port(rng, tmp_path):
    j_index = _jax_index(rng)
    path = str(tmp_path / "jax_index.npz")
    js.save_index(j_index, path)
    t_index = ts.load_index(path, device="cpu")
    users = np.array([0, 3, 7, 29], np.int32)
    for k in (1, 5, 20):
        ids = _same_answers(t_index, j_index, users, k)
        indptr, indices = np.asarray(j_index.seen_indptr), np.asarray(j_index.seen_indices)
        for row, u in zip(ids, users):
            assert not set(row) & set(indices[indptr[u]:indptr[u + 1]])
    _same_answers(t_index, j_index, users, 7, mask_seen=False)


def test_port_export_loads_in_jax(rng, tmp_path):
    j_src = _jax_index(rng)
    t_index = ts.RecIndex(
        u_final=torch.as_tensor(np.asarray(j_src.u_final)),
        i_final=torch.as_tensor(np.asarray(j_src.i_final)),
        seen_indptr=torch.as_tensor(np.asarray(j_src.seen_indptr)),
        seen_indices=torch.as_tensor(np.asarray(j_src.seen_indices)),
        seen_width=int(j_src.seen_width),
    )
    path = str(tmp_path / "port_index.npz")
    ts.save_index(t_index, path)
    j_index = js.load_index(path)
    _same_answers(t_index, j_index, np.arange(10, dtype=np.int32), 20)


def test_recommend_validates_k(rng):
    j_index = _jax_index(rng)
    t_index = ts.RecIndex(*(torch.as_tensor(np.asarray(a)) for a in j_index[:4]),
                          seen_width=int(j_index.seen_width))
    for bad in (0, 51):
        with pytest.raises(ValueError):
            ts.recommend(t_index, torch.tensor([0]), bad)
