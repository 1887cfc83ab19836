"""The port's graph normalisation and propagation against scipy, after
``tests/test_graph_ops.py`` (a mirror of reference `DataHandler.py:52-93`):
``D^-1/2 (A + I) D^-1/2`` over the bipartite (U + I) graph. The sparse form
(f32) is held against the scipy matrix built densely from it (the
propagation of the identity), the host and device builds against each
other, and an isolated node keeps its own embedding (self-loop weight 1)
on both graph forms.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from diffmm_tpu_torch.ops.graph import build_bi_adj_device, build_bi_adj_host, build_dense_bi_adj_device, spmm_bi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors: beside the other test
    workers, several threads a process spin against each other (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_norm_adj(rows, cols, U, I):
    """Scipy mirror of reference DataHandler.makeTorchAdj + normalizeAdj."""
    mat = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(U, I))
    adj = sp.vstack([sp.hstack([sp.csr_matrix((U, U)), mat]), sp.hstack([mat.T, sp.csr_matrix((I, I))])]).tocoo()
    adj = ((adj != 0) * 1.0 + sp.eye(adj.shape[0])) * 1.0
    degree = np.asarray(adj.tocsr().sum(axis=1)).squeeze()
    d_mat = sp.diags(np.where(degree > 0, degree ** -0.5, 0))
    return (d_mat @ adj @ d_mat).toarray()


def _random_edges(rng, U, I, nnz):
    pairs = set()
    while len(pairs) < nnz:
        pairs.add((int(rng.integers(U)), int(rng.integers(I))))
    rows, cols = map(np.array, zip(*sorted(pairs)))
    return rows.astype(np.int32), cols.astype(np.int32)


def _dense_of(adj, U, I) -> np.ndarray:
    """The (U + I) x (U + I) matrix a propagation applies: its columns are
    the propagation of the identity."""
    eye = torch.eye(U + I, dtype=torch.float32)
    y_u, y_i = spmm_bi(adj, eye[:U], eye[U:])
    return torch.cat([y_u, y_i]).numpy()


def test_bi_adj_matches_scipy(rng):
    U, I = 17, 23
    rows, cols = _random_edges(rng, U, I, 60)
    want = _reference_norm_adj(rows, cols, U, I)
    np.testing.assert_allclose(_dense_of(build_bi_adj_host(rows, cols, U, I), U, I), want, rtol=1e-6, atol=1e-6)


def test_spmm_matches_dense(rng):
    U, I, d = 11, 13, 8
    rows, cols = _random_edges(rng, U, I, 30)
    adj = build_bi_adj_host(rows, cols, U, I)
    x_u = torch.as_tensor(rng.standard_normal((U, d)), dtype=torch.float32)
    x_i = torch.as_tensor(rng.standard_normal((I, d)), dtype=torch.float32)
    y_u, y_i = spmm_bi(adj, x_u, x_i)
    want = _reference_norm_adj(rows, cols, U, I) @ np.concatenate([x_u.numpy(), x_i.numpy()])
    np.testing.assert_allclose(y_u.numpy(), want[:U], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_i.numpy(), want[U:], rtol=1e-5, atol=1e-5)


def test_device_build_matches_host(rng):
    U, I = 9, 12
    rows, cols = _random_edges(rng, U, I, 25)
    host_adj = build_bi_adj_host(rows, cols, U, I)
    dev_adj = build_bi_adj_device(torch.as_tensor(rows), torch.as_tensor(cols), U, I)
    np.testing.assert_allclose(_dense_of(dev_adj, U, I), _dense_of(host_adj, U, I), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_isolated_nodes_get_selfloop_only(form):
    """Zero degree: deg + 1 = 1, s = 1, y = x for that row."""
    U, I = 6, 6
    rows = torch.tensor([0, 1], dtype=torch.int32)
    cols = torch.tensor([0, 1], dtype=torch.int32)
    adj = (build_bi_adj_device(rows, cols, U, I) if form == "sparse"
           else build_dense_bi_adj_device(rows, cols, U, I))
    y_u, y_i = spmm_bi(adj, torch.ones((U, 4)), torch.ones((I, 4)))
    np.testing.assert_array_equal(y_u[5].numpy(), np.ones(4))
    np.testing.assert_array_equal(y_i[5].numpy(), np.ones(4))
