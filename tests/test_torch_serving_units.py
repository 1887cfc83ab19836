"""The port's CSR seen lists and the per-request padded gather
(``eval/serving.py::seen_csr_from_edges``, ``_gather_seen``), after
``tests/test_serving_units.py``: CSR construction against a brute force and
the JAX package's, the gather's pads, bounds and empty CSR, each against
the JAX package's ``_gather_seen``. (The JAX file's fifth test holds the
XLA compile-variant fingerprint, which the port has no counterpart of: a
request compiles nothing.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.eval import serving as js
from diffmm_tpu_torch.eval.serving import RecIndex, _gather_seen, seen_csr_from_edges


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors: beside the other test
    workers, several threads a process spin against each other (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _index(indptr, indices, item_num: int) -> RecIndex:
    deg = np.diff(indptr)
    return RecIndex(torch.zeros((len(indptr) - 1, 2)), torch.zeros((item_num, 2)), torch.as_tensor(indptr),
                    torch.as_tensor(indices), max(int(deg.max()) if deg.size else 1, 1))


def test_csr_from_edges_matches_bruteforce():
    rows = np.array([2, 0, 2, 1, 2, 0], dtype=np.int32)
    cols = np.array([5, 1, 7, 3, 9, 4], dtype=np.int32)
    indptr, indices, width = seen_csr_from_edges(rows, cols, user_num=4)
    assert indptr.tolist() == [0, 2, 3, 6, 6]
    assert indices.tolist() == [1, 4, 3, 5, 7, 9]  # user-major, stable within a user
    assert width == 3  # user 2's degree
    assert indices.nbytes == len(rows) * 4  # O(nnz), no padding
    for got, want in zip((indptr, indices, width), js.seen_csr_from_edges(rows, cols, 4)):
        np.testing.assert_array_equal(got, want)


def test_csr_empty_edges():
    indptr, indices, width = seen_csr_from_edges(np.array([], np.int32), np.array([], np.int32), user_num=3)
    assert indptr.tolist() == [0, 0, 0, 0]
    assert len(indices) == 0 and width == 1


def test_gather_seen_pads_and_bounds():
    indptr = np.array([0, 2, 3, 6, 6], dtype=np.int32)
    indices = np.array([1, 4, 3, 5, 7, 9], dtype=np.int32)
    users = np.array([0, 2, 3], dtype=np.int32)
    seen = _gather_seen(_index(indptr, indices, 10), torch.as_tensor(users).long()).numpy()
    assert seen.tolist() == [[1, 4, 10], [5, 7, 9], [10, 10, 10]]  # the last user's lanes clip, all pads
    want = js._gather_seen(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(users), 3, 10)
    np.testing.assert_array_equal(seen, np.asarray(want))


def test_gather_seen_empty_csr():
    seen = _gather_seen(_index(np.zeros(4, np.int32), np.zeros(0, np.int32), 7), torch.tensor([0, 2]))
    assert seen.shape == (2, 1) and (seen == 7).all()
