"""The port's membership test and negative sampling
(diffmm_tpu_torch/data/membership.py::contains, data/sampling.py) against
diffmm_tpu's, on the dense and the CSR train store, a synthetic 50 x 40
dataset and the tiktok_mini store with its head/tail split (max degree 576,
so the CSR search runs 10 rounds over spans of up to 576 items).

Everything is integer or boolean, so every comparison is exact. The
negatives are fed the JAX draws (``jax.random.randint`` per subkey of
``jax.random.split(key, 8)``, as ``negative_sampling`` draws them); on the
dense store every lane is compared, the edge pads included (both packages
clamp a pad's user to the last one there); on the CSR store the JAX
``take`` fills a pad's span bounds with INT_MIN, so only the real lanes,
the only ones the joint phase reads, are compared.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.config import Config as JConfig
from diffmm_tpu.data import membership as jm
from diffmm_tpu.data.loader import to_device as j_to_device
from diffmm_tpu.data.sampling import negative_sampling as j_negs
from diffmm_tpu.data.synthetic import make_synthetic_host_data as j_synth
from diffmm_tpu_torch.config import Config as TConfig
from diffmm_tpu_torch.data import membership as tm
from diffmm_tpu_torch.data.loader import load_host_data, to_device
from diffmm_tpu_torch.data.sampling import negative_sampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synthetic(store):
    jcfg = JConfig()
    host = j_synth(jcfg, user_num=50, item_num=40, density=0.2, seed=3)
    j_store = j_to_device(host, train_store=store).train_store
    t_data = to_device(host, "cpu", train_store=store)
    return host, j_store, t_data


@pytest.fixture(scope="module")
def mini():
    cfg = TConfig()
    cfg.data.name = "tiktok_mini"
    host = load_host_data(cfg, data_root=os.path.join(REPO, "data"))
    t_data = to_device(host, "cpu", train_store="csr", batch=256)
    store = t_data.train_store
    j_store = jm.make_train_csr(jnp.asarray(store.cols.numpy()), jnp.asarray(host.csr_offsets),
                                jnp.asarray(host.user_degrees), host.k_max, store.k_cut,
                                store.heavy_ids.numpy())
    return host, j_store, t_data


def _queries(host, rng, n=600):
    """Train edges (hits), random pairs (mostly misses) and each user's
    first and last items with their neighbours (the search's edges)."""
    rows, cols = host.train_rows, host.train_cols
    pick = rng.integers(0, len(rows), n)
    users = np.concatenate([rows[pick], rng.integers(0, host.user_num, n)])
    items = np.concatenate([cols[pick], rng.integers(0, host.item_num, n)])
    off, deg = host.csr_offsets, host.user_degrees
    u = np.flatnonzero(deg > 0)[:200]
    first, last = cols[off[u]], cols[off[u] + deg[u] - 1]
    users = np.concatenate([users, u, u, u, u])
    items = np.concatenate([items, first, last, np.maximum(first - 1, 0),
                            np.minimum(last + 1, host.item_num - 1)])
    return users.astype(np.int32), items.astype(np.int32)


@pytest.mark.parametrize("store", ["dense", "csr"])
def test_contains_matches_synthetic(rng, store):
    host, j_store, t_data = _synthetic(store)
    users, items = _queries(host, rng)
    got = tm.contains(t_data.train_store, torch.as_tensor(users), torch.as_tensor(items)).numpy()
    want = np.asarray(jm.contains(j_store, jnp.asarray(users), jnp.asarray(items)))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_contains_matches_head_tail_store(mini, rng):
    host, j_store, t_data = mini
    store = t_data.train_store
    assert store.heavy_ids is not None and store.k_cut < store.k_max
    users, items = _queries(host, rng)
    heavy = store.heavy_ids.numpy()
    hu = np.repeat(heavy, 8)  # the heavy users' spans, the longest searches
    hi = rng.integers(0, host.item_num, len(hu)).astype(np.int32)
    users, items = np.concatenate([users, hu]), np.concatenate([items, hi])
    got = tm.contains(store, torch.as_tensor(users), torch.as_tensor(items)).numpy()
    want = np.asarray(jax.jit(jm.contains)(j_store, jnp.asarray(users), jnp.asarray(items)))
    np.testing.assert_array_equal(got, want)
    dense = host.train_dense[users, items] != 0
    np.testing.assert_array_equal(got, dense)


def _jax_draws(key, n, item_num, rounds=8):
    return np.stack([np.asarray(jax.random.randint(k, (n,), 0, item_num, dtype=jnp.int32))
                     for k in jax.random.split(key, rounds)])


@pytest.mark.parametrize("store", ["dense", "csr"])
def test_negative_sampling_matches_on_jax_draws(store):
    host, j_store, t_data = _synthetic(store)
    rows = t_data.train_rows
    key = jax.random.PRNGKey(11)
    want = np.asarray(j_negs(key, jnp.asarray(rows.numpy()), j_store, host.item_num))
    draws = torch.as_tensor(_jax_draws(key, rows.shape[0], host.item_num))
    got = negative_sampling(rows, t_data.train_store, host.item_num, draws=draws).numpy()
    assert got.dtype == np.int32
    real = slice(0, host.nnz)
    np.testing.assert_array_equal(got[real], want[real])
    if store == "dense":
        np.testing.assert_array_equal(got, want)  # the pads too
    # density 0.2 and 8 rounds: the negatives are not train items
    hit = host.train_dense[host.train_rows, got[real]] != 0
    assert hit.mean() < 1e-3


def test_negative_sampling_matches_on_tiktok_mini(mini):
    host, j_store, t_data = mini
    rows = t_data.train_rows
    key = jax.random.PRNGKey(5)
    want = np.asarray(j_negs(key, jnp.asarray(rows.numpy()), j_store, host.item_num))
    draws = torch.as_tensor(_jax_draws(key, rows.shape[0], host.item_num))
    got = negative_sampling(rows, t_data.train_store, host.item_num, draws=draws).numpy()
    np.testing.assert_array_equal(got[:host.nnz], want[:host.nnz])


def test_negative_sampling_draws_from_the_generator():
    host, _, t_data = _synthetic("csr")
    a = negative_sampling(t_data.train_rows, t_data.train_store, host.item_num,
                          generator=torch.Generator().manual_seed(1))
    b = negative_sampling(t_data.train_rows, t_data.train_store, host.item_num,
                          generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < host.item_num
