"""The port's CSR train store (diffmm_tpu_torch/data/membership.py) against
diffmm_tpu/data/membership.py on the tiktok_mini degrees, whose skew (max
576, median 2) makes the head/tail split trigger: plan_head_tail, the span
table of gather_item_lists, and gather_rows, whose rows must be
bit-identical to the dense store's and to JAX's CSR rows. Everything here is
integer or 0/1, so every comparison is exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.data import membership as jm
from diffmm_tpu.data.loader import to_device as j_to_device
from diffmm_tpu.data.loader import load_host_data as j_load
from diffmm_tpu.config import Config as JConfig
from diffmm_tpu_torch.config import Config as TConfig
from diffmm_tpu_torch.convert import train_csr_from_jax
from diffmm_tpu_torch.data import membership as tm
from diffmm_tpu_torch.data.loader import load_host_data, to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 256


@pytest.fixture(scope="module")
def mini():
    cfg = TConfig()
    cfg.data.name = "tiktok_mini"
    host = load_host_data(cfg, data_root=os.path.join(REPO, "data"))
    csr = to_device(host, "cpu", train_store="csr", batch=BATCH)
    assert host._train_dense is None  # the CSR store builds no (U, I) matrix
    return host, csr.train_store


@pytest.mark.parametrize("block", [64, 256, 1024])
def test_plan_head_tail_matches(mini, block):
    host, _ = mini
    t = tm.plan_head_tail(host.user_degrees, host.k_max, block)
    j = jm.plan_head_tail(host.user_degrees, host.k_max, block)
    assert t[0] == j[0] and t[0] < host.k_max  # the split triggers
    np.testing.assert_array_equal(t[1], j[1])
    uniform = np.full(40, 3, np.int32)  # no skew: no split
    assert tm.plan_head_tail(uniform, 3, block) == jm.plan_head_tail(uniform, 3, block) == (3, None)


def _blocks(host, store, rng):
    heavy = store.heavy_ids.numpy()
    light = np.setdiff1d(np.arange(host.user_num), heavy)
    return [
        rng.integers(0, host.user_num, BATCH),  # mixed
        heavy[:7],  # all heavy
        light[:9],  # none heavy
        np.concatenate([heavy[:2], heavy[:2], light[:3]]),  # duplicate heavy users
    ]


def test_gather_rows_bit_identical(mini, rng):
    host, store = mini
    assert store.heavy_ids is not None and store.k_cut < store.k_max
    dense = torch.as_tensor(host.train_dense)
    j_csr = jm.make_train_csr(jnp.asarray(store.cols.numpy()), jnp.asarray(host.csr_offsets),
                              jnp.asarray(host.user_degrees), host.k_max, store.k_cut,
                              store.heavy_ids.numpy())
    j_gather = jax.jit(jm.gather_rows, static_argnums=2)
    for users in _blocks(host, store, rng):
        t_users = torch.as_tensor(users.astype(np.int32))
        got = tm.gather_rows(store, t_users, host.item_num)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), tm.gather_rows(dense, t_users, host.item_num).numpy())
        want = j_gather(j_csr, jnp.asarray(users.astype(np.int32)), host.item_num)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_item_lists_matches(mini, rng):
    host, store = mini
    users = rng.integers(0, host.user_num, 33).astype(np.int32)
    items, valid = tm.gather_item_lists(store, torch.as_tensor(users))
    j_csr = jm.make_train_csr(jnp.asarray(store.cols.numpy()), jnp.asarray(host.csr_offsets),
                              jnp.asarray(host.user_degrees), host.k_max)
    j_items, j_valid = jm.gather_item_lists(j_csr, jnp.asarray(users))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(np.where(valid.numpy(), items.numpy(), -1),
                                  np.where(np.asarray(j_valid), np.asarray(j_items), -1))


def test_store_from_jax_loader(mini):
    """The JAX loader's CSR store, carried over, equals the port's."""
    host, store = mini
    jcfg = JConfig()
    jcfg.data.name = "tiktok_mini"
    j_host = j_load(jcfg, data_root=os.path.join(REPO, "data"))
    j_store = j_to_device(j_host, with_sparse_adj=False, train_store="csr", batch=BATCH).train_store
    got = train_csr_from_jax(jax.device_get(j_store))
    assert (got.k_max, got.k_cut) == (store.k_max, store.k_cut)
    for name in ("cols", "offsets", "degrees", "heavy_ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(store, name).numpy())
