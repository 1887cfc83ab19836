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


def _tiny_coach(form: str):
    """tests/conftest.py's tiny configuration (50 x 40, seed 3) on the CPU,
    in ``form``, fused chunks of two epochs."""
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import NullLog

    cfg = TConfig()
    cfg.base.seed = 7
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.train.batch = 16
    cfg.train.test_batch = 8
    cfg.train.epoch = 3
    cfg.hyper.steps = 5
    cfg.train.graph_form = form
    cfg.train.epoch_scan = 2
    host = make_synthetic_host_data(cfg, user_num=50, item_num=40, seed=3)
    host._train_dense = None  # a small shape's synthetic data keeps its dense matrix
    return Coach(cfg, host, device="cpu", log=NullLog())


def test_sparse_form_has_no_ui_array():
    """The web-scale contract (the twin of tests/test_membership.py:205-229):
    a sparse-form Coach holds no O(U·I) array, on the card or on the host,
    after a single epoch, an eval and a fused chunk with its evals. The
    walk covers the Coach's data, store, adjacencies, parameters, Adam
    states, edge buffers, captured-step buffers and host data."""
    from diffmm_tpu_torch.utils.contracts import assert_no_ui_arrays

    coach = _tiny_coach("sparse")
    assert isinstance(coach.data.train_store, tm.TrainCSR)
    coach.train_epoch(0)
    coach.test_epoch()
    coach.train_epochs_fused(1, 2, "test")
    assert assert_no_ui_arrays(vars(coach), 50, 40, "coach") > 50
    assert coach.host._train_dense is None, "host dense matrix was materialized"


def test_ui_walk_fails_on_the_dense_form():
    """The control: a dense-form Coach holds its (U, I) train store and
    blocks, and the walk fails on them, naming where (so the walk above is
    not vacuous); so does a plain object's attribute, a NamedTuple's field
    and a numpy array of U·I elements in another shape."""
    import collections

    from diffmm_tpu_torch.utils.contracts import assert_no_ui_arrays

    coach = _tiny_coach("dense")
    with pytest.raises(AssertionError, match=r"coach\['data'\]\.train_store.*\(50, 40\)"):
        assert_no_ui_arrays(vars(coach), 50, 40, "coach")

    class Holder:
        def __init__(self, x):
            self.x = x

    pair = collections.namedtuple("Pair", "a b")
    with pytest.raises(AssertionError, match=r"root\.x\.b"):
        assert_no_ui_arrays(Holder(pair(torch.zeros(3), np.zeros(2000, np.int8))), 50, 40, "root")
    held = Holder(None)
    held.x = [held, {"ok": torch.zeros((49, 40))}]  # a cycle, walked once
    assert assert_no_ui_arrays(held, 50, 40, "root") == 1
