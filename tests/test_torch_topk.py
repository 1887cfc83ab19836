"""Port rebuild top-k (diffmm_tpu_torch/ops/topk.py) against diffmm_tpu:
bucket plans and the CSR gather layout on the tiktok_mini degrees (integers,
compared exactly), topk_table on tie-free scores (exactly), and the edge
buffer built from a table (exactly)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.ops import topk as jt
from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.loader import load_host_data
from diffmm_tpu_torch.ops import topk as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mini_degrees():
    cfg = Config()
    cfg.data.name = "tiktok_mini"
    return load_host_data(cfg, data_root=os.path.join(REPO, "data")).user_degrees


@pytest.mark.parametrize("batch", [64, 256, 1024])
def test_bucket_plan_matches_on_tiktok_mini(mini_degrees, batch):
    t = tt.plan_rebuild_buckets(mini_degrees, batch, 6710)
    j = jt.plan_rebuild_buckets(mini_degrees, batch, 6710)
    assert t.widths == j.widths and t.row_starts == j.row_starts
    assert len(t.user_blocks) == len(j.user_blocks)
    for a, b in zip(t.user_blocks, j.user_blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.row_of_user, j.row_of_user)
    if batch == 64:  # real degree skew: a k_max bucket and a narrow tail
        assert len(t.widths) == 2 and t.widths[0] == int(mini_degrees.max())


def test_csr_gather_layout_matches(mini_degrees):
    buf_len = int(mini_degrees.sum()) + 37
    for a, b in zip(tt.make_csr_gather_layout(mini_degrees, buf_len),
                    jt.make_csr_gather_layout(mini_degrees, buf_len)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tt.make_csr_gather_layout(mini_degrees, 10)


def test_topk_table_and_gather_build_match(rng):
    U, I, k = 30, 50, 7
    # tie-free scores: a permutation per row
    scores = np.stack([rng.permutation(I) for _ in range(U)]).astype(np.float32)
    table = tt.topk_table(torch.as_tensor(scores), k)
    assert table.dtype == torch.int32
    # the port's one top-k against both of the JAX package's forms
    for impl in ("approx", "exact"):
        want = jt.topk_table(jnp.asarray(scores), k, impl)
        np.testing.assert_array_equal(table.numpy(), np.asarray(want))
    degrees = rng.integers(1, k + 1, U)
    u_of_pos, lane_of_pos, pad_mask = tt.make_csr_gather_layout(degrees, int(degrees.sum()) + 5)
    got = tt.csr_gather_build(table, torch.as_tensor(u_of_pos), torch.as_tensor(lane_of_pos),
                              torch.as_tensor(pad_mask), I)
    want = jt.csr_gather_build(jnp.asarray(table.numpy()), jnp.asarray(u_of_pos),
                               jnp.asarray(lane_of_pos), jnp.asarray(pad_mask), I)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[-5:] == I).all()
