"""Packed int4 dense blocks (``train.dense_store="int4"``) in the port
against the JAX package's int4 blocks and against the port's int8 ones.

torch has no 4-bit type: the port packs two cells a byte
(``ops/kernels/spmm_dual.py``: cell 2j in the low nibble of byte j). What
is held here:
* pack/unpack round trips, odd I and pads included (exact);
* the port's int4 adjacency against JAX ``build_dense_bi_adj_device(
  store_dtype=jnp.int4)``: cells exact, and the propagation at the dense
  form's tolerance (rtol 1e-2, atol 1e-3, as ``tests/test_torch_graph.py``:
  a 1-ulp difference in a scale can flip a bf16 rounding of z);
* K1's plain version on int4 against int8 (bitwise: the same cells) and
  against the Pallas ``_dual_call`` on the JAX int4 block in interpret
  mode (rtol 1e-5, atol 1e-5: exact products, sums in another order);
* the in-place rebuild of the packed storage (same pointer, same bytes);
* one tiny Coach epoch at int4 against the same epoch at int8, bitwise;
* ``choose_graph_form`` and ``estimate_state_bytes`` against the JAX
  package's, int4 blocks and bf16 parameters included.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.ops.graph import _spmm_bi_dense as j_spmm_dense
from diffmm_tpu.ops.graph import build_dense_bi_adj_device as j_build
from diffmm_tpu.ops.pallas.spmm_dual import _dual_call
from diffmm_tpu.train import coach as jcoach
from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
from diffmm_tpu_torch.ops.graph import build_dense_bi_adj_device as t_build
from diffmm_tpu_torch.ops.graph import spmm_bi
from diffmm_tpu_torch.ops.kernels.spmm_dual import (
    dense_storage,
    pack_int4,
    spmm_dual_plain,
    store_kind,
    unpack_int4,
)
from diffmm_tpu_torch.train import coach as tcoach
from diffmm_tpu_torch.train.optim import tree_leaves


def _edges(rng, U, I, nnz, pad):
    flat = rng.choice(U * I, size=nnz, replace=False)
    order = np.argsort(flat // I, kind="stable")
    rows = (flat // I).astype(np.int32)[order]
    cols = (flat % I).astype(np.int32)[order]
    rows = np.concatenate([rows, np.full(pad, U, np.int32)])  # sentinel pads
    cols = np.concatenate([cols, np.full(pad, I, np.int32)])
    return rows, cols


@pytest.mark.parametrize("shape", [(5, 1), (7, 9), (12, 32), (3, 33), (40, 101)])
def test_pack_unpack_round_trip(rng, shape):
    U, I = shape
    cells = torch.as_tensor(rng.integers(-8, 8, size=(U, I)).astype(np.int8))
    packed = pack_int4(cells)
    assert packed.dtype == torch.uint8 and packed.shape == (U, (I + 1) // 2)
    assert torch.equal(unpack_int4(packed, I), cells)
    if I % 2:  # an odd I's last high nibble stays zero
        assert int((packed[:, -1] >> 4).abs().sum()) == 0
    # cell 2j in the low nibble, 2j + 1 in the high one
    assert int(packed[0, 0] & 0xF) == int(cells[0, 0]) & 0xF
    # the padded storage: rows of round_up(I, 32) / 2 bytes, a spare row
    store = dense_storage(U, I, torch.uint8, "cpu")
    assert store.shape == packed.shape and store.stride(0) * 2 % 32 == 0
    assert store.untyped_storage().nbytes() == (U + 1) * store.stride(0)
    store.copy_(packed)
    assert torch.equal(unpack_int4(store, I), cells)
    assert store_kind(store.dtype) == "int4"


@pytest.mark.parametrize("shape", [(37, 29), (20, 64), (9, 1)])
def test_int4_adjacency_matches_jax(rng, shape):
    U, I = shape
    rows, cols = _edges(rng, U, I, min(U * I // 3, 120), 8)
    t = t_build(torch.as_tensor(rows), torch.as_tensor(cols), U, I, torch.uint8)
    j = j_build(jnp.asarray(rows), jnp.asarray(cols), U, I, store_dtype=jnp.int4)
    assert j.mat.dtype == jnp.int4 and t.mat.dtype == torch.uint8
    np.testing.assert_array_equal(unpack_int4(t.mat, I).numpy(), np.asarray(j.mat.astype(jnp.int8)))
    np.testing.assert_allclose(t.s_user.numpy(), np.asarray(j.s_user), rtol=1e-6)
    np.testing.assert_allclose(t.s_item.numpy(), np.asarray(j.s_item), rtol=1e-6)
    assert (t.user_num, t.item_num) == (U, I)

    d = 16
    x_u = rng.standard_normal((U, d)).astype(np.float32)
    x_i = rng.standard_normal((I, d)).astype(np.float32)
    yu, yi = spmm_bi(t, torch.as_tensor(x_u), torch.as_tensor(x_i))
    wu, wi = j_spmm_dense(j, jnp.asarray(x_u), jnp.asarray(x_i))
    np.testing.assert_allclose(yu.numpy(), np.asarray(wu), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(yi.numpy(), np.asarray(wi), rtol=1e-2, atol=1e-3)

    # the same edges at int8: the same cells, so the same propagation, bitwise
    t8 = t_build(torch.as_tensor(rows), torch.as_tensor(cols), U, I, torch.int8)
    y8 = spmm_bi(t8, torch.as_tensor(x_u), torch.as_tensor(x_i))
    assert torch.equal(yu, y8[0]) and torch.equal(yi, y8[1])


@pytest.mark.parametrize("shape", [(70, 50, 16), (33, 131, 32)], ids=["U70xI50", "U33xI131"])
def test_k1_plain_int4_against_int8_and_dual_call(rng, shape):
    U, I, d = shape
    mask = rng.random((U, I)) < 0.1
    z_u = torch.as_tensor(rng.standard_normal((U, d)).astype(np.float32))
    z_i = torch.as_tensor(rng.standard_normal((I, d)).astype(np.float32))
    m8 = torch.as_tensor(mask.astype(np.int8))
    got = spmm_dual_plain(pack_int4(m8), z_u, z_i)
    want8 = spmm_dual_plain(m8, z_u, z_i)
    assert all(torch.equal(a, b) for a, b in zip(got, want8))
    wu, wi = _dual_call(jnp.asarray(mask.astype(np.int8)).astype(jnp.int4), jnp.asarray(z_u.numpy()),
                        jnp.asarray(z_i.numpy()), tu=32, interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(wu), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(wi), rtol=1e-5, atol=1e-5)


def test_int4_rebuild_in_place(rng):
    """``out=`` refills the packed storage where it is (a captured graph
    reads it there): the same pointer, the new graph's bytes, the pads'
    spare row outside the view."""
    U, I = 23, 17
    first = _edges(rng, U, I, 60, 4)
    second = _edges(rng, U, I, 70, 6)
    adj = t_build(*map(torch.as_tensor, first), U, I, torch.uint8)
    ptr = adj.mat.data_ptr()
    again = t_build(*map(torch.as_tensor, second), U, I, torch.uint8, out=adj)
    fresh = t_build(*map(torch.as_tensor, second), U, I, torch.uint8)
    assert again is adj and adj.mat.data_ptr() == ptr
    assert torch.equal(adj.mat, fresh.mat)
    assert torch.equal(adj.s_user, fresh.s_user) and torch.equal(adj.s_item, fresh.s_item)


def _coach(store, seed=7):
    cfg = Config()
    cfg.base.seed = seed
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.train.batch = 16
    cfg.train.test_batch = 8
    cfg.train.graph_form = "dense"
    cfg.train.dense_store = store
    host = make_synthetic_host_data(copy.deepcopy(cfg), user_num=40, item_num=33, seed=3)
    return tcoach.Coach(cfg, host, device="cpu")


def test_int4_epoch_equals_int8_epoch_bitwise():
    c4, c8 = _coach("int4"), _coach("int8")
    assert c4.data.adj.mat.dtype == torch.uint8 and c8.data.adj.mat.dtype == torch.int8
    for epoch in range(2):
        assert c4.train_epoch(epoch) == c8.train_epoch(epoch)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(c4.gcn_params), tree_leaves(c8.gcn_params)))
    assert all(torch.equal(a, b) for a, b in zip(c4.edge_buffers, c8.edge_buffers))
    assert all(a.mat.dtype == torch.uint8 for a in c4.modal_adjs)
    assert c4.test_epoch() == c8.test_epoch()


@pytest.mark.parametrize("store", ["int8", "bf16", "int4"])
@pytest.mark.parametrize("budget_gib", [0.05, 0.2, 4.0])
def test_choose_graph_form_matches_jax(store, budget_gib):
    _, bytes_per_cell = jcoach.resolve_dense_store(store)
    assert tcoach._DENSE_STORES[store][1] == bytes_per_cell
    budget = int(budget_gib * (1 << 30))
    for U, I, M in ((9308, 6710, 3), (38403, 20000, 2), (600, 6710, 2)):
        for form in ("auto", "dense", "sparse"):
            assert tcoach.choose_graph_form(form, M, U, I, bytes_per_cell, budget) == \
                jcoach.choose_graph_form(form, M, U, I, bytes_per_cell=bytes_per_cell,
                                         budget_bytes=budget)


@pytest.mark.parametrize("model_parallel", [1, 2, 4])
def test_choose_graph_form_scales_with_model_axis_as_jax(model_parallel):
    """The dense blocks' budget times the model axis, as JAX's
    ``choose_graph_form`` (tests/test_dense_graph.py:76-84): a shape just
    past one device's budget is sparse at model 1 and dense at 2 and 4."""
    U = 60000
    I = tcoach.DENSE_GRAPH_BUDGET_BYTES // (3 * U * 2) + 100
    for store in ("int8", "bf16", "int4"):
        _, bytes_per_cell = jcoach.resolve_dense_store(store)
        for shape in ((U, I, 2), (9308, 6710, 3), (38403, 20000, 2)):
            u, i, m = shape
            assert tcoach.choose_graph_form("auto", m, u, i, bytes_per_cell, model_parallel=model_parallel) == \
                jcoach.choose_graph_form("auto", m, u, i, model_parallel, bytes_per_cell=bytes_per_cell,
                                         budget_bytes=tcoach.DENSE_GRAPH_BUDGET_BYTES), (store, shape)
    assert tcoach.choose_graph_form("auto", 2, U, I, 2, model_parallel=model_parallel) == (model_parallel > 1)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_estimate_state_bytes_matches_jax(monkeypatch, param_dtype):
    """The Coach's call passes the denoisers' bytes a parameter (2 for bf16,
    as JAX ``coach.py:257``)."""
    cfg = Config()
    cfg.base.denoise_param_dtype = param_dtype
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.train.batch = 16
    host = make_synthetic_host_data(copy.deepcopy(cfg), user_num=40, item_num=33, seed=3)
    seen = []
    real = tcoach.estimate_state_bytes

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(tcoach, "estimate_state_bytes", spy)
    tcoach.Coach(cfg, host, device="cpu")
    want = jcoach.estimate_state_bytes(3, 40, 33, 16, [32], 10, host.feat_dims,
                                       param_bytes=2 if param_dtype == "bf16" else 4)
    assert seen == [want]
    for hidden in ([1024], [64, 32]):
        for pb in (2, 4):
            assert tcoach.estimate_state_bytes(2, 9308, 6710, 64, hidden, 10, [128, 768], pb) == \
                jcoach.estimate_state_bytes(2, 9308, 6710, 64, hidden, 10, [128, 768], param_bytes=pb)
