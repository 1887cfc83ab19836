"""The port's sparse graph form (diffmm_tpu_torch/ops/graph.py) against
diffmm_tpu/ops/graph.py: both BiAdj builds, spmm_bi on a BiAdj (the JAX XLA
scatter route and its Pallas plan route in interpret mode), and the stacked
modal propagation against JAX's with its plans.

Tolerances: indices, permutations and offsets are compared exactly (the
item-major permutation comes from a stable sort on both sides). The host
build's scales are f64 rounded to f32 on both sides, so exact; the device
build's are f32 rsqrt on two stacks, rtol 1e-6. Propagations sum the same
messages in another f32 order: rtol 1e-5, atol 1e-6 (bf16 messages too:
the rounded messages are equal and summed in f32). The port's sparse form
with bf16 messages rounds z as its dense form does, so the two agree to the
same f32 tolerance; with f32 messages they differ by the dense form's bf16
rounding of z (2^-9 relative per message, sums of about ten O(1)
messages): rtol 1e-2, atol 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.ops import graph as jg
from diffmm_tpu.ops.pallas.segsum import make_ranked_plan, make_segsum_plan
from diffmm_tpu_torch.convert import bi_adj_from_jax
from diffmm_tpu_torch.ops import graph as tg

U, I, D, M, PAD = 37, 29, 16, 3, 11


def _edges(rng, nnz=170):
    """Unique user-major edges plus sentinel pads (the loader's layout)."""
    flat = np.sort(rng.choice(U * I, size=nnz, replace=False))
    rows = np.concatenate([flat // I, np.full(PAD, U)]).astype(np.int32)
    cols = np.concatenate([flat % I, np.full(PAD, I)]).astype(np.int32)
    return rows, cols


def _modal_edges(rng, rows):
    """A rebuilt modality graph's layout: the train rows, one item per slot,
    items repeated across users (ties for the item-major sort)."""
    cols = rng.integers(0, I // 2, len(rows)).astype(np.int32)
    cols[rows == U] = I
    return cols


def _assert_same_adj(t, j, exact_scales):
    for name in ("ui_rows", "ui_cols", "iu_perm", "iu_inv"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), name)
    rtol = 0 if exact_scales else 1e-6
    np.testing.assert_allclose(t.s_user.numpy(), np.asarray(j.s_user), rtol=rtol)
    np.testing.assert_allclose(t.s_item.numpy(), np.asarray(j.s_item), rtol=rtol)
    iu_rows = np.asarray(j.ui_cols)[np.asarray(j.iu_perm)]
    np.testing.assert_array_equal(t.iu_rows.numpy(), iu_rows)
    np.testing.assert_array_equal(t.iu_cols.numpy(), np.asarray(j.ui_rows)[np.asarray(j.iu_perm)])
    np.testing.assert_array_equal(t.ui_offsets.numpy(), np.searchsorted(np.asarray(j.ui_rows), np.arange(U + 1)))
    np.testing.assert_array_equal(t.iu_offsets.numpy(), np.searchsorted(iu_rows, np.arange(I + 1)))


def test_build_bi_adj_host_matches(rng):
    rows, cols = _edges(rng)
    perm = rng.permutation(len(rows))  # the host build sorts by user itself
    t = tg.build_bi_adj_host(rows[perm], cols[perm], U, I)
    j = jg.build_bi_adj_host(rows[perm], cols[perm], U, I)
    _assert_same_adj(t, j, exact_scales=True)
    _assert_same_adj(bi_adj_from_jax(jax.device_get(j)), j, exact_scales=True)


def test_build_bi_adj_device_matches(rng):
    rows, _ = _edges(rng)
    cols = _modal_edges(rng, rows)
    t = tg.build_bi_adj_device(torch.as_tensor(rows), torch.as_tensor(cols), U, I)
    j = jg.build_bi_adj_device(jnp.asarray(rows), jnp.asarray(cols), U, I)
    _assert_same_adj(t, j, exact_scales=False)
    assert t.iu_offsets[-1] == (rows < U).sum()  # the pads lie past the last item


@pytest.mark.parametrize("route", ["xla", "plans_f32", "plans_bf16"])
def test_spmm_bi_sparse_matches(rng, route):
    rows, cols = _edges(rng)
    x_u = rng.standard_normal((U, D)).astype(np.float32)
    x_i = rng.standard_normal((I, D)).astype(np.float32)
    j_adj = jg.build_bi_adj_host(rows, cols, U, I)
    compute = "bf16" if route == "plans_bf16" else "f32"
    plans = (None, None)
    if route != "xla":
        plans = (make_segsum_plan(rows, U, D, chunk=64),
                 make_segsum_plan(np.sort(cols), I, D, chunk=64))
        assert None not in plans
    want = jg.spmm_bi(j_adj, jnp.asarray(x_u), jnp.asarray(x_i), plans, compute)
    t_adj = tg.build_bi_adj_host(rows, cols, U, I)
    got = tg.spmm_bi(t_adj, torch.as_tensor(x_u), torch.as_tensor(x_i), compute)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def _modal_adjs(rng):
    rows, _ = _edges(rng)
    cols = [_modal_edges(rng, rows) for _ in range(M)]
    j_adjs = [jg.build_bi_adj_device(jnp.asarray(rows), jnp.asarray(c), U, I, with_rank_aux=True)
              for c in cols]
    t_rows = torch.as_tensor(rows)
    t_adjs = [tg.build_bi_adj_device(t_rows, torch.as_tensor(c), U, I) for c in cols]
    return rows, j_adjs, t_adjs


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_stacked_matches_jax_stacked(rng, compute):
    rows, j_adjs, t_adjs = _modal_adjs(rng)
    x_user = rng.standard_normal((U, D)).astype(np.float32)
    feats = [rng.standard_normal((I, D)).astype(np.float32) for _ in range(M)]
    wide_plan = make_segsum_plan(rows, U, d=M * D, chunk=64)
    item_plan = make_ranked_plan(len(rows), d=D, chunk=64)
    want = jg.spmm_bi_modal_stacked(j_adjs, jnp.asarray(x_user), [jnp.asarray(f) for f in feats],
                                    wide_plan, item_plan, compute)
    got = tg.spmm_bi_modal_stacked(t_adjs, torch.as_tensor(x_user),
                                   [torch.as_tensor(f) for f in feats], compute)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # the stacked form sums each column in the loop's order: equal bitwise
    for m in range(M):
        mu, mi = tg.spmm_bi(t_adjs[m], torch.as_tensor(x_user), torch.as_tensor(feats[m]), compute)
        torch.testing.assert_close(got[0][m], mu, rtol=0, atol=0)
        torch.testing.assert_close(got[1][m], mi, rtol=0, atol=0)


def test_stacked_asserts_shared_rows(rng):
    _, _, t_adjs = _modal_adjs(rng)
    shifted = t_adjs[1]._replace(ui_rows=torch.roll(t_adjs[1].ui_rows, 1))
    x = torch.zeros((U, D))
    with pytest.raises(ValueError, match="share ui_rows"):
        tg.spmm_bi_modal_stacked([t_adjs[0], shifted], x, [torch.zeros((I, D))] * 2)
    # equal rows held in another tensor are accepted
    same = t_adjs[1]._replace(ui_rows=t_adjs[1].ui_rows.clone())
    tg.spmm_bi_modal_stacked([t_adjs[0], same], x, [torch.zeros((I, D))] * 2)


def test_sparse_form_agrees_with_dense_form(rng):
    rows, cols = _edges(rng)
    x_u = torch.as_tensor(rng.standard_normal((U, D)).astype(np.float32))
    x_i = torch.as_tensor(rng.standard_normal((I, D)).astype(np.float32))
    t_rows, t_cols = torch.as_tensor(rows), torch.as_tensor(cols)
    sparse = tg.build_bi_adj_device(t_rows, t_cols, U, I)
    dense = tg.spmm_bi(tg.build_dense_bi_adj_device(t_rows, t_cols, U, I), x_u, x_i)
    for s, d in zip(tg.spmm_bi(sparse, x_u, x_i, "bf16"), dense):
        torch.testing.assert_close(s, d, rtol=1e-5, atol=1e-6)
    for s, d in zip(tg.spmm_bi(sparse, x_u, x_i, "f32"), dense):
        torch.testing.assert_close(s, d, rtol=1e-2, atol=1e-2)
