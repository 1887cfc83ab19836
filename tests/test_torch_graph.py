"""Port dense graph form (diffmm_tpu_torch/ops/graph.py) and the K1 plain
version against diffmm_tpu: build_dense_bi_adj_device, spmm_bi (dense
dispatch) and _dual_call in interpret mode, int8 and bf16 storage, at
ragged U and I.

Tolerances: the adjacency and degrees are integers, compared exactly. The
K1 plain version against _dual_call takes the same bf16-rounded operands
and sums exact products in f32, so only the summation order differs: rtol
1e-5, atol 1e-5. spmm_bi scales z by s before the bf16 rounding; 1-ulp
differences in s (rsqrt on two stacks) can flip a bf16 rounding, so its
outputs compare at rtol 1e-2, atol 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.ops.graph import _spmm_bi_dense as j_spmm_dense
from diffmm_tpu.ops.graph import build_dense_bi_adj_device as j_build
from diffmm_tpu.ops.pallas.spmm_dual import _dual_call
from diffmm_tpu_torch.ops.graph import build_dense_bi_adj_device as t_build
from diffmm_tpu_torch.ops.graph import spmm_bi
from diffmm_tpu_torch.ops.kernels.spmm_dual import spmm_dual, spmm_dual_plain


def _edges(rng, U, I, nnz, pad):
    flat = rng.choice(U * I, size=nnz, replace=False)
    order = np.argsort(flat // I, kind="stable")
    rows = (flat // I).astype(np.int32)[order]
    cols = (flat % I).astype(np.int32)[order]
    rows = np.concatenate([rows, np.full(pad, U, np.int32)])  # sentinel pads
    cols = np.concatenate([cols, np.full(pad, I, np.int32)])
    return rows, cols


@pytest.mark.parametrize("store", ["int8", "bf16"])
def test_dense_adjacency_matches(rng, store):
    U, I = 37, 29
    rows, cols = _edges(rng, U, I, 120, 8)
    tdt = {"int8": torch.int8, "bf16": torch.bfloat16}[store]
    jdt = {"int8": jnp.int8, "bf16": jnp.bfloat16}[store]
    t = t_build(torch.as_tensor(rows), torch.as_tensor(cols), U, I, tdt)
    j = j_build(jnp.asarray(rows), jnp.asarray(cols), U, I, store_dtype=jdt)
    assert t.mat.dtype == tdt
    np.testing.assert_array_equal(
        t.mat.to(torch.float32).numpy(), np.asarray(j.mat.astype(jnp.float32))
    )
    np.testing.assert_allclose(t.s_user.numpy(), np.asarray(j.s_user), rtol=1e-6)
    np.testing.assert_allclose(t.s_item.numpy(), np.asarray(j.s_item), rtol=1e-6)


@pytest.mark.parametrize("store", ["int8", "bf16"])
def test_spmm_bi_dense_matches(rng, store):
    U, I, d = 45, 31, 16
    rows, cols = _edges(rng, U, I, 200, 5)
    tdt = {"int8": torch.int8, "bf16": torch.bfloat16}[store]
    jdt = {"int8": jnp.int8, "bf16": jnp.bfloat16}[store]
    x_u = rng.standard_normal((U, d)).astype(np.float32)
    x_i = rng.standard_normal((I, d)).astype(np.float32)
    t_adj = t_build(torch.as_tensor(rows), torch.as_tensor(cols), U, I, tdt)
    j_adj = j_build(jnp.asarray(rows), jnp.asarray(cols), U, I, store_dtype=jdt)
    yu, yi = spmm_bi(t_adj, torch.as_tensor(x_u), torch.as_tensor(x_i))
    wu, wi = j_spmm_dense(j_adj, jnp.asarray(x_u), jnp.asarray(x_i))
    np.testing.assert_allclose(yu.numpy(), np.asarray(wu), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(yi.numpy(), np.asarray(wi), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("store", ["int8", "bf16"])
@pytest.mark.parametrize("shape", [(70, 50, 16), (33, 130, 32)], ids=["U70xI50", "U33xI130"])
def test_k1_plain_matches_dual_call_interpret(rng, store, shape):
    U, I, d = shape
    mask = rng.random((U, I)) < 0.1
    z_u = rng.standard_normal((U, d)).astype(np.float32)
    z_i = rng.standard_normal((I, d)).astype(np.float32)
    if store == "int8":
        t_mat, j_mat = torch.as_tensor(mask.astype(np.int8)), jnp.asarray(mask.astype(np.int8))
    else:
        t_mat = torch.as_tensor(mask.astype(np.float32)).to(torch.bfloat16)
        j_mat = jnp.asarray(mask.astype(np.float32)).astype(jnp.bfloat16)
    yu, yi = spmm_dual_plain(t_mat, torch.as_tensor(z_u), torch.as_tensor(z_i))
    wu, wi = _dual_call(j_mat, jnp.asarray(z_u), jnp.asarray(z_i), tu=32, interpret=True)
    assert yu.dtype == yi.dtype == torch.float32
    np.testing.assert_allclose(yu.numpy(), np.asarray(wu), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yi.numpy(), np.asarray(wi), rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    gu, gi = spmm_dual(t_mat, torch.as_tensor(z_u), torch.as_tensor(z_i))
    np.testing.assert_array_equal(gu.numpy(), yu.numpy())
    np.testing.assert_array_equal(gi.numpy(), yi.numpy())


def test_k1_plain_keeps_f32_output():
    """torch.matmul of bf16 operands would round the output to bf16; the
    plain version must not: sums of bf16 values that are not bf16."""
    mat = torch.ones((1, 3), dtype=torch.int8)
    z_i = torch.tensor([[1.0], [2.0 ** -8], [2.0 ** -8]])
    yu, _ = spmm_dual_plain(mat, torch.zeros((1, 1)), z_i)
    assert yu.item() == 1.0 + 2.0 ** -7  # not representable in bf16 with 1.0
