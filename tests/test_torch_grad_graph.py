"""Gradients of the port's propagations (diffmm_tpu_torch/ops/graph.py and
ops/kernels/spmm_dual.py::SpmmDual) against the JAX package's VJPs, on the
CPU (the kernels' plain versions).

Dense form, K1's Function:
* against ``jax.vjp`` of ``diffmm_tpu.ops.pallas.spmm_dual.spmm_dual`` in
  interpret mode, the JAX custom VJP that calls the same kernel with the
  cotangents swapped: both round the cotangent to bf16 and sum exact
  products in f32, in another order: rtol 1e-5, atol 1e-5;
* against the JAX default route's VJP (the two XLA bf16 matmuls of
  ``graph.py:615-627`` differentiated by JAX, which sums the exact products
  of the f32 cotangent and rounds the sum to bf16): at the forward's bf16
  tolerance, rtol 1e-2 / atol 1e-3. The cotangents are bf16 values, so the
  port's rounding of them is exact and the two differ by JAX's rounding of
  the sums only (2^-9 relative).

Sparse form, the three Functions, against ``jax.vjp`` of JAX ``spmm_bi``
and ``spmm_bi_modal_stacked`` on its default XLA route and on its Pallas
plan route in interpret mode (the custom VJPs of ``graph.py:339-520``),
f32 and (plan route; the XLA route ignores it) bf16 messages: the same
messages summed in another f32 order, rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.ops import graph as jg
from diffmm_tpu.ops.pallas.segsum import make_ranked_plan, make_segsum_plan
from diffmm_tpu.ops.pallas.spmm_dual import spmm_dual as j_spmm_dual
from diffmm_tpu_torch.ops import graph as tg
from diffmm_tpu_torch.ops.kernels.spmm_dual import SpmmDual

U, I, D, M, PAD = 37, 29, 16, 3, 11
RTOL, ATOL = 1e-4, 1e-5


def _bf16_values(rng, shape):
    """Standard normal values that bf16 holds exactly."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)
    return np.array(x.astype(jnp.float32))


def _torch_vjp(fn, inputs, cotangents):
    """Gradients of ``sum(out * cot)`` with respect to ``inputs``."""
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    outs = fn(*leaves)
    torch.autograd.backward(list(outs), [torch.as_tensor(c) for c in cotangents])
    return [x.grad.numpy() for x in leaves]


def _graph_names(outs) -> set:
    """The autograd node names reachable from ``outs``."""
    names, todo, seen = set(), [o.grad_fn for o in outs], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def _dense_case(rng, store):
    mask = rng.random((U, I)) < 0.15
    t_mat = torch.as_tensor(mask.astype(np.int8)) if store == "int8" else \
        torch.as_tensor(mask.astype(np.float32)).to(torch.bfloat16)
    j_mat = jnp.asarray(mask.astype(np.int8)) if store == "int8" else \
        jnp.asarray(mask.astype(np.float32)).astype(jnp.bfloat16)
    return t_mat, j_mat


@pytest.mark.parametrize("store", ["int8", "bf16"])
def test_spmm_dual_function_matches_pallas_vjp(rng, store):
    t_mat, j_mat = _dense_case(rng, store)
    z_u = rng.standard_normal((U, D)).astype(np.float32)
    z_i = rng.standard_normal((I, D)).astype(np.float32)
    g_u = rng.standard_normal((U, D)).astype(np.float32)
    g_i = rng.standard_normal((I, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: j_spmm_dual(j_mat, a, b, 32, True), jnp.asarray(z_u), jnp.asarray(z_i))
    want = vjp((jnp.asarray(g_u), jnp.asarray(g_i)))
    got = _torch_vjp(lambda a, b: SpmmDual.apply(t_mat, a, b), (z_u, z_i), (g_u, g_i))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("store", ["int8", "bf16"])
def test_spmm_dual_function_matches_default_route_vjp(rng, store):
    t_mat, j_mat = _dense_case(rng, store)
    z_u = rng.standard_normal((U, D)).astype(np.float32)
    z_i = rng.standard_normal((I, D)).astype(np.float32)
    g_u, g_i = _bf16_values(rng, (U, D)), _bf16_values(rng, (I, D))

    def two_pass(a, b):  # the JAX default route's products (graph.py:615-627)
        mat = j_mat.astype(jnp.bfloat16)
        dims = (((1,), (0,)), ((), ()))
        m_u = jax.lax.dot_general(mat, b.astype(jnp.bfloat16), dims, preferred_element_type=jnp.float32)
        m_i = jax.lax.dot_general(mat, a.astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)
        return m_u, m_i

    _, vjp = jax.vjp(two_pass, jnp.asarray(z_u), jnp.asarray(z_i))
    want = vjp((jnp.asarray(g_u), jnp.asarray(g_i)))
    got = _torch_vjp(lambda a, b: SpmmDual.apply(t_mat, a, b), (z_u, z_i), (g_u, g_i))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-2, atol=1e-3)


def test_dense_spmm_bi_differentiates_through_k1(rng):
    """spmm_bi on the dense form: the backward goes through SpmmDual, and
    the input gradients equal JAX's _spmm_bi_dense VJP at the bf16
    tolerance scaled by each output's terms (the two round different
    operands: |port - jax| <= 2^-7 * sum|terms| + 1e-6)."""
    rows, cols = _edges(rng)
    x_u = rng.standard_normal((U, D)).astype(np.float32)
    x_i = rng.standard_normal((I, D)).astype(np.float32)
    g_u = rng.standard_normal((U, D)).astype(np.float32)
    g_i = rng.standard_normal((I, D)).astype(np.float32)
    t_adj = tg.build_dense_bi_adj_device(torch.as_tensor(rows), torch.as_tensor(cols), U, I)
    j_adj = jg.build_dense_bi_adj_device(jnp.asarray(rows), jnp.asarray(cols), U, I, store_dtype=jnp.int8)
    _, vjp = jax.vjp(lambda a, b: jg._spmm_bi_dense(j_adj, a, b), jnp.asarray(x_u), jnp.asarray(x_i))
    want = vjp((jnp.asarray(g_u), jnp.asarray(g_i)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (x_u, x_i)]
    outs = tg.spmm_bi(t_adj, *leaves)
    assert "SpmmDualBackward" in _graph_names(outs)
    torch.autograd.backward(list(outs), [torch.as_tensor(g_u), torch.as_tensor(g_i)])
    # each input gradient's terms: |M|-weighted |g| scaled by both s
    mat = t_adj.mat.to(torch.float32)
    s_u, s_i = t_adj.s_user[:, None], t_adj.s_item[:, None]
    terms_u = s_u * (mat @ (s_i * torch.as_tensor(np.abs(g_i))) + s_u * torch.as_tensor(np.abs(g_u)))
    terms_i = s_i * (mat.T @ (s_u * torch.as_tensor(np.abs(g_u))) + s_i * torch.as_tensor(np.abs(g_i)))
    for leaf, w, terms in zip(leaves, want, (terms_u, terms_i)):
        diff = np.abs(leaf.grad.numpy() - np.asarray(w))
        assert (diff <= 2.0 ** -7 * terms.numpy() + 1e-6).all(), diff.max()


def _edges(rng, nnz=170):
    """Unique user-major edges plus sentinel pads (the loader's layout)."""
    flat = np.sort(rng.choice(U * I, size=nnz, replace=False))
    rows = np.concatenate([flat // I, np.full(PAD, U)]).astype(np.int32)
    cols = np.concatenate([flat % I, np.full(PAD, I)]).astype(np.int32)
    return rows, cols


def _plans(rows, cols, route):
    if route == "xla":
        return (None, None)
    return (make_segsum_plan(rows, U, D, chunk=64), make_segsum_plan(np.sort(cols), I, D, chunk=64))


ROUTES = [("xla", "f32"), ("plans", "f32"), ("plans", "bf16")]


@pytest.mark.parametrize("route,compute", ROUTES, ids=["xla", "plans_f32", "plans_bf16"])
def test_sparse_spmm_bi_grads_match_jax(rng, route, compute):
    rows, cols = _edges(rng)
    x_u = rng.standard_normal((U, D)).astype(np.float32)
    x_i = rng.standard_normal((I, D)).astype(np.float32)
    g_u = rng.standard_normal((U, D)).astype(np.float32)
    g_i = rng.standard_normal((I, D)).astype(np.float32)
    j_adj = jg.build_bi_adj_host(rows, cols, U, I)
    plans = _plans(rows, cols, route)
    _, vjp = jax.vjp(lambda a, b: jg.spmm_bi(j_adj, a, b, plans, compute), jnp.asarray(x_u), jnp.asarray(x_i))
    want = vjp((jnp.asarray(g_u), jnp.asarray(g_i)))
    t_adj = tg.build_bi_adj_host(rows, cols, U, I)
    got = _torch_vjp(lambda a, b: tg.spmm_bi(t_adj, a, b, compute), (x_u, x_i), (g_u, g_i))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


def _modal_adjs(rng):
    rows, _ = _edges(rng)
    cols = []
    for _ in range(M):
        c = rng.integers(0, I // 2, len(rows)).astype(np.int32)  # item ties, empty items
        c[rows == U] = I
        cols.append(c)
    j_adjs = [jg.build_bi_adj_device(jnp.asarray(rows), jnp.asarray(c), U, I, with_rank_aux=True)
              for c in cols]
    t_adjs = [tg.build_bi_adj_device(torch.as_tensor(rows), torch.as_tensor(c), U, I) for c in cols]
    return rows, j_adjs, t_adjs


@pytest.mark.parametrize("route,compute", ROUTES, ids=["xla", "plans_f32", "plans_bf16"])
def test_stacked_grads_match_jax(rng, route, compute):
    """Both stacked Functions (the stacked user direction and the multi-item
    direction) through JAX spmm_bi_modal_stacked's custom VJPs."""
    rows, j_adjs, t_adjs = _modal_adjs(rng)
    x_user = rng.standard_normal((U, D)).astype(np.float32)
    feats = [rng.standard_normal((I, D)).astype(np.float32) for _ in range(M)]
    g_u = rng.standard_normal((M, U, D)).astype(np.float32)
    g_i = rng.standard_normal((M, I, D)).astype(np.float32)
    wide_plan = item_plan = None
    if route == "plans":
        wide_plan = make_segsum_plan(rows, U, d=M * D, chunk=64)
        item_plan = make_ranked_plan(len(rows), d=D, chunk=64)

    def j_fn(xu, *fs):
        return jg.spmm_bi_modal_stacked(j_adjs, xu, list(fs), wide_plan, item_plan, compute)

    _, vjp = jax.vjp(j_fn, jnp.asarray(x_user), *[jnp.asarray(f) for f in feats])
    want = vjp((jnp.asarray(g_u), jnp.asarray(g_i)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (x_user, *feats)]
    outs = tg.spmm_bi_modal_stacked(t_adjs, leaves[0], leaves[1:], compute)
    names = _graph_names(outs)
    assert {"StackedUserPropagateBackward", "MultiItemPropagateBackward"} <= names
    assert not any(n.startswith("IndexSelectBackward") for n in names), names
    torch.autograd.backward(list(outs), [torch.as_tensor(g_u), torch.as_tensor(g_i)])
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_sparse_backward_never_goes_through_index_select(rng):
    rows, cols = _edges(rng)
    t_adj = tg.build_bi_adj_host(rows, cols, U, I)
    x_u = torch.randn((U, D), requires_grad=True)
    x_i = torch.randn((I, D), requires_grad=True)
    names = _graph_names(tg.spmm_bi(t_adj, x_u, x_i))
    assert "PropagateBackward" in names
    assert not any(n.startswith("IndexSelectBackward") for n in names), names


def test_backward_pads_contribute_nothing():
    """An edge whose forward segment is the pad (rows == n_out) adds
    nothing to the backward, wherever it sits in the backward's order, and
    the edges past the backward's offsets (bwd_rows == n_src) are never
    read: the JAX backward's two masks."""
    g = torch.randn((4, 8))  # cotangent over n_out = 4 segments
    z = torch.randn((3, 8), requires_grad=True)  # n_src = 3
    # three edges: (seg 1, src 0), (pad seg 4, src 2), (seg 3, src 2), and a
    # double pad (seg 4, src 3) at the tail of both orders
    src = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    offsets = torch.tensor([0, 0, 1, 1, 2], dtype=torch.int64)  # segs 0..3 over the first 2 edges
    # in the backward's (src-major) order: src 0 <- seg 1; src 2 <- seg 4
    # (the pad) and seg 3; the double pad last, past src 3's end
    bwd_src = torch.tensor([1, 4, 3, 4], dtype=torch.int32)
    bwd_offsets = torch.tensor([0, 1, 1, 3], dtype=torch.int64)
    y = tg.Propagate.apply(z, src, offsets, bwd_src, bwd_offsets, "f32")
    y.backward(g)
    want = torch.stack([g[1], torch.zeros(8), g[3]])
    torch.testing.assert_close(z.grad, want, rtol=0, atol=0)
