"""K4's mesh forms in the port (``parallel/segsum.py::sharded_segsum_gather``
and the sparse form's three autograd Functions on a mesh, ``ops/graph.py``)
against the JAX package's ``sharded_sorted_segment_sum`` and
``sharded_ranked_segment_sum`` (``diffmm_tpu/ops/pallas/segsum.py:455,
708``), with the setups of tests/test_segsum.py:257-330 and 419-500: a
sentinel tail, bf16 messages, ids with gaps, a hub segment that spans
several edge shards (at 2 ranks it is cut by the rank boundary).

The JAX forms run on the conftest's 8 virtual CPU devices (a 4x2 mesh, the
edges over both axes) in interpret mode, as the JAX tests run them; the
port's forms run on 2 and 4 gloo ranks (``run_ranks``), each rank summing
its edge range with the plain K4 (the CPU) and the ranks' partials added by
the all-reduce. Tolerance: K4's rule, ``|a - b| <= 1e-6 * sum|terms| +
1e-6`` per output element (a segment cut by a rank boundary is summed in
two parts).

The backward, by rule: the Functions' backward all-reduces the cotangent,
then sums the rank's range of the opposite order; each rank's loss covers
its own rows of the outputs, and the ranks' input gradients are summed.
Held against ``jax.grad`` of the JAX propagation on a (2, 1) mesh (its
edges placed over the data axis, ``parallel/sharding.py::_shard_adj``;
XLA inserts the collectives) through two layers, at rtol 1e-5 / atol 1e-6
(f32, another summation order).

JAX is imported inside the tests only: the spawned ranks import this module
to find their function, and need torch alone.
"""

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.parallel.launch import run_ranks

U_SEG, D = 300, 16
GU, GI, GD, GM = 30, 20, 8, 2


def _cases():
    """The forward cases: name -> (table (M, R, d) or (R, d), srcs (M, nnz)
    or None for row = edge, sorted ids, n segments)."""
    rng = np.random.default_rng(0)
    cases = {}
    real = np.sort(rng.integers(0, U_SEG, 1000)).astype(np.int32)
    ids = np.concatenate([real, np.full(24, U_SEG, np.int32)])
    msgs = rng.standard_normal((len(ids), D)).astype(np.float32)
    msgs[1000:] = 0.0
    cases["sorted"] = (msgs, None, ids, U_SEG)
    cases["bf16"] = (msgs, None, ids, U_SEG)
    real = np.sort(rng.integers(0, 300, 968)).astype(np.int32)
    ids_r = np.concatenate([real, np.full(56, 300, np.int32)])
    msgs_r = rng.standard_normal((1024, 8)).astype(np.float32)
    msgs_r[968:] = 0.0
    cases["ranked"] = (msgs_r, None, ids_r, 300)
    hub = np.sort(np.concatenate([np.zeros(600, np.int32), rng.integers(1, 50, 424).astype(np.int32)]))
    cases["hub"] = (rng.standard_normal((1024, 8)).astype(np.float32), None, hub, 50)
    # the fused gather: rows of a (120, 16) table, some indices past it
    table = rng.standard_normal((2, 120, D)).astype(np.float32)
    srcs = rng.integers(0, 125, (2, len(ids))).astype(np.int32)
    cases["gather"] = (table[0], srcs[:1], ids, U_SEG)
    cases["stacked"] = (table, srcs, ids, U_SEG)
    return cases


def _messages(table, srcs, bf16=False):
    """(M, nnz, d) messages of a case (a zero row for an index past the table)."""
    t = table if table.ndim == 3 else table[None]
    if bf16:
        t = torch.as_tensor(t).to(torch.bfloat16).float().numpy()
    if srcs is None:
        return t
    out = []
    for tab, s in zip(t, srcs):
        ok = s < tab.shape[0]
        out.append(np.where(ok[:, None], tab[np.clip(s, 0, tab.shape[0] - 1)], 0.0))
    return np.stack(out)


def _graph_inputs():
    """A bipartite graph (GU x GI, unique edges, sentinel-padded to 256),
    GM modality graphs on the same user-major rows, and the embeddings and
    loss weights of the gradient checks."""
    from diffmm_tpu_torch.data.loader import pad_edges

    rng = np.random.default_rng(1)
    pairs = np.unique(rng.integers(0, [GU, GI], (160, 2)), axis=0)
    rows, cols = pad_edges(pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32), GU, GI)
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    real = rows < GU
    modal_cols = [np.where(real, rng.integers(0, GI, len(rows)), GI).astype(np.int32) for _ in range(GM)]
    arrays = {name: rng.standard_normal(shape).astype(np.float32) for name, shape in (
        ("x_u", (GU, GD)), ("x_i", (GI, GD)), ("w_u", (GU, GD)), ("w_i", (GI, GD)), ("v_u", (GU, GD)),
        ("v_i", (GI, GD)), ("f_i", (GM, GI, GD)), ("W_u", (GM, GU, GD)), ("W_i", (GM, GI, GD)))}
    return rows, cols, modal_cols, arrays


def _rank_work(cases, graph):
    """On each rank: every forward case through ``sharded_segsum_gather``,
    and the input gradients of the two-layer propagation and of the stacked
    modal propagation with this rank's rows of the loss, summed over the
    ranks."""
    import torch.distributed as dist

    from diffmm_tpu_torch.ops.graph import build_bi_adj_device, build_bi_adj_host, spmm_bi, spmm_bi_modal_stacked
    from diffmm_tpu_torch.ops.kernels.segsum import segment_offsets
    from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_
    from diffmm_tpu_torch.parallel.segsum import sharded_segsum_gather
    from diffmm_tpu_torch.parallel.sharding import Shard

    torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    shard = Shard(rank, world, dist.group.WORLD)
    out = {}
    for name, (table, srcs, ids, n) in cases.items():
        t = torch.as_tensor(table)
        if name == "bf16":
            t = t.to(torch.bfloat16)
        nnz = len(ids)
        if srcs is None:
            src = torch.arange(nnz, dtype=torch.int32)
        elif t.dim() == 2:
            src = torch.as_tensor(srcs[0])
        else:
            src = [torch.as_tensor(s) for s in srcs]
        lo, hi = shard.span(nnz)
        offsets = segment_offsets(torch.as_tensor(ids), n)
        out[name] = (sharded_segsum_gather(t, src, offsets, lo, hi, dist.group.WORLD).numpy(), (lo, hi))

    rows, cols, modal_cols, a = graph
    T = {k: torch.as_tensor(v) for k, v in a.items()}
    adj = build_bi_adj_host(rows, cols, GU, GI)._replace(shard=shard)
    u_lo, u_hi = shard.span(GU)
    i_lo, i_hi = shard.span(GI)
    x_u, x_i = T["x_u"].clone().requires_grad_(), T["x_i"].clone().requires_grad_()
    y1_u, y1_i = spmm_bi(adj, x_u, x_i)
    y2_u, y2_i = spmm_bi(adj, y1_u, y1_i)
    loss = ((T["w_u"] * y2_u ** 2)[u_lo:u_hi].sum() + (T["w_i"] * y2_i ** 2)[i_lo:i_hi].sum()
            + (T["v_u"] * y1_u)[u_lo:u_hi].sum() + (T["v_i"] * y1_i)[i_lo:i_hi].sum())
    loss.backward()
    out["two_layer"] = [all_reduce_sum_(g.clone(), dist.group.WORLD).numpy() for g in (x_u.grad, x_i.grad)]

    rows_t = torch.as_tensor(rows)
    adjs = [build_bi_adj_device(rows_t, torch.as_tensor(c), GU, GI)._replace(shard=shard) for c in modal_cols]
    adjs = [adjs[0]] + [b._replace(ui_rows=adjs[0].ui_rows) for b in adjs[1:]]
    x_u = T["x_u"].clone().requires_grad_()
    f_i = [T["f_i"][m].clone().requires_grad_() for m in range(GM)]
    m_u, m_i = spmm_bi_modal_stacked(adjs, x_u, f_i)
    loss = (T["W_u"] * m_u ** 2)[:, u_lo:u_hi].sum() + (T["W_i"] * m_i ** 2)[:, i_lo:i_hi].sum()
    loss.backward()
    out["stacked_grad"] = [all_reduce_sum_(g.clone(), dist.group.WORLD).numpy()
                           for g in (x_u.grad, *(f.grad for f in f_i))]
    return out


# four spawned ranks take over 10 s to start on a CPU box: slow
@pytest.fixture(scope="module", params=[2, pytest.param(4, marks=pytest.mark.slow)], ids=["2ranks", "4ranks"])
def ranks(request):
    return request.param, run_ranks(_rank_work, request.param, (_cases(), _graph_inputs()))


def _jax_sharded(name, table, srcs, ids, n):
    """The JAX mesh form on a 4x2 mesh over both axes: the sorted plan for
    the fixed layouts, the rank-space plan for the dynamic ones."""
    import jax.numpy as jnp

    from diffmm_tpu.ops.pallas.segsum import (
        make_sharded_ranked_plan,
        make_sharded_segsum_plan,
        sharded_ranked_segment_sum,
        sharded_sorted_segment_sum,
    )
    from diffmm_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

    mesh = make_mesh(8, model_parallel=2)
    axes = (DATA_AXIS, MODEL_AXIS)
    outs = []
    for msgs in _messages(table, srcs, bf16=name == "bf16"):
        msgs = jnp.asarray(msgs)
        if name == "bf16":
            msgs = msgs.astype(jnp.bfloat16)
        if name in ("ranked", "hub"):
            plan = make_sharded_ranked_plan(len(ids), n, msgs.shape[1], mesh, axes, chunk=64)
            outs.append(sharded_ranked_segment_sum(msgs, jnp.asarray(ids), n, plan, interpret=True))
        else:
            plan = make_sharded_segsum_plan(ids, n, msgs.shape[1], mesh, axes, chunk=128)
            outs.append(sharded_sorted_segment_sum(msgs, jnp.asarray(ids), n, plan))
    return np.concatenate([np.asarray(o, dtype=np.float32) for o in outs], axis=1)


def _abs_sums(table, srcs, ids, n, bf16):
    msgs = np.abs(_messages(table, srcs, bf16))
    out = np.zeros((n, msgs.shape[0] * msgs.shape[2]), np.float64)
    real = ids < n
    for m, mm in enumerate(msgs):
        np.add.at(out[:, m * mm.shape[1]:(m + 1) * mm.shape[1]], ids[real], mm[real])
    return out


@pytest.mark.parametrize("name", ["sorted", "bf16", "ranked", "hub", "gather", "stacked"])
def test_sharded_segsum_gather_matches_jax(ranks, name):
    world, outs = ranks
    table, srcs, ids, n = _cases()[name]
    want = _jax_sharded(name, table, srcs, ids, n)
    bound = 1e-6 * _abs_sums(table, srcs, ids, n, name == "bf16") + 1e-6
    spans = []
    for rank_out in outs:
        got, span = rank_out[name]
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.all(np.abs(got.astype(np.float64) - want) <= bound), name
        spans.append(span)
    # every rank holds the same sums, and the ranks' ranges cover the edges
    for rank_out in outs[1:]:
        np.testing.assert_array_equal(rank_out[name][0], outs[0][name][0])
    assert spans[0][0] == 0 and spans[-1][1] == len(ids)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    if name == "hub" and world == 2:
        assert ids[spans[0][1] - 1] == ids[spans[1][0]] == 0  # the hub is cut by the boundary


def _j_adj(rows, cols, mesh):
    from diffmm_tpu.ops.graph import build_bi_adj_host
    from diffmm_tpu.parallel.sharding import _shard_adj

    return _shard_adj(build_bi_adj_host(rows, cols, GU, GI), mesh)


def test_propagate_gradient_matches_jax_mesh(ranks):
    """Two layers of the sparse propagation (:class:`Propagate` both ways,
    both layers' outputs in the loss): the ranks' summed gradients are
    ``jax.grad`` of the JAX propagation on a (2, 1) mesh."""
    import jax
    import jax.numpy as jnp

    from diffmm_tpu.ops.graph import spmm_bi
    from diffmm_tpu.parallel.mesh import make_mesh

    _, outs = ranks
    rows, cols, _, a = _graph_inputs()
    adj = _j_adj(rows, cols, make_mesh(2, model_parallel=1))

    @jax.jit
    def loss(x_u, x_i):
        y1_u, y1_i = spmm_bi(adj, x_u, x_i)
        y2_u, y2_i = spmm_bi(adj, y1_u, y1_i)
        return (jnp.sum(a["w_u"] * y2_u ** 2) + jnp.sum(a["w_i"] * y2_i ** 2)
                + jnp.sum(a["v_u"] * y1_u) + jnp.sum(a["v_i"] * y1_i))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a["x_u"]), jnp.asarray(a["x_i"]))
    for rank_out in outs:
        for got, w in zip(rank_out["two_layer"], want):
            np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5, atol=1e-6)
    for rank_out in outs[1:]:
        for got, first in zip(rank_out["two_layer"], outs[0]["two_layer"]):
            np.testing.assert_array_equal(got, first)


def test_stacked_modal_gradient_matches_jax_mesh(ranks):
    """The stacked modal propagation (:class:`StackedUserPropagate` and
    :class:`MultiItemPropagate`, both directions' backward on the mesh)
    against ``jax.grad`` of the M JAX propagations it stands for, on a
    (2, 1) mesh."""
    import jax
    import jax.numpy as jnp

    from diffmm_tpu.ops.graph import spmm_bi
    from diffmm_tpu.parallel.mesh import make_mesh

    _, outs = ranks
    rows, _, modal_cols, a = _graph_inputs()
    mesh = make_mesh(2, model_parallel=1)
    adjs = [_j_adj(rows, c, mesh) for c in modal_cols]

    @jax.jit
    def loss(x_u, f_i):
        total = 0.0
        for m, adj in enumerate(adjs):
            m_u, m_i = spmm_bi(adj, x_u, f_i[m])
            total = total + jnp.sum(a["W_u"][m] * m_u ** 2) + jnp.sum(a["W_i"][m] * m_i ** 2)
        return total

    g_u, g_f = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a["x_u"]), jnp.asarray(a["f_i"]))
    want = [np.asarray(g_u), *np.asarray(g_f)]
    for rank_out in outs:
        for got, w in zip(rank_out["stacked_grad"], want):
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
