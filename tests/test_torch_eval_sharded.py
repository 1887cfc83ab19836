"""The catalog-sharded top-k of the port's eval and serving
(``eval/ranking.py::make_score_topk``, ``eval/serving.py::recommend(mesh=)``,
``place_index``) against the JAX package's (``ranking.py:54-120``,
``serving.py:133-306``, tests/test_eval_sharded.py and
tests/test_serving.py:127-160) and against the replicated call.

The port's model axis is 2 gloo ranks (4 in the ``slow`` case), spawned by
``parallel/launch.py``; the JAX mesh runs here on the conftest's 8 virtual
CPU devices at the same model axis. The inputs are a synthetic 50 x 40
dataset's train store, dense and CSR, random embeddings and a user block
with a duplicate user. Ids are compared exactly (the top-k of the union of
the shards' top-ks is the global top-k; the random scores have no ties),
scores within 1e-5. A catalog the axis does not divide, or shards thinner
than k, take the replicated branch, as in the JAX package.

JAX is imported inside the tests only: the spawned ranks import this module
to find their function, and need torch alone.
"""

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.parallel.launch import run_ranks

U, I, D, K = 50, 40, 16, 5


def _config():
    from diffmm_tpu_torch.config import Config

    cfg = Config()
    cfg.base.seed = 7
    cfg.base.latdim = D
    cfg.train.batch = 16
    return cfg


def _inputs():
    rng = np.random.default_rng(3)
    return {
        "u": rng.standard_normal((U, D)).astype(np.float32),
        "i": rng.standard_normal((I, D)).astype(np.float32),
        "users": np.array([0, 3, 7, 7, 12, 19, 33, 49], np.int32),
        "uneven": (rng.random((U, I - 1)) < 0.2).astype(np.int8),
    }


def _stores():
    """The port's dense and CSR train stores of the synthetic dataset, and
    its seen lists."""
    from diffmm_tpu_torch.data.loader import to_device
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data

    host = make_synthetic_host_data(_config(), user_num=U, item_num=I, seed=3)
    return host, {form: to_device(host, "cpu", form).train_store for form in ("dense", "csr")}


def _rank_work(inp):
    """On each rank of a 1xW mesh: the sharded top-k over both stores and
    the uneven catalog, and ``recommend`` on the whole and the placed index
    at two k (the second above the shard width)."""
    import torch.distributed as dist

    from diffmm_tpu_torch.eval.ranking import make_score_topk
    from diffmm_tpu_torch.eval.serving import RecIndex, place_index, recommend, seen_csr_from_edges
    from diffmm_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    world = dist.get_world_size()
    mesh = make_mesh(world, model_parallel=world)
    host, stores = _stores()
    u, i_final = torch.as_tensor(inp["u"]), torch.as_tensor(inp["i"])
    users = torch.as_tensor(inp["users"])
    fn = make_score_topk(K, mesh)
    out = {f"topk_{form}": fn(u[users.long()], i_final, store, users).numpy() for form, store in stores.items()}
    out["topk_uneven"] = fn(u[users.long()], i_final[:-1], torch.as_tensor(inp["uneven"]), users).numpy()
    out["topk_wide_k"] = make_score_topk(I // world + 1, mesh)(u[users.long()], i_final, stores["dense"],
                                                               users).numpy()
    indptr, indices, width = seen_csr_from_edges(host.train_rows, host.train_cols, U)
    index = RecIndex(u, i_final, torch.as_tensor(indptr), torch.as_tensor(indices), width)
    placed = place_index(index, mesh)
    out["placed"] = (placed.i_final.numpy(), placed.item_num)
    for name, idx in (("whole", index), ("placed", placed)):
        for k in (K, 16):
            for mask in (True, False):
                ids, scores = recommend(idx, users, k, mask, mesh)
                out[f"rec_{name}_{k}_{mask}"] = (ids.numpy(), scores.numpy())
    return out


@pytest.fixture(scope="module", params=[2, pytest.param(4, marks=pytest.mark.slow)], ids=["2ranks", "4ranks"])
def ranks(request):
    return request.param, run_ranks(_rank_work, request.param, (_inputs(),))


def _jax_topk(form, world):
    import jax.numpy as jnp

    from diffmm_tpu.config import Config
    from diffmm_tpu.data.loader import to_device
    from diffmm_tpu.data.synthetic import make_synthetic_host_data
    from diffmm_tpu.eval.ranking import make_score_topk
    from diffmm_tpu.parallel import make_mesh

    cfg = Config()
    cfg.base.seed = 7
    cfg.base.latdim = D
    cfg.train.batch = 16
    host = make_synthetic_host_data(cfg, user_num=U, item_num=I, seed=3)
    store = to_device(host, with_sparse_adj=False, train_store=form).train_store
    inp = _inputs()
    users = jnp.asarray(inp["users"])
    fn = make_score_topk(K, make_mesh(8, model_parallel=world))
    return np.asarray(fn(jnp.asarray(inp["u"])[users], jnp.asarray(inp["i"]), store, users))


def _plain_topk(store, i_final, k):
    from diffmm_tpu_torch.eval.ranking import make_score_topk

    inp = _inputs()
    users = torch.as_tensor(inp["users"])
    u = torch.as_tensor(inp["u"])[users.long()]
    return make_score_topk(k)(u, i_final, store, users).numpy()


@pytest.mark.parametrize("form", ["dense", "csr"])
def test_score_topk_matches_jax_and_replicated(ranks, form):
    world, outs = ranks
    _, stores = _stores()
    want = _plain_topk(stores[form], torch.as_tensor(_inputs()["i"]), K)
    np.testing.assert_array_equal(want, _jax_topk(form, world))
    for out in outs:
        np.testing.assert_array_equal(out[f"topk_{form}"], want)


def test_score_topk_replicated_branches(ranks):
    """A catalog the axis does not divide (39 items) and k above the shard
    width take the replicated call, as ``ranking.py:83-86``."""
    _, outs = ranks
    inp = _inputs()
    _, stores = _stores()
    i_final = torch.as_tensor(inp["i"])
    uneven = _plain_topk(torch.as_tensor(inp["uneven"]), i_final[:-1], K)
    wide = _plain_topk(stores["dense"], i_final, I // len(outs) + 1)
    for out in outs:
        np.testing.assert_array_equal(out["topk_uneven"], uneven)
        np.testing.assert_array_equal(out["topk_wide_k"], wide)


def test_place_index_keeps_the_rank_rows(ranks):
    world, outs = ranks
    i_final = _inputs()["i"]
    width = I // world
    for r, out in enumerate(outs):
        rows, item_num = out["placed"]
        np.testing.assert_array_equal(rows, i_final[r * width:(r + 1) * width])
        assert item_num == I


@pytest.mark.parametrize("k", [K, 16])
@pytest.mark.parametrize("mask_seen", [True, False])
def test_recommend_mesh_matches_replicated(ranks, k, mask_seen):
    """``recommend(mesh=)`` on the whole and on the placed index returns the
    replicated call's ids, scores within 1e-5, and no seen item when masked
    (k 16 is above a 4-rank shard's width: the placed index's replicated
    branch)."""
    from diffmm_tpu_torch.eval.serving import RecIndex, recommend, seen_csr_from_edges

    _, outs = ranks
    inp = _inputs()
    host, _ = _stores()
    indptr, indices, width = seen_csr_from_edges(host.train_rows, host.train_cols, U)
    index = RecIndex(torch.as_tensor(inp["u"]), torch.as_tensor(inp["i"]), torch.as_tensor(indptr),
                     torch.as_tensor(indices), width)
    ids, scores = recommend(index, torch.as_tensor(inp["users"]), k, mask_seen)
    for out in outs:
        for name in ("whole", "placed"):
            got_ids, got_scores = out[f"rec_{name}_{k}_{mask_seen}"]
            np.testing.assert_array_equal(got_ids, ids.numpy())
            np.testing.assert_allclose(got_scores, scores.numpy(), rtol=1e-5, atol=1e-5)
            if mask_seen:
                for row, u in zip(got_ids, inp["users"]):
                    assert not set(row) & set(indices[indptr[u]:indptr[u + 1]])
