"""The dense train store on the model axis: a rank keeps its catalog columns
of the (U, I) int8 store, as the JAX package's ``_place_train_store``
places them (``diffmm_tpu/parallel/sharding.py:102-118``), and its readers
give what the whole store gives.

On gloo ranks of the meshes of tests/test_torch_model_axis.py (1x2 and 2x2,
paired with JAX's ``make_mesh(2|8, model_parallel=2)``):
* a rank's ``data.train_store`` is a ``DenseShard`` of its columns, (U,
  I/2), byte for byte the JAX shard of the same columns (``jax.device_put``
  with JAX's own ``catalog_sharded_or_replicated``);
* the Coach's negatives (every rank tests its columns, the model axis ORs
  the answers with one all-reduce a round), the diffusion rows and the eval
  masks are bitwise those of the whole store at world size 1, and so are
  the negatives of injected draws on a dense catalog, where most lanes
  collide for several rounds;
* the CSR store stays whole on every rank, as in the JAX package;
* on a mesh whose model axis is 1 (1x1, 2x1) the store stays the whole
  (U, I) tensor and the negatives cost no collective.

JAX is imported inside the tests only: the spawned ranks import this module
to find their function, and need torch alone.
"""

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.parallel.launch import run_ranks
from test_torch_model_axis import MESHES
from test_torch_parallel import I, U, _coach, _config

ROUNDS = 8


def _draws(n: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, I, (ROUNDS, n)).astype(np.int64)


def _dense_half(coach):
    """A store where half the catalog is a train item of every user: the
    draws collide round after round. On a mesh the rank's ``DenseShard``."""
    from diffmm_tpu_torch.data.membership import DenseShard

    store = torch.zeros((U, I), dtype=torch.int8)
    store[:, ::2] = 1
    store[:, 1] = 1
    if coach.split.cat is None:
        return store
    lo, hi = coach.split.lo, coach.split.hi
    return DenseShard(store[:, lo:hi].contiguous(), lo, hi)


def _counted_collectives():
    """Count the all-reduces of ``data/sampling.py`` in this process."""
    from diffmm_tpu_torch.data import sampling

    calls = []
    reduce = sampling.all_reduce_sum_

    def counted(*args, **kwargs):
        calls.append(1)
        return reduce(*args, **kwargs)

    sampling.all_reduce_sum_ = counted
    return calls


def _readers(coach) -> dict:
    """What the store's readers give on this rank: the Coach's negatives,
    the diffusion rows and eval mask of every user over the rank's columns,
    and the negatives of injected draws on a half-full store."""
    from diffmm_tpu_torch.data.membership import gather_rows
    from diffmm_tpu_torch.data.sampling import negative_sampling
    from diffmm_tpu_torch.eval.ranking import local_mask

    split, store = coach.split, coach.data.train_store
    lo, hi = split.lo, split.hi
    group = None if split.cat is None else split.cat.group
    users = torch.arange(U)
    rows = coach.data.train_rows
    return {
        "negatives": coach.sample_negatives().numpy(),
        "rows": gather_rows(store, users, I, (lo, hi)).numpy(),
        "mask": local_mask(store, users, lo, hi).numpy(),
        "draw_negatives": negative_sampling(rows, _dense_half(coach), I,
                                            draws=torch.as_tensor(_draws(rows.shape[0])), group=group).numpy(),
        "cols": (lo, hi),
    }


def _rank_store(model: int) -> dict:
    from diffmm_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(model_parallel=model)
    coach = _coach(_config("dense", 0), mesh)
    calls = _counted_collectives()
    out = _readers(coach)
    out["sampling_collectives"] = len(calls)  # the Coach's negatives and the injected draws'
    store = coach.data.train_store
    out["store"] = store.block.numpy().copy()
    out["store_cols"] = (store.lo, store.hi)
    csr = _coach(_config("sparse", 1), mesh).data.train_store
    out["csr_cols_shape"] = tuple(csr.cols.shape)
    return out


@pytest.fixture(scope="module")
def ranks():
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(MESHES)) as pool:  # both meshes' ranks start at once
        runs = {label: pool.submit(run_ranks, _rank_store, world, (model,))
                for label, (world, model, _) in MESHES.items()}
        return {label: run.result() for label, run in runs.items()}


@pytest.fixture(scope="module")
def whole():
    coach = _coach(_config("dense", 0))
    return coach, _readers(coach)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rank_holds_its_columns_as_jax_places_them(ranks, whole, mesh):
    import jax

    from diffmm_tpu.data.loader import to_device as j_to_device
    from diffmm_tpu.parallel import make_mesh
    from diffmm_tpu.parallel.sharding import catalog_sharded_or_replicated

    coach, _ = whole
    j_store = j_to_device(coach.host, with_sparse_adj=False, train_store="dense").train_store
    j_placed = jax.device_put(j_store, catalog_sharded_or_replicated(j_store, make_mesh(MESHES[mesh][2],
                                                                                        model_parallel=2)))
    j_shards = {(s.index[1].start, s.index[1].stop): np.asarray(s.data) for s in j_placed.addressable_shards}
    for out in ranks[mesh]:
        lo, hi = out["cols"]
        assert hi - lo == I // 2 and out["store"].shape == (U, I // 2) and out["store"].dtype == np.int8
        assert out["store_cols"] == (lo, hi)
        np.testing.assert_array_equal(out["store"], j_shards[(lo, hi)])
        np.testing.assert_array_equal(out["store"], coach.host.train_dense[:, lo:hi])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_readers_are_bitwise_the_whole_store(ranks, whole, mesh):
    """Negatives (the Coach's, and those of draws that collide for several
    rounds), diffusion rows and eval masks of a rank's columns equal the
    whole store's at world size 1, bit for bit."""
    _, one = whole
    collided = (one["draw_negatives"] != _draws(one["draw_negatives"].shape[0])[0]).mean()
    assert collided > 0.3  # most lanes needed a second round or more
    for out in ranks[mesh]:
        lo, hi = out["cols"]
        assert out["sampling_collectives"] == 2 * ROUNDS  # one OR of the axis's answers a round, twice
        np.testing.assert_array_equal(out["negatives"], one["negatives"])
        np.testing.assert_array_equal(out["draw_negatives"], one["draw_negatives"])
        np.testing.assert_array_equal(out["rows"], one["rows"][:, lo:hi])
        np.testing.assert_array_equal(out["mask"], one["mask"][:, lo:hi])


def test_csr_store_stays_whole(ranks, whole):
    coach, _ = whole
    want = (coach.data.train_rows.shape[0],)
    for outs in ranks.values():
        assert all(out["csr_cols_shape"] == want for out in outs)


def _rank_undivided(model: int) -> dict:
    """A dense Coach on a mesh whose model axis does not cut the catalog:
    its store's type and shape, and the collectives of its negatives."""
    from diffmm_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    coach = _coach(_config("dense", 0), make_mesh(model_parallel=model))
    calls = _counted_collectives()
    negatives = coach.sample_negatives().numpy()
    store = coach.data.train_store
    return {"whole_tensor": isinstance(store, torch.Tensor) and tuple(store.shape) == (U, I),
            "sampling_collectives": len(calls), "negatives": negatives}


@pytest.mark.parametrize("world,model", [(1, 1), (2, 1)], ids=["1x1", "2x1"])
def test_undivided_mesh_keeps_the_store_whole_without_collectives(whole, world, model):
    """A model axis of 1 leaves the store the whole (U, I) tensor, and
    sampling the negatives runs no all-reduce: only a cut store pays."""
    _, one = whole
    for out in run_ranks(_rank_undivided, world, (model,)):
        assert out["whole_tensor"] and out["sampling_collectives"] == 0
        np.testing.assert_array_equal(out["negatives"], one["negatives"])


def test_readers_of_a_cut_store_on_one_process():
    """A ``DenseShard`` of the columns [lo, hi): ``contains`` answers for
    those columns only; ``gather_rows`` and ``local_mask`` take any range
    inside them and refuse one outside; ``negative_sampling`` takes such a
    store with a group only, and a whole store only without one."""
    from diffmm_tpu_torch.data.membership import DenseShard, contains, gather_rows
    from diffmm_tpu_torch.data.sampling import negative_sampling
    from diffmm_tpu_torch.eval.ranking import local_mask

    whole = torch.as_tensor((np.random.default_rng(1).random((6, 10)) < 0.5).astype(np.int8))
    cut = DenseShard(whole[:, 4:8].contiguous(), 4, 8)
    users = torch.arange(6).repeat_interleave(10)
    items = torch.arange(10).repeat(6)
    inside = (items >= 4) & (items < 8)
    assert torch.equal(contains(cut, users, items), contains(whole, users, items) & inside)
    rows = torch.arange(6)
    for lo, hi in ((4, 8), (5, 7)):
        assert torch.equal(gather_rows(cut, rows, 10, (lo, hi)), whole[:, lo:hi].float())
        assert torch.equal(gather_rows(whole, rows, 10, (lo, hi)), whole[:, lo:hi].float())
        assert torch.equal(local_mask(cut, rows, lo, hi), whole[:, lo:hi].float())
    for cols in (None, (0, 4), (3, 7), (6, 9)):  # the same width at another place is refused too
        with pytest.raises(ValueError, match=r"holds the columns \[4, 8\)"):
            gather_rows(cut, rows, 10, cols)
    with pytest.raises(ValueError, match="DenseShard"):
        negative_sampling(users.int(), cut, 10)
    with pytest.raises(ValueError, match="DenseShard"):
        negative_sampling(users.int(), whole, 10, group=object())
