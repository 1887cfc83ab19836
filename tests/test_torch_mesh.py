"""The port's mesh, placement and collectives (``diffmm_tpu_torch/parallel``)
against the JAX package's ``parallel`` module, after tests/test_parallel.py.

The JAX mesh runs in this process on the conftest's 8 virtual CPU devices;
the port's ranks are gloo processes spawned by ``parallel/launch.py``
(``run_ranks``), which sets each rank's launcher environment. Shapes,
coordinates and error messages are compared exactly; the placed all-reduce
is exact (a sum of one value and zeros).
"""

import re

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.parallel.launch import run_ranks
from diffmm_tpu_torch.parallel.sharding import edge_range


def _numbers_out(msg: str) -> str:
    return re.sub(r"\d+", "N", msg)


def _four_rank_checks():
    """Run on each of 4 gloo ranks: the mesh's shape and coordinates, the
    errors, the placed all-reduce, the batch and block shares, the catalog
    placement and the model-axis refusal."""
    import torch.distributed as dist

    from diffmm_tpu_torch.parallel import (
        DATA_AXIS,
        MODEL_AXIS,
        catalog_spec,
        check_batch_divisibility,
        data_shard,
        edge_shard,
        gcn_param_shardings,
        make_mesh,
        placed_all_reduce,
        shard_batch,
        shard_blocks,
    )
    from diffmm_tpu_torch.parallel.mesh import axis_index, axis_size

    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = {}
    mesh = make_mesh(4, model_parallel=2)
    out["shape"] = (axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS))
    out["coords"] = (axis_index(mesh, DATA_AXIS), axis_index(mesh, MODEL_AXIS))
    out["names"] = tuple(mesh.mesh_dim_names)
    errors = {}
    for name, call in (("too_many", lambda: make_mesh(5)), ("divide", lambda: make_mesh(4, 3)),
                       ("batch", lambda: check_batch_divisibility(3, mesh)),
                       ("a7b", lambda: gcn_param_shardings({"i_embs": torch.zeros(4, 2)}, mesh))):
        try:
            call()
        except (ValueError, NotImplementedError) as e:
            errors[name] = (type(e).__name__, str(e))
    out["errors"] = errors
    check_batch_divisibility(4, mesh)
    flat = make_mesh(4, model_parallel=1)
    out["flat_shape"] = (axis_size(flat, DATA_AXIS), axis_size(flat, MODEL_AXIS))
    out["replicated"] = gcn_param_shardings({"u_embs": 0, "modal_proj": [{"w": 0}]}, flat)
    # placed all-reduce: rank r writes rows [2r, 2r + 2) of an (8, 3) frame
    local = torch.full((2, 3), float(rank + 1)) + torch.arange(3.0)
    out["placed_rows"] = placed_all_reduce(local, 2 * rank, 8, dist.group.WORLD).numpy()
    ids = torch.full((2, 1), rank, dtype=torch.int64)
    out["placed_cols"] = placed_all_reduce(ids, rank, 4, dist.group.WORLD, dim=1).numpy()
    x = torch.arange(8)
    out["batch_rows"] = shard_batch(x, flat).tolist()
    out["block_rows"] = shard_blocks(x.view(2, 4), flat).tolist()
    out["data_shard"] = tuple(data_shard(mesh)[:2])
    out["edge_shard"] = tuple(edge_shard(mesh)[:2])
    out["catalog"] = (catalog_spec(10, mesh), catalog_spec(9, mesh), catalog_spec(9, None))
    return out


@pytest.fixture(scope="module")
def four_ranks():
    return run_ranks(_four_rank_checks, 4)


def test_mesh_shape_and_coordinates(four_ranks):
    """The (data, model) grid is the JAX one: make_mesh(4, 2) is 2x2, rank
    r at (r // 2, r % 2), as np.reshape(devices, (n // m, m)) lays out the
    JAX mesh."""
    from diffmm_tpu.parallel import DATA_AXIS, MODEL_AXIS, make_mesh

    j_mesh = make_mesh(4, model_parallel=2)
    grid = np.asarray([[d.id for d in row] for row in j_mesh.devices])
    for rank, out in enumerate(four_ranks):
        assert out["names"] == (DATA_AXIS, MODEL_AXIS) == j_mesh.axis_names
        assert out["shape"] == (j_mesh.shape[DATA_AXIS], j_mesh.shape[MODEL_AXIS]) == (2, 2)
        pos = np.argwhere(grid == j_mesh.devices.flat[rank].id)[0]
        assert out["coords"] == tuple(int(p) for p in pos)
        assert out["flat_shape"] == (4, 1)


def test_mesh_errors_match_jax(four_ranks):
    """Too many devices and a model axis that does not divide: the JAX
    messages, numbers aside; the batch guard's message word for word
    (data axis 2 on both sides)."""
    from diffmm_tpu.parallel import check_batch_divisibility, make_mesh

    want = {}
    for name, call in (("too_many", lambda: make_mesh(9)), ("divide", lambda: make_mesh(8, 3))):
        with pytest.raises(ValueError) as info:
            call()
        want[name] = str(info.value)
    with pytest.raises(ValueError) as info:
        check_batch_divisibility(3, make_mesh(4, model_parallel=2))
    errors = four_ranks[0]["errors"]
    assert errors["too_many"] == ("ValueError", "requested 5 devices, only 4 available")
    assert _numbers_out(errors["too_many"][1]) == _numbers_out(want["too_many"])
    assert errors["divide"] == ("ValueError", "model_parallel=3 must divide 4 devices")
    assert _numbers_out(errors["divide"][1]) == _numbers_out(want["divide"])
    assert errors["batch"] == ("ValueError", str(info.value))


def test_model_axis_training_names_a7b(four_ranks):
    """A model axis above 1 in training refuses with ROADMAP.md A7b; a
    DATAx1 mesh places every parameter replicated."""
    kind, msg = four_ranks[0]["errors"]["a7b"]
    assert kind == "NotImplementedError" and "A7b" in msg
    assert four_ranks[0]["replicated"] == {"u_embs": "replicated", "modal_proj": [{"w": "replicated"}]}


def test_placed_all_reduce_is_an_all_gather(four_ranks):
    want_rows = np.concatenate([np.full((2, 3), r + 1.0) + np.arange(3.0) for r in range(4)])
    for out in four_ranks:
        np.testing.assert_array_equal(out["placed_rows"], want_rows)
        np.testing.assert_array_equal(out["placed_cols"], np.tile(np.arange(4), (2, 1)))


def test_batch_and_block_shares(four_ranks):
    """shard_batch / shard_blocks: rank r's rows [2r, 2r + 2) on a 4x1 mesh,
    the rows JAX's data-axis placement gives device r."""
    for r, out in enumerate(four_ranks):
        assert out["batch_rows"] == [2 * r, 2 * r + 1]
        assert out["block_rows"] == [[r], [4 + r]]
        assert out["data_shard"] == (r // 2, 2)
        assert out["edge_shard"] == (r, 4)
        assert out["catalog"] == ("catalog", "replicated", "replicated")


@pytest.mark.parametrize("n, count", [(0, 2), (7, 2), (1024, 4), (1030, 4), (3, 8), (307200, 2)])
def test_edge_ranges_cover_every_edge_once(n, count):
    spans = [edge_range(n, r, count) for r in range(count)]
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in spans])
    np.testing.assert_array_equal(covered, np.arange(n))
    assert all(lo <= hi for lo, hi in spans)
    if n % count == 0:
        assert len({hi - lo for lo, hi in spans}) == 1
