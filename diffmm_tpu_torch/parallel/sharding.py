"""Where every tensor of the workload lives on the mesh.

Counterpart of ``diffmm_tpu/parallel/sharding.py``. The JAX package places
global arrays with ``NamedSharding``s and lets XLA cut them; the port's
ranks each hold whole tensors and take their own part by index:

* **replicated**: the parameters, the Adam moments, the normalisation
  vectors, the features, the schedule, the train store, the dense form's
  (U, I) blocks (K1 runs whole on every rank, as JAX's
  ``catalog_sharded_or_replicated`` leaves them at model axis 1) and the
  rebuilt edge buffers.
* **data axis** (:class:`Shard` ``span`` of a block's rows): the rows of
  every interaction, diffusion, rebuild and eval block (JAX ``shard_batch``
  and ``shard_blocks``).
* **edges** (:func:`edge_shard`, over the ``(data, model)`` product, as the
  JAX Coach's ``axes=(DATA_AXIS, MODEL_AXIS)``, ``coach.py:581-590``): each
  rank sums a contiguous range ``[lo, hi)`` of the sparse form's padded
  edges in either order (``parallel/segsum.py``); the (nnz,) edge tensors
  stay whole.
* **model axis**: the catalog, in serving and the ranking eval only
  (:func:`catalog_spec`). Training with a model axis above 1 is ROADMAP.md
  A7b: :func:`gcn_param_shardings` and :func:`denoise_param_shardings`
  refuse it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch.distributed as dist

from diffmm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size

REPLICATED = "replicated"
CATALOG = "catalog"

A7B = (
    "training with a model axis above 1 is ROADMAP.md A7b (model-axis training: K1 over "
    "catalog-sharded blocks with a partial product and an all-reduce, K2 on a row-sharded W1, "
    "K3 on column shards, the rebuild's top-k over catalog shards, i_embs rows and their Adam "
    "moments); use a DATAx1 mesh"
)


class Shard(NamedTuple):
    """This rank's place along one split: ``index`` of ``count`` ranks of
    ``group``."""

    index: int
    count: int
    group: Any

    def span(self, n: int) -> tuple[int, int]:
        """This rank's contiguous range ``[lo, hi)`` of ``n`` positions: the
        ranks' ranges are ceil(n / count) long (the last ones shorter or
        empty) and cover every position once."""
        return edge_range(n, self.index, self.count)


def edge_range(n: int, index: int, count: int) -> tuple[int, int]:
    """Part ``index`` of ``count`` contiguous parts of ``[0, n)``."""
    chunk = -(-n // count)
    lo = min(index * chunk, n)
    return lo, min(lo + chunk, n)


def data_shard(mesh) -> Shard:
    """This rank's share of a block's rows, over the data axis."""
    return Shard(axis_index(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS), mesh.get_group(DATA_AXIS))


def edge_shard(mesh) -> Shard:
    """This rank's share of the edges, over the ``(data, model)`` product:
    the mesh spans every rank (``make_mesh``), so that is the world."""
    return Shard(dist.get_rank(), dist.get_world_size(), dist.group.WORLD)


def shard_batch(x, mesh):
    """This rank's rows of a per-batch tensor's leading dim (data axis)."""
    lo, hi = data_shard(mesh).span(x.shape[0])
    return x[lo:hi]


def shard_blocks(x, mesh):
    """This rank's rows of an (n_blocks, batch, ...) epoch input."""
    lo, hi = data_shard(mesh).span(x.shape[1])
    return x[:, lo:hi]


def check_batch_divisibility(batch: int, mesh) -> None:
    n_data = axis_size(mesh, DATA_AXIS)
    if batch % n_data:
        raise ValueError(
            f"train.batch={batch} must be divisible by the data-axis size "
            f"{n_data} for even sharding"
        )


def catalog_spec(last_dim: int, mesh) -> str:
    """The placement of a ``(..., catalog)`` tensor: :data:`CATALOG` (one
    catalog shard a model rank) when the model axis divides the catalog,
    else :data:`REPLICATED` (JAX ``catalog_spec``)."""
    if mesh is not None and last_dim % axis_size(mesh, MODEL_AXIS) == 0:
        return CATALOG
    return REPLICATED


def shard_device_data(data, mesh):
    """``data`` (``data/loader.DeviceData``) with the sparse-form main
    adjacency given this rank's edge range; every tensor stays whole."""
    if data.adj is None or not hasattr(data.adj, "shard"):
        return data
    return data._replace(adj=data.adj._replace(shard=edge_shard(mesh)))


def _replicated_tree(params):
    if isinstance(params, dict):
        return {k: _replicated_tree(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_replicated_tree(v) for v in params]
    return REPLICATED


def gcn_param_shardings(params: dict, mesh) -> dict:
    """The GCN parameters' placement (same structure): all replicated on a
    ``DATAx1`` mesh. A model axis above 1 would put ``i_embs`` rows on it
    (JAX ``gcn_param_shardings``): ROADMAP.md A7b, refused."""
    if axis_size(mesh, MODEL_AXIS) > 1:
        raise NotImplementedError(A7B)
    return _replicated_tree(params)


def denoise_param_shardings(params: dict, mesh) -> dict:
    """One denoiser's placement (same structure): all replicated on a
    ``DATAx1`` mesh. A model axis above 1 would split its catalog-wide
    layers (JAX ``denoise_param_shardings``): ROADMAP.md A7b, refused."""
    if axis_size(mesh, MODEL_AXIS) > 1:
        raise NotImplementedError(A7B)
    return _replicated_tree(params)
