"""Where every tensor of the workload lives on the mesh.

Counterpart of ``diffmm_tpu/parallel/sharding.py``. The JAX package places
global arrays with ``NamedSharding``s and lets XLA cut them; the port's
ranks hold tensors of their own and take their part by index:

* **replicated**: the narrow parameters (``u_embs``, the projections, the
  modality weights, the denoisers' time and hidden layers) and their Adam
  moments, the normalisation vectors, the features, the schedule, the CSR
  train store, the rebuilt edge buffers.
* **data axis** (:class:`Shard` ``span`` of a block's rows): the rows of
  every diffusion, rebuild and eval block (JAX ``shard_batch`` and
  ``shard_blocks``).
* **edges** (:func:`edge_shard`, over the ``(data, model)`` product, as the
  JAX Coach's ``axes=(DATA_AXIS, MODEL_AXIS)``, ``coach.py:581-590``): each
  rank sums a contiguous range ``[lo, hi)`` of the sparse form's padded
  edges in either order (``parallel/segsum.py``); the (nnz,) edge tensors
  stay whole.
* **model axis**: the catalog (:func:`catalog_spec`, :func:`catalog_range`).
  In serving and the ranking eval each rank scores its catalog shard; in
  training the catalog-wide parameters are cut as JAX's
  :func:`gcn_param_shardings` and :func:`denoise_param_shardings` cut them
  (``i_embs`` rows, the first in-layer's input rows, the last out-layer's
  columns and bias), with their Adam moments (:func:`place_adam_state`),
  and so are the dense form's (U, I) blocks: each rank builds its (U, I/m)
  block (``ops/graph.py``). The dense (U, I) int8 train store keeps a
  rank's catalog columns too (JAX ``_place_train_store``: the largest
  array of the dense regime), cut on the host (``data/loader.py::
  to_device``'s ``store_cols``, :func:`catalog_range`); its readers take
  the rank's range (``data/membership.py``).

How a step cuts its work is a :class:`Split` (:func:`make_split`): on a
catalog the model axis divides, a diffusion or rebuild block's rows over
the data axis and its catalog columns over the model axis; on one it does
not divide, the catalog stays whole on every rank (the rule of
:func:`catalog_spec`) and the rows go over the whole world. A joint block's
rows always go over the world: its GCN outputs are whole on every rank.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from diffmm_tpu_torch.parallel.collectives import all_reduce_grads, placed_all_reduce
from diffmm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size
from diffmm_tpu_torch.train.optim import tree_leaves

REPLICATED = "replicated"
CATALOG = "catalog"

ROWS = "rows"  # the catalog along dim 0 (leading rows past the catalog stay whole)
COLS = "cols"  # the catalog along dim 1


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
    adjacency given this rank's edge range; every tensor stays as it is (a
    dense train store was cut by ``to_device``)."""
    if data.adj is None or not hasattr(data.adj, "shard"):
        return data
    return data._replace(adj=data.adj._replace(shard=edge_shard(mesh)))




# ------------------------------------------------------------ model axis
def catalog_range(item_num: int, mesh) -> tuple[int, int]:
    """This rank's catalog range ``[lo, hi)`` along the model axis: its
    ``item_num / m`` items where the model axis divides the catalog, else
    the whole catalog (:func:`catalog_spec`: an undivided catalog stays
    replicated)."""
    if mesh is None or catalog_spec(item_num, mesh) != CATALOG:
        return 0, item_num
    m = axis_size(mesh, MODEL_AXIS)
    width = item_num // m
    lo = axis_index(mesh, MODEL_AXIS) * width
    return lo, lo + width


def _model_axis(mesh) -> int:
    return axis_size(mesh, MODEL_AXIS)


def _replicated_tree(tree):
    if isinstance(tree, dict):
        return {k: _replicated_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replicated_tree(v) for v in tree]
    return REPLICATED


def gcn_param_shardings(params: dict, mesh) -> dict:
    """The GCN parameters' placement (same structure; JAX
    ``gcn_param_shardings``): ``i_embs`` rows on the model axis (:data:`ROWS`)
    when the axis divides the catalog, everything else replicated."""
    sh = _replicated_tree(params)
    if "i_embs" in params and params["i_embs"].shape[0] % _model_axis(mesh) == 0:
        sh["i_embs"] = ROWS
    return sh


def denoise_param_shardings(params: dict, mesh) -> dict:
    """One denoiser's placement (same structure; JAX
    ``denoise_param_shardings``): the first in-layer's weight by its input
    rows (:data:`ROWS`) when the model axis divides ``item_num + d_emb``,
    the last out-layer's weight by its columns (:data:`COLS`) and its bias
    (:data:`ROWS`) when the axis divides ``item_num``; the rest replicated.

    The port cuts the first in-layer along the catalog, not along its
    ``item_num + d_emb`` rows: a rank holds its catalog range of the x rows
    (the kernels' W1x) followed by the ``d_emb`` time rows, which stay on
    every rank. That is the same function with another internal cut, and it
    needs the catalog cut: where the axis divides ``item_num + d_emb`` but
    not ``item_num`` (the catalog stays whole), the in-layer stays
    replicated here, where JAX splits it."""
    sh = _replicated_tree(params)
    m = _model_axis(mesh)
    item_num = params["out_layers"][-1]["w"].shape[1]
    if params["in_layers"][0]["w"].shape[0] % m == 0 and item_num % m == 0:
        sh["in_layers"][0]["w"] = ROWS
    if item_num % m == 0:
        sh["out_layers"][-1]["w"] = COLS
        sh["out_layers"][-1]["b"] = ROWS
    return sh


class Split(NamedTuple):
    """How this rank cuts a training step on a mesh (:func:`make_split`).

    Attributes:
      rows: the rank's share of a diffusion, rebuild or eval block's rows:
        the data axis when the catalog is cut, else the world. The ranks of
        ``rows.group`` hold different rows of one catalog range, so the
        gradients of the cut parameters are summed over it.
      world: the rank's share of a joint block's rows, and the group of the
        losses' sums and of the replicated parameters' gradients.
      cat: the model axis when it cuts the catalog, else None.
      lo, hi: the rank's catalog range (the whole catalog when ``cat`` is
        None).
      item_num: the catalog's size.
      gcn_place, dn_place: the placement trees of the GCN parameters and of
        one denoiser (:func:`gcn_param_shardings`,
        :func:`denoise_param_shardings`).
    """

    rows: Shard
    world: Shard
    cat: Shard | None
    lo: int
    hi: int
    item_num: int
    gcn_place: dict
    dn_place: dict


def make_split(mesh, gcn_params: dict, dn_params: dict) -> Split:
    """The :class:`Split` of ``mesh`` for parameters shaped as the whole
    ``gcn_params`` and one whole denoiser ``dn_params``."""
    item_num = gcn_params["i_embs"].shape[0]
    world = edge_shard(mesh)
    lo, hi = catalog_range(item_num, mesh)
    cut = catalog_spec(item_num, mesh) == CATALOG
    cat = Shard(axis_index(mesh, MODEL_AXIS), _model_axis(mesh), mesh.get_group(MODEL_AXIS)) if cut else None
    return Split(
        rows=data_shard(mesh) if cut else world, world=world, cat=cat, lo=lo, hi=hi, item_num=item_num,
        gcn_place=gcn_param_shardings(gcn_params, mesh), dn_place=denoise_param_shardings(dn_params, mesh),
    )


def _map2(fn, tree, place):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, place[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map2(fn, v, p) for v, p in zip(tree, place)]
    return fn(tree, place)


def shard_leaf(leaf, place: str, split: Split):
    """This rank's part of one whole leaf (its own storage)."""
    if place == REPLICATED:
        return leaf
    if place == COLS:
        return leaf[:, split.lo:split.hi].contiguous()
    if leaf.shape[0] == split.item_num:
        return leaf[split.lo:split.hi].contiguous()
    return torch.cat([leaf[split.lo:split.hi], leaf[split.item_num:]])


def gather_leaf(leaf, place: str, split: Split):
    """One whole leaf from the ranks' parts (a collective over the model
    axis for a cut leaf; every rank of the axis calls it)."""
    if place == REPLICATED:
        return leaf
    group, n = split.cat.group, split.hi - split.lo
    if place == COLS:
        return placed_all_reduce(leaf.contiguous(), split.lo, split.item_num, group, dim=1)
    whole = placed_all_reduce(leaf[:n].contiguous(), split.lo, split.item_num, group)
    return whole if leaf.shape[0] == n else torch.cat([whole, leaf[n:]])


def shard_params(tree, place, split: Split | None):
    """The rank's slices of a whole parameter tree placed by ``place``
    (identity without a split)."""
    if split is None:
        return tree
    return _map2(lambda t, p: shard_leaf(t, p, split), tree, place)


def gather_params(tree, place, split: Split | None):
    """The whole parameter tree from the ranks' slices (a collective over
    the model axis; identity without a split)."""
    if split is None:
        return tree
    return _map2(lambda t, p: gather_leaf(t, p, split), tree, place)


def place_adam_state(state, place, split: Split | None):
    """An Adam state over whole leaves with its moments cut as the
    parameters (JAX ``place_adam_state``: mu and nu mirror the params)."""
    if split is None:
        return state
    places = tree_leaves(place)
    cut = lambda ms: [shard_leaf(t, p, split) for t, p in zip(ms, places)]  # noqa: E731
    return type(state)(state.count, cut(state.mu), cut(state.nu))


def gather_adam_state(state, place, split: Split | None):
    """The whole moments of a cut Adam state (collective, as
    :func:`gather_params`)."""
    if split is None:
        return state
    places = tree_leaves(place)
    whole = lambda ms: [gather_leaf(t, p, split) for t, p in zip(ms, places)]  # noqa: E731
    return type(state)(state.count, whole(state.mu), whole(state.nu))


def reduce_grads(grads: list, place, split: Split | None) -> list:
    """The step's gradients summed over the ranks: a replicated leaf's (and
    the replicated time rows of a cut in-layer) over the world, a cut
    leaf's catalog part over ``split.rows`` only (the ranks that hold the
    same catalog range). Each rank's gradient is its share of the one
    loss's; identity without a split."""
    if split is None:
        return list(grads)
    n = split.hi - split.lo
    world, local, plan = [], [], []
    for g, p in zip(grads, tree_leaves(place)):
        if p == REPLICATED:
            plan.append((("w", len(world)),))
            world.append(g)
        elif p == COLS or g.shape[0] == n:
            plan.append((("l", len(local)),))
            local.append(g)
        else:
            plan.append((("l", len(local)), ("w", len(world))))
            local.append(g[:n])
            world.append(g[n:])
    summed = {"w": all_reduce_grads(world, split.world.group) if world else [],
              "l": all_reduce_grads(local, split.rows.group) if local else []}
    out = []
    for parts in plan:
        pieces = [summed[k][i] for k, i in parts]
        out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces))
    return out
