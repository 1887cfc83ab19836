"""Coach: runs training and eval on one device or on a mesh.

Counterpart of ``diffmm_tpu/train/coach.py``: the graph-form choice
(``choose_graph_form`` with ``dense_graph_budget_bytes`` and
``estimate_state_bytes``, lines 69-186) and the train store that follows
it (281-293), the schedule, the CSR gather layout and the degree-bucket
plan (314-346), the parameters and their Adam states (``_init_state``,
403-484), the hyperparameters (``_hp``, 520-536), the epoch
(``train_epoch``, ``_joint_phase``, ``_epoch_result``, 769-919) with its
phase-2 rebuild as :meth:`Coach.rebuild_graphs`, ``test_epoch``
(1232-1293), the best-epoch capture (``capture_best``, ``best_state``,
1296-1341), ``reset`` (486-492), the fused multi-epoch chunks
(``train_epochs_fused``, ``_fused_eval_blocks``, ``_capture_best_from``,
``_chunk_size``, 976-1229), the checkpoints (``_ckpt_arrays``,
``save_checkpoint``, ``restore_checkpoint``, 1343-1447), the epoch loop
with resume and periodic saves (``make_print``, ``run``, 1450-1587), and
the KNN ablation's graphs (``_knn_adjs``, 719-733, and its branches in the
epoch, the fused path, the best epoch and the checkpoints).

On the card each phase's per-block step is a captured CUDA graph, replayed
for every block (``train/graphs.py``, ``self.graphs``), the counterpart of
the JAX package's compiled phase programs. What the graphs read stays put:
the parameters and Adam moments are updated in place, the modality
adjacencies are rebuilt in place each epoch (:meth:`Coach.set_edge_buffers`),
and whatever replaces such a tensor (``load_params``, ``reset``,
``restore_checkpoint``) drops the graphs. An epoch uploads its host draws
once as it starts and reads its results once as it ends; a fused chunk of
``train.epoch_scan`` epochs does the same for the whole chunk, with the
eval of each ``tstEpoch`` boundary and the best epoch's state kept on the
card between.

The execution knobs: ``base.denoise_param_dtype="bf16"`` stores the
denoisers and their Adam moments in bf16 (``train/optim.py``);
``train.rebuild_compute`` and the denoiser's depth choose the rebuild's
forward (``train/steps.py::rebuild_forward``); ``train.dense_store="int4"``
packs the dense blocks two cells a byte, which K1 reads;
``train.donate_buffers`` is accepted and changes nothing (the port updates
its state in place already).

On a mesh (``mesh=``, a ``(data, model)`` DeviceMesh of
``parallel/mesh.py``) the Coach computes the JAX mesh Coach's function,
which is the one-device function (JAX ``coach.py:206-221, 303-306,
442-460``). The catalog-wide state is split over the model axis as JAX's
``NamedSharding``s split it (``parallel/sharding.py``): each rank holds its
rows of ``i_embs``, its catalog range of each denoiser's first in-layer and
its columns of the last out-layer, with their Adam moments, its (U, I/m)
columns of a dense train store, and on the dense form its (U, I/m) column
block of every adjacency; the rest is replicated (a CSR store too). Each
rank takes its part of every diffusion, rebuild, joint and eval block (a
:class:`~diffmm_tpu_torch.parallel.sharding.Split`; the batch sizes must
divide over the data axis), sums its range of the sparse form's
edges (K4's mesh forms), and the steps' collectives make the rest global
(``train/steps.py``). The steps are captured CUDA graphs under NCCL, with
their collectives inside; under gloo (named for CPU ranks and for ranks
that share a card) they run eagerly, decided from the backend here and
said in the log. Checkpoints hold whole arrays, gathered from the ranks'
slices, which rank 0 writes while every rank waits; every rank restores
its slices of the same file, so a checkpoint restores into any mesh and
into a Coach without one.

Random draws come from one ``torch.Generator`` on the Coach's device
(parameter init, negatives, diffusion timesteps and noise, the rebuild's
noise, the CL noise); the user and interaction permutations come from
``np.random.default_rng(seed)`` as in the JAX Coach, so both packages
visit the blocks in the same order. A fused chunk draws both streams
exactly as its epochs one at a time would (``tests/test_torch_fused.py``),
so checkpoints of either path resume into the other.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from diffmm_tpu_torch.config import Config, check_slice_support
from diffmm_tpu_torch.convert import tree_to
from diffmm_tpu_torch.data.loader import EDGE_ALIGN, HostData, to_device
from diffmm_tpu_torch.data.membership import DenseShard
from diffmm_tpu_torch.data.sampling import negative_sampling
from diffmm_tpu_torch.diffusion.schedule import make_schedule
from diffmm_tpu_torch.eval.ranking import dcg_table, eval_epoch
from diffmm_tpu_torch.models.denoise import init_denoise_params
from diffmm_tpu_torch.models.gcn import init_gcn_params
from diffmm_tpu_torch.ops.graph import BiAdj, build_bi_adj_device, build_dense_bi_adj_device
from diffmm_tpu_torch.ops.topk import make_csr_gather_layout, plan_rebuild_buckets
from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_
from diffmm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size
from diffmm_tpu_torch.parallel.sharding import (
    catalog_range,
    check_batch_divisibility,
    edge_shard,
    gather_adam_state,
    gather_params,
    make_split,
    place_adam_state,
    shard_device_data,
    shard_params,
)
from diffmm_tpu_torch.train import steps
from diffmm_tpu_torch.train.graphs import GraphCache
from diffmm_tpu_torch.train.optim import (
    AdamState,
    adam_init,
    adam_scalars,
    cosine_lr,
    tree_leaves,
    tree_map,
)
from diffmm_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    rng_state_from_json,
    rng_state_to_json,
)
from diffmm_tpu_torch.utils.device import resolve_device
from diffmm_tpu_torch.utils.logging import Log, NullLog
from diffmm_tpu_torch.utils.profiling import PhaseTimer, StepParts, settle, span

# Blocks budget where the device reports no memory size (the CPU), as in
# the JAX package; on the card the budget derives from its memory.
DENSE_GRAPH_BUDGET_BYTES = 4 << 30
_DENSE_BUDGET_HBM_FRACTION = 0.6

# train.dense_store -> (storage type, bytes a cell); a uint8 block is packed
# int4, two cells a byte (ops/kernels/spmm_dual.py)
_DENSE_STORES = {"int8": (torch.int8, 1.0), "bf16": (torch.bfloat16, 2.0), "int4": (torch.uint8, 0.5)}
_PARAM_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

_LOSS_NAMES = {"image": "image loss", "text": "text loss", "audio": "audio loss"}
# the eval's parts (its span's): the GCN forward, then the ranking
_EVAL_PARTS = StepParts("eval", ("forward", "rank"))


def resolve_dense_store(name: str) -> tuple[torch.dtype, float]:
    """``train.dense_store``'s block storage type and bytes a cell (JAX
    ``resolve_dense_store``)."""
    if name not in _DENSE_STORES:
        raise ValueError(f"train.dense_store must be {'|'.join(_DENSE_STORES)}, got {name!r}")
    return _DENSE_STORES[name]


def dense_graph_budget_bytes(device: torch.device, state_bytes: int = 0) -> int:
    """Per-device memory budget for the dense-form interaction blocks:
    0.6 x the card's memory (``torch.cuda.mem_get_info``) minus the other
    resident state; the 4 GiB constant on the CPU."""
    if device.type != "cuda":
        return DENSE_GRAPH_BUDGET_BYTES
    _, total = torch.cuda.mem_get_info(device)
    return max(0, int(total * _DENSE_BUDGET_HBM_FRACTION) - state_bytes)


def estimate_state_bytes(
    n_modal: int, user_num: int, item_num: int, latdim: int,
    hidden: list, d_emb_size: int, feat_dims, param_bytes: int = 4,
) -> int:
    """Dominant resident state besides the interaction blocks: the
    denoisers' catalog-wide layers x 3 copies (params + Adam moments), the
    GCN params x 3, and the (U, I) int8 train store. A lower bound, as in
    the JAX package."""
    h0, hl = int(hidden[0]), int(hidden[-1])
    denoise = (item_num + d_emb_size) * h0 + hl * item_num
    gcn = (user_num + item_num + int(sum(feat_dims))) * latdim
    return n_modal * 3 * denoise * param_bytes + 3 * gcn * 4 + user_num * item_num


def dense_blocks_bytes(n_modal: int, user_num: int, item_num: int, bytes_per_cell: float) -> float:
    """The dense form's (n_modal + 1) blocks, plus one transient bf16 copy
    for stores narrower than bf16 (JAX ``choose_graph_form``)."""
    bytes_needed = (n_modal + 1) * user_num * item_num * bytes_per_cell
    if bytes_per_cell < 2:
        bytes_needed += user_num * item_num * 2
    return bytes_needed


def choose_graph_form(
    form: str, n_modal: int, user_num: int, item_num: int,
    bytes_per_cell: float = 1.0, budget_bytes: int = DENSE_GRAPH_BUDGET_BYTES,
    model_parallel: int = 1,
) -> bool:
    """True -> dense form. ``form``: auto|dense|sparse. Under auto the
    blocks (:func:`dense_blocks_bytes`) must fit ``budget_bytes`` a device
    times ``model_parallel``, the ranks that share them by catalog columns
    (JAX ``choose_graph_form``, ``coach.py:162-186``)."""
    if form == "auto":
        return (dense_blocks_bytes(n_modal, user_num, item_num, bytes_per_cell)
                <= budget_bytes * max(model_parallel, 1))
    if form in ("dense", "sparse"):
        return form == "dense"
    raise ValueError(f"train.graph_form must be auto|dense|sparse, got {form!r}")


def _pad_blocks(n: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """Indices [0, n) padded to a multiple of ``batch`` + validity mask."""
    n_blocks = max(1, -(-n // batch))
    idx = np.zeros(n_blocks * batch, dtype=np.int32)
    idx[:n] = np.arange(n, dtype=np.int32)
    valid = np.zeros(n_blocks * batch, dtype=bool)
    valid[:n] = True
    return idx, valid


class Coach:
    """Training, rebuild, forward, eval and serving state for one dataset
    on one device (``cuda`` unless ``device="cpu"``), or on this rank's
    device of ``mesh``. ``checkpoint_dir`` turns on checkpoints
    (:class:`~diffmm_tpu_torch.utils.checkpoint.CheckpointManager`):
    ``run`` resumes from the latest one and saves every ``checkpoint_every``
    epochs and after the last."""

    def __init__(
        self,
        config: Config,
        host: HostData,
        device: str | torch.device | None = None,
        log: Log | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 10,
        mesh=None,
    ):
        self.device = resolve_device(device)
        check_slice_support(config)
        self.config = config
        self.host = host
        self.mesh = mesh
        self.rank = 0
        self.edge_shard = None
        # every step captured: on one card, and under NCCL (collectives in
        # the graphs); eager under gloo, whose collectives cannot be captured
        self.capture_steps = True
        if mesh is not None:
            check_batch_divisibility(config.train.batch, mesh)
            check_batch_divisibility(config.train.test_batch, mesh)
            self.rank = dist.get_rank()
            self.edge_shard = edge_shard(mesh)
            self.capture_steps = dist.get_backend() == "nccl"
        self.log = log or Log("coach", config.data.name) if self.rank == 0 else NullLog()
        self.n_modal = len(host.modalities)
        # Checked as the JAX package checks them, then ignored: the port has
        # one denoiser path (K2/K3 on the card, their plain versions on the
        # CPU) and one top-k (``ops/topk.py::catalog_topk``). So is
        # ``train.stack_modal``: the sparse form always stacks its modal
        # propagations (``models/gcn.py``).
        for name, allowed in (
            ("base.denoiser_impl", ("auto", "xla", "pallas")),
            ("train.rebuild_topk", ("approx", "exact")),
        ):
            section, key = name.split(".")
            value = getattr(getattr(config, section), key)
            if value not in allowed:
                raise ValueError(f"{name} must be {'|'.join(allowed)}, got {value!r}")
        if config.train.epoch_scan < 1:
            raise ValueError(f"train.epoch_scan must be >= 1, got {config.train.epoch_scan}")
        # bf16 denoisers with their Adam moments (JAX coach.py:422-441); K2/K3
        # take them widened to f32 (train/steps.py::rebuild_forward), so the
        # JAX package's refusal for its Pallas kernel's f32 VMEM plan has no
        # counterpart here
        self.dn_dtype = _PARAM_DTYPES[config.base.denoise_param_dtype]
        # the KNN ablation's modality graphs replace the rebuild
        self.knn = bool(config.hyper.use_knn_adj)

        self.dense_store_dtype, bytes_per_cell = resolve_dense_store(config.train.dense_store)
        budget = DENSE_GRAPH_BUDGET_BYTES
        if config.train.graph_form == "auto":
            if config.train.dense_budget_gb > 0:
                budget = int(config.train.dense_budget_gb * (1 << 30))
            else:
                budget = dense_graph_budget_bytes(
                    self.device,
                    estimate_state_bytes(
                        self.n_modal, host.user_num, host.item_num,
                        config.base.latdim, config.base.denoise_dims(),
                        config.base.d_emb_size, host.feat_dims,
                        param_bytes=self.dn_dtype.itemsize,
                    ),
                )
        model_parallel = 1 if mesh is None else axis_size(mesh, MODEL_AXIS)
        self.dense_graphs = choose_graph_form(
            config.train.graph_form, self.n_modal, host.user_num, host.item_num,
            bytes_per_cell, budget, model_parallel=model_parallel,
        )
        if config.train.graph_form == "auto" and not self.dense_graphs:
            blocks = dense_blocks_bytes(self.n_modal, host.user_num, host.item_num, bytes_per_cell)
            self.log.info(
                f"auto graph form: sparse (blocks+reserve {blocks / 2**30:.2f} GiB > budget "
                f"{budget * model_parallel / 2**30:.2f} GiB; train.dense_budget_gb overrides)"
            )
        if config.train.segsum_compute not in ("f32", "bf16"):
            raise ValueError(
                f"train.segsum_compute must be f32|bf16, got {config.train.segsum_compute!r}"
            )
        store = config.train.train_store
        if store == "auto":
            # the sparse form exists because O(U·I) does not fit, so its
            # membership store is O(nnz) too (JAX coach.py:281-287)
            self.train_store_form = "dense" if self.dense_graphs else "csr"
        elif store in ("dense", "csr"):
            self.train_store_form = store
        else:
            raise ValueError(f"train.train_store must be auto|dense|csr, got {store!r}")
        # a dense train store keeps a rank's catalog columns only (JAX
        # _place_train_store: the largest array of the dense regime)
        self.data = to_device(
            host, self.device, self.train_store_form,
            with_sparse_adj=not self.dense_graphs, batch=config.train.batch,
            store_cols=None if mesh is None else catalog_range(host.item_num, mesh),
        )
        if mesh is not None:
            self.data = shard_device_data(self.data, mesh)

        self.schedule = make_schedule(
            config.hyper.noise_scale, config.hyper.noise_min, config.hyper.noise_max,
            config.hyper.steps, device=self.device,
        )
        self.edge_buf_len = host.nnz + (-host.nnz % EDGE_ALIGN)
        u_of_pos, lane_of_pos, pad_mask = make_csr_gather_layout(
            host.user_degrees, self.edge_buf_len
        )
        batch = config.train.batch
        if config.train.rebuild_order == "degree":
            plan = plan_rebuild_buckets(host.user_degrees, batch, host.item_num)
            u_of_pos = plan.row_of_user[u_of_pos]
            blocks, widths, starts = plan.user_blocks, plan.widths, plan.row_starts
        elif config.train.rebuild_order == "identity":
            idx, _ = _pad_blocks(host.user_num, batch)
            blocks, widths, starts = (idx.reshape(-1, batch),), (host.k_max,), (0,)
        else:
            raise ValueError(
                "train.rebuild_order must be identity|degree, got "
                f"{config.train.rebuild_order!r}"
            )
        self.rebuild_blocks = tuple(torch.as_tensor(b, device=self.device) for b in blocks)
        self.rebuild_widths = tuple(int(w) for w in widths)
        self.rebuild_starts = tuple(int(s) for s in starts)
        self.csr_gather_layout = tuple(
            torch.as_tensor(a, device=self.device) for a in (u_of_pos, lane_of_pos, pad_mask)
        )
        # the diffusion blocks' pad mask and the joint blocks' padding are the
        # same every epoch
        self._diff_idx, valid = _pad_blocks(host.user_num, batch)
        self._diff_weights = torch.as_tensor(
            valid.astype(np.float32).reshape(-1, batch), device=self.device
        )
        self._joint_idx, _ = _pad_blocks(host.nnz, batch)
        self.cum_dcg = dcg_table(config.base.topk, self.device)
        self._fused_eval_cache: dict = {}
        self.timer = PhaseTimer(self.device)
        self.ckpt = None
        # the full state (parameters and Adam moments of every model) is
        # saved on an interval, and always after the last epoch
        self.checkpoint_every = max(1, checkpoint_every)
        if checkpoint_dir is not None:
            self.ckpt = CheckpointManager(checkpoint_dir)
        self.split = None
        self._init_state()
        if self.dense_graphs:
            self.data = self.data._replace(
                adj=self._make_adj(self.data.train_rows, self.data.train_cols)
            )

        self.log.info(f"USER: {host.user_num}, ITEM: {host.item_num}")
        self.log.info(f"NUM OF INTERACTIONS: {host.nnz}")
        self.log.info(
            f"Graph form: {'dense' if self.dense_graphs else 'sparse'} | "
            f"train store: {self.train_store_form} | device: {self.device}"
        )
        if host.synthesized:
            self.log.info(f"⚠️ synthesized missing feature blobs for: {host.synthesized}")
        if mesh is not None:
            self.log.info(
                f"Mesh: data={axis_size(mesh, DATA_AXIS)}, model={axis_size(mesh, MODEL_AXIS)} | "
                f"backend {dist.get_backend()} | steps "
                + ("captured (collectives inside)" if self.capture_steps
                   else "eager (gloo collectives cannot be captured)")
            )

    # ------------------------------------------------------------ state
    def _init_state(self) -> None:
        """(Re)initialise the parameters from ``base.seed`` (the JAX
        package's distributions, torch's own stream), their Adam states, the
        random streams and the run's trackers; drops any rebuilt graphs and
        every captured step (a new :class:`GraphCache` over the new
        generator)."""
        cfg = self.config
        host = self.host
        seed = cfg.base.seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)
        self.graphs = GraphCache(self.device, self.generator, capture=self.capture_steps,
                                 error_mode="global" if self.mesh is None else "thread_local")
        gcn_params = init_gcn_params(
            self.generator, host.user_num, host.item_num, cfg.base.latdim,
            host.feat_dims, self.device,
        )
        dn_params = [
            tree_map(lambda a: a.to(self.dn_dtype), init_denoise_params(
                self.generator, host.item_num, cfg.base.denoise_dims(),
                cfg.base.d_emb_size, cfg.base.latdim, self.device,
            ))
            for _ in range(self.n_modal)
        ]
        if self.mesh is not None:
            # every rank draws the whole parameters from the one seed and keeps
            # its slices (JAX shard_model_params)
            self.split = make_split(self.mesh, gcn_params, dn_params[0])
        self._set_params(gcn_params, dn_params)
        self.gcn_opt_state = adam_init(self.gcn_params)
        self.dn_opt_states = [adam_init(p) for p in self.dn_params]
        self.edge_buffers: list[torch.Tensor] | None = None
        self.modal_adjs = None
        # the best-Recall epoch's GCN params and edge buffers, host copies
        # (reference model selection, `Main.py:71-78`)
        self.best_snapshot: dict | None = None
        self.epoch_times: list[float] = []
        # cosine T_max; run(epochs=N) moves it to the effective count
        self.total_epochs = cfg.train.epoch
        self.timer.reset()

    def reset(self, seed: int | None = None) -> None:
        """Re-initialise the parameters, Adam states, random streams and
        trackers for a fresh run (JAX ``Coach.reset``), with ``base.seed``
        set to ``seed`` when given: the result equals a new Coach's. The
        captured CUDA graphs are dropped, not re-seeded: they read the old
        parameter tensors and generator, and the next epoch captures each
        step again (one step's time a phase, where the JAX package's reset
        exists to skip recompiles)."""
        if seed is not None:
            self.config.base.seed = seed
        self._init_state()

    def _set_params(self, gcn_params: dict, dn_params: list[dict]) -> None:
        """Take whole parameter trees on this device: on a mesh this rank's
        slices of them (:func:`~diffmm_tpu_torch.parallel.sharding.
        shard_params`), in their own storage."""
        split = self.split
        self.gcn_params = shard_params(gcn_params, None if split is None else split.gcn_place, split)
        self.dn_params = [shard_params(p, None if split is None else split.dn_place, split)
                          for p in dn_params]

    def load_params(self, gcn_params: dict, dn_params: list[dict],
                    gcn_opt_state: AdamState | None = None,
                    dn_opt_states: list[AdamState] | None = None) -> None:
        """Take whole parameters in the port's layout
        (``convert.params_from_jax`` makes them from a JAX run's) and,
        optionally, their Adam states (``convert.adam_state_from_jax``),
        copied to this Coach's device (on a mesh, this rank's slices of
        them); fresh Adam states otherwise. Drops any rebuilt graphs and
        captured steps."""
        dn_params = [tree_map(lambda a: a.to(self.dn_dtype), p)
                     for p in tree_to(list(dn_params), self.device)]
        if len(dn_params) != self.n_modal:
            raise ValueError(f"expected {self.n_modal} denoisers, got {len(dn_params)}")
        self._set_params(tree_to(gcn_params, self.device), dn_params)
        split = self.split

        def state_to(state, params, place):
            if state is None:
                return adam_init(params)
            state = place_adam_state(AdamState(state.count, tree_to(state.mu, self.device),
                                               tree_to(state.nu, self.device)), place, split)
            # the moments in their parameters' types, as optax's zeros_like
            mu, nu = ([m.to(p.dtype) for m, p in zip(ms, tree_leaves(params))] for ms in (state.mu, state.nu))
            return AdamState(state.count, mu, nu)

        g_place, d_place = (None, None) if split is None else (split.gcn_place, split.dn_place)
        self.gcn_opt_state = state_to(gcn_opt_state, self.gcn_params, g_place)
        dn_opt_states = dn_opt_states or [None] * self.n_modal
        self.dn_opt_states = [state_to(s, p, d_place) for s, p in zip(dn_opt_states, self.dn_params)]
        self.edge_buffers = None
        self.modal_adjs = None
        self.graphs.clear()

    def hp(self) -> dict:
        """The hyperparameter scalars of the phase functions, read from the
        config at each call (JAX ``_hp``)."""
        h = self.config.hyper
        return {
            "sim_weight": float(h.sim_weight),
            "reg": float(self.config.train.reg),
            "noise_degree": float(h.noise_degree),
            "cross_cl_temp": float(h.cross_cl_temp),
            "cross_cl_rate": float(h.cross_cl_rate),
            "modal_cl_temp": float(h.modal_cl_temp),
            "modal_cl_rate": float(h.modal_cl_rate),
            "modal_adj_weight": float(h.modal_adj_weight),
            "residual_weight": float(h.residual_weight),
        }

    def _make_adj(self, rows: torch.Tensor, cols: torch.Tensor, out=None):
        """A normalised adjacency in the run's graph form (into ``out`` in
        place when given), placed on the mesh (:meth:`_place`): a dense one
        holds this rank's catalog columns only."""
        if self.dense_graphs:
            split = self.split
            return self._place(build_dense_bi_adj_device(
                rows, cols, self.host.user_num, self.host.item_num, self.dense_store_dtype, out=out,
                cols=None if split is None else (split.lo, split.hi),
            ))
        return self._place(build_bi_adj_device(rows, cols, self.host.user_num, self.host.item_num, out=out))

    def _place(self, adj):
        """``adj`` with this rank's shard on a mesh: a sparse-form one sums
        the rank's edge range (``edge_shard``); a dense-form one runs K1's
        mesh form on its catalog columns (the :class:`Split`)."""
        if self.mesh is None:
            return adj
        return adj._replace(shard=self.edge_shard if isinstance(adj, BiAdj) else self.split)

    def _knn_adjs(self) -> list:
        """The KNN ablation's modality graphs (JAX ``_knn_adjs``; reference
        `Main.py:118-134`): a function of the features and the train edges
        only, built once a run."""
        from diffmm_tpu_torch.ops.knn import build_knn_adj

        return [self._place(build_knn_adj(self.data.train_rows, self.data.train_cols, feats,
                                          self.host.user_num, self.host.item_num,
                                          self.config.hyper.knn_topk))
                for feats in self.data.raw_feats]

    def set_edge_buffers(self, buffers: list[torch.Tensor]) -> None:
        """Take ``buffers`` (one CSR edge buffer a modality, on this device)
        as the epoch's rebuilt graphs and build the modality adjacencies from
        them: in place into the live ones (which the captured joint step
        reads), or new ones the first time."""
        self.edge_buffers = list(buffers)
        rows = self.data.train_rows
        if self.modal_adjs is None:
            self.modal_adjs = [self._make_adj(rows, b) for b in self.edge_buffers]
        else:
            for adj, b in zip(self.modal_adjs, self.edge_buffers):
                self._make_adj(rows, b, out=adj)

    # ------------------------------------------------------------ epoch
    def _lr(self, epoch: int) -> float:
        cfg = self.config.train
        return cosine_lr(epoch, cfg.lr, self.total_epochs) if cfg.use_lr_scheduler else cfg.lr

    def _epoch_tables(self, epoch0: int, n: int) -> list[dict]:
        """The host draws and Adam scalars of epochs ``[epoch0, epoch0 + n)``,
        uploaded at once: per epoch the diffusion blocks' users (the user
        permutation) and the joint blocks' interaction permutation, drawn
        from ``np_rng`` in the single-epoch order, and each phase's Adam
        scalars (``adam_scalars`` from the counts the phases will reach)."""
        host, batch = self.host, self.config.train.batch
        nb_d = len(self._diff_idx) // batch
        nb_j = len(self._joint_idx) // batch
        users, perms, dn_sc, g_sc = [], [], [], []
        for e in range(n):
            lr = self._lr(epoch0 + e)
            user_perm = self.np_rng.permutation(host.user_num).astype(np.int32)
            users.append(user_perm[self._diff_idx % host.user_num].reshape(nb_d, batch))
            perm = self.np_rng.permutation(host.nnz).astype(np.int32)
            perms.append(perm[self._joint_idx % host.nnz])
            dn_sc.append(np.stack([adam_scalars(lr, s.count + e * nb_d, nb_d)
                                   for s in self.dn_opt_states], axis=1))
            g_sc.append(adam_scalars(lr, self.gcn_opt_state.count + e * nb_j, nb_j))
        put = lambda a: torch.as_tensor(np.stack(a), device=self.device)  # noqa: E731
        users, perms, dn_sc, g_sc = put(users), put(perms), put(dn_sc), put(g_sc)
        return [{"users": users[e], "perm": perms[e], "dn_scalars": dn_sc[e], "gcn_scalars": g_sc[e]}
                for e in range(n)]

    def _epoch_on_device(self, tables: dict, fence: bool = False):
        """One epoch's four phases from its uploaded ``tables``, with nothing
        read back: returns the (M,) diffusion and (4,) joint accumulators on
        the device."""
        cfg = self.config
        data = self.data
        hp = self.hp()
        fence_dev = self.device if fence else None

        # phase 0: negative sampling (reference Main.py:137)
        with self.timer.phase("neg_sampling", fence_dev):
            negs = self.sample_negatives()
        # phase 1: diffusion training (reference Main.py:144-192)
        with self.timer.phase("diffusion", fence_dev):
            modal_acc = steps.diffusion_epoch(
                self.schedule, self.dn_params, self.dn_opt_states, self.gcn_params,
                data.raw_feats, data.train_store, tables["users"], self._diff_weights,
                tables["dn_scalars"], hp, self.host.item_num, self.generator, self.graphs,
                self.split,
            )
        # phase 2: modality graph rebuild (reference Main.py:195-253), or the
        # KNN ablation's graphs, built once a run (Main.py:118-134)
        if self.knn:
            if self.modal_adjs is None:
                self.modal_adjs = self._knn_adjs()
        else:
            with self.timer.phase("rebuild", fence_dev):
                self.rebuild_graphs()
        # phase 3: joint GCN training (reference Main.py:291-377)
        with self.timer.phase("joint", fence_dev):
            joint_acc = self._joint_phase(tables["perm"], negs, tables["gcn_scalars"], hp)
        return modal_acc, joint_acc

    def sample_negatives(self) -> torch.Tensor:
        """One negative item per padded train edge from the Coach's
        generator (phase 0). Where the model axis cuts the dense train store
        (a ``DenseShard``) each rank tests its own columns and the axis ORs
        the answers (``data/sampling.py``): the negatives of the whole store."""
        store = self.data.train_store
        group = self.split.cat.group if isinstance(store, DenseShard) else None
        return negative_sampling(self.data.train_rows, store, self.host.item_num,
                                 generator=self.generator, group=group)

    def train_epoch(self, epoch: int, fence: bool = False) -> dict[str, float]:
        """One training epoch: negative sampling, diffusion training, graph
        rebuild, joint training (reference `Main.py:136-388`). ``fence=True``
        waits for the card at the end of each phase, so each phase's time on
        ``self.timer`` is its own (at the cost of the overlap between
        phases). Returns the epoch's loss dict (read from the card once, at
        the end)."""
        with span("tables", self.device):
            (tables,) = self._epoch_tables(epoch, 1)
        modal_acc, joint_acc = self._epoch_on_device(tables, fence)
        with span("readback", self.device):
            joint_acc, modal_acc = joint_acc.cpu().numpy(), modal_acc.cpu().numpy()
        settle()
        return self._epoch_result(joint_acc, modal_acc)

    def _joint_phase(self, perm: torch.Tensor, negs: torch.Tensor, lr, hp: dict) -> torch.Tensor:
        """Phase 3, joint GCN training (reference Main.py:291-377), over the
        interaction permutation ``perm`` (its last block wraps around to the
        first interactions); ``lr`` a float or the phase's Adam scalars.
        Returns the (4,) accumulator on the device."""
        cfg = self.config
        data = self.data
        nb = perm.shape[0] // cfg.train.batch
        users, pos, neg = (a.index_select(0, perm).reshape(nb, cfg.train.batch)
                           for a in (data.train_rows, data.train_cols, negs))
        return steps.joint_epoch(
            self.gcn_params, self.gcn_opt_state, data.adj, self.modal_adjs, data.raw_feats,
            users, pos, neg, lr, hp, cfg.base.cl_method, cfg.train.segsum_compute,
            self.generator, self.graphs, self.split,
        )

    def _epoch_result(self, joint_acc, modal_acc) -> dict[str, float]:
        """One epoch's loss dict from the phase accumulators, with the
        reference's floor-division step counts (`Main.py:379-388`)."""
        train_steps_n = max(1, self.host.nnz // self.config.train.batch)
        diff_steps_n = max(1, self.host.user_num // self.config.train.batch)
        result = {
            "Loss": float(joint_acc[0]) / train_steps_n,
            "BPR Loss": float(joint_acc[1]) / train_steps_n,
            "reg loss": float(joint_acc[2]) / train_steps_n,
            "CL loss": float(joint_acc[3]) / train_steps_n,
        }
        for m, mod in enumerate(self.host.modalities):
            result[_LOSS_NAMES[mod]] = float(modal_acc[m]) / diff_steps_n
        return result

    @torch.no_grad()
    def rebuild_graphs(self) -> list[torch.Tensor]:
        """Phase 2 of an epoch: reverse-diffuse every user's train row per
        modality, keep each user's top-degree items as that modality's graph
        (reference `Main.py:195-253`). Sets ``edge_buffers`` and
        ``modal_adjs`` (:meth:`set_edge_buffers`) and returns the buffers.
        A KNN Coach has nothing to rebuild, and refuses."""
        cfg = self.config
        if self.knn:
            raise ValueError("hyper.use_knn_adj: the modality graphs are the KNN graphs, built once "
                             "a run; there is nothing to rebuild")
        self.set_edge_buffers(steps.rebuild_epoch(
            self.schedule, self.dn_params, self.data.train_store,
            self.rebuild_blocks, self.rebuild_widths, self.rebuild_starts,
            *self.csr_gather_layout, self.host.item_num,
            cfg.hyper.sampling_step, self.generator, self.graphs, cfg.train.rebuild_compute,
            self.split,
        ))
        return self.edge_buffers

    # ------------------------------------------------------------ fused
    def train_epochs_fused(self, epoch0: int, n: int, eval_split: str | None = None):
        """Train epochs ``[epoch0, epoch0 + n)`` as one chunk (JAX
        ``train_epochs_fused``): the host draws of all n epochs in the
        single-epoch order and their Adam scalars go to the card at once,
        the n epochs' phases replay their graphs, and nothing is read back
        until the chunk ends. The torch generator and the numpy stream end
        where n :meth:`train_epoch` calls leave them, with the same results,
        so checkpoints of the two paths are interchangeable
        (``tests/test_torch_fused.py``). Returns one loss dict per epoch.

        With ``eval_split``, each ``tstEpoch`` boundary also runs the
        full-catalog eval on the card and the best-Recall epoch's GCN
        parameters and edge buffers are kept in device copies
        (strictly-greater keeps the first best, as the JAX carry does).
        Returns ``(results, eval_results, best_bundle)`` then: eval dicts
        (None on epochs without eval) and ``(best_recall_sum,
        best_gcn_params, best_edge_buffers)`` on the card, None when no
        epoch evaluated. A KNN Coach refuses: its epochs rebuild nothing,
        and :meth:`_chunk_size` gives it single epochs."""
        cfg = self.config
        if self.knn:
            raise ValueError("epoch fusion needs the diffusion rebuild path "
                             "(hyper.use_knn_adj rebuilds nothing per epoch)")
        with span("tables", self.device):
            tables = self._epoch_tables(epoch0, n)
        flags = eval_blocks = None
        if eval_split is not None:
            flags = [(epoch0 + e) % cfg.train.tstEpoch == 0 for e in range(n)]
            if any(flags):
                eval_blocks = self._fused_eval_blocks(eval_split)
        with_eval = eval_blocks is not None
        modal_accs, joint_accs, eval_sums = [], [], []
        with self.timer.phase("fused"):
            if with_eval:
                best_recall = torch.full((), -torch.inf, device=self.device)
                best_g = tree_map(lambda p: p.detach().clone(), self.gcn_params)
                best_bufs = ([b.clone() for b in self.edge_buffers] if self.edge_buffers is not None
                             else [torch.zeros(self.edge_buf_len, dtype=torch.int32, device=self.device)
                                   for _ in range(self.n_modal)])
            for e in range(n):
                modal_acc, joint_acc = self._epoch_on_device(tables[e])
                modal_accs.append(modal_acc)
                joint_accs.append(joint_acc)
                if with_eval and flags[e]:
                    with self.timer.phase("eval"):
                        sums = self._eval_sums(eval_blocks[1])
                        # best-Recall tracking on the card (reference model
                        # selection, Main.py:71-78): strictly greater keeps
                        # the first best epoch
                        is_best = sums[0] > best_recall
                        best_recall = torch.where(is_best, sums[0], best_recall)
                        for kept, live in zip(tree_leaves(best_g), tree_leaves(self.gcn_params)):
                            kept.copy_(torch.where(is_best, live, kept))
                        for kept, live in zip(best_bufs, self.edge_buffers):
                            kept.copy_(torch.where(is_best, live, kept))
                        eval_sums.append(sums)
            with span("readback", self.device):
                modal_accs = torch.stack(modal_accs).cpu().numpy()
                joint_accs = torch.stack(joint_accs).cpu().numpy()
                eval_rows = torch.stack(eval_sums).cpu().numpy() if eval_sums else None
            settle()
        results = [self._epoch_result(joint_accs[e], modal_accs[e]) for e in range(n)]
        if eval_split is None:
            return results
        if not with_eval:
            # an empty split: test_epoch's zero metrics on the flagged epochs
            zero = {"Recall": 0.0, "NDCG": 0.0, "Precision": 0.0}
            return results, [zero if f else None for f in flags], None
        n_eval = eval_blocks[0]
        sums = iter(eval_rows)
        eval_results = []
        for flag in flags:
            row = next(sums) if flag else None
            eval_results.append(None if row is None else {
                "Recall": float(row[0]) / n_eval,
                "NDCG": float(row[1]) / n_eval,
                "Precision": float(row[2]) / n_eval,
            })
        return results, eval_results, (best_recall, best_g, best_bufs)

    def _fused_eval_blocks(self, split: str):
        """test_epoch's block layout of ``split``, made once and cached:
        ``(n_test, (users, valid, items, counts))`` in (n_blocks, batch)
        blocks on the device; None for an empty split."""
        if split in self._fused_eval_cache:
            return self._fused_eval_cache[split]
        data = self.data
        if split == "test":
            e_users, e_items, e_counts = data.test_users, data.test_items, data.test_counts
        elif split == "val":
            if data.val_users is None:
                raise ValueError(f"{self.host.name}: no valMat was loaded")
            e_users, e_items, e_counts = data.val_users, data.val_items, data.val_counts
        else:
            raise ValueError(f"unknown eval split {split!r}")
        n_test = int(e_users.shape[0])
        if n_test == 0:
            self._fused_eval_cache[split] = None
            return None
        batch = self.config.train.test_batch
        idx, valid = _pad_blocks(n_test, batch)
        idx_w = torch.as_tensor(idx % n_test, device=self.device).long()
        nb = len(idx) // batch
        blocks = (
            e_users[idx_w].reshape(nb, batch),
            torch.as_tensor(valid, device=self.device).reshape(nb, batch),
            e_items[idx_w].reshape(nb, batch, -1),
            e_counts[idx_w].reshape(nb, batch),
        )
        self._fused_eval_cache[split] = (n_test, blocks)
        return self._fused_eval_cache[split]

    @torch.no_grad()
    def _eval_sums(self, blocks, embeddings=None) -> torch.Tensor:
        """The (3,) Recall/NDCG/Precision sums over the eval ``blocks`` of
        :meth:`_fused_eval_blocks`, on the device (JAX
        ``_make_fused_eval_fn``): the GCN forward and the ranking eval. On
        a mesh each rank ranks its rows of every block (``split.rows``)
        against its catalog shard, the top-k merged over the model axis, and
        the sums are added over ``split.rows``."""
        dev = self.device
        _EVAL_PARTS.claim(dev)
        _EVAL_PARTS.mark(0, dev)
        u_final, i_final = embeddings if embeddings is not None else self.forward()
        _EVAL_PARTS.mark(1, dev)
        users, valid, items, counts = blocks
        split = self.split
        if split is None:
            sums = eval_epoch(u_final, i_final, users, valid, self.data.train_store, items, counts,
                              self.cum_dcg, self.config.base.topk)
        else:
            lo, hi = split.rows.span(users.shape[1])
            users, valid, items, counts = (a[:, lo:hi] for a in (users, valid, items, counts))
            sums = eval_epoch(u_final, i_final, users, valid, self.data.train_store, items, counts,
                              self.cum_dcg, self.config.base.topk, (split.lo, split.hi), split.cat)
            sums = all_reduce_sum_(sums, split.rows.group)
        _EVAL_PARTS.mark(2, dev)
        return sums

    def _capture_best_from(self, best_g, best_bufs, epoch: int) -> None:
        """capture_best from a fused chunk's device copies of its best epoch."""
        with span("best", self.device):
            self.best_snapshot = {
                "epoch": epoch,
                "gcn_params": tree_map(lambda p: p.to("cpu", copy=True), best_g),
                "edge_buffers": None if best_bufs is None else [b.to("cpu", copy=True) for b in best_bufs],
            }

    def _chunk_size(self, epoch: int, n_epochs: int) -> int:
        """``train.epoch_scan`` when a whole chunk of that many epochs fits
        from ``epoch`` with no checkpoint boundary inside it, else 1 (JAX
        ``_chunk_size``). Eval boundaries do not break chunks (the chunk
        evaluates on the card). Only whole chunks fuse, as in the JAX
        package, where each length is a new compile: here a shorter tail
        runs the single-epoch path, which replays the same graphs."""
        cfg = self.config
        if cfg.train.epoch_scan <= 1 or self.knn:
            return 1
        n = cfg.train.epoch_scan
        if n > n_epochs - epoch:
            return 1
        for j in range(n - 1):  # interior epochs epoch .. epoch+n-2
            if self.ckpt is not None and (epoch + j + 1) % self.checkpoint_every == 0:
                return 1
        return n

    # ------------------------------------------------------------ eval
    @torch.no_grad()
    def forward(self, params: dict | None = None, modal_adjs: list | None = None):
        """Final (user, item) embeddings of ``params`` over ``modal_adjs``
        (default: the live parameters over the rebuilt modality graphs)."""
        modal_adjs = self.modal_adjs if modal_adjs is None else modal_adjs
        if modal_adjs is None:
            raise RuntimeError("run rebuild_graphs() first: the forward reads the modality graphs")
        return steps.gcn_forward(
            self.gcn_params if params is None else params, self.data.adj, modal_adjs,
            self.data.raw_feats, self.hp(), self.config.train.segsum_compute, self.split,
        )

    @torch.no_grad()
    def test_epoch(self, split: str = "test", embeddings=None) -> dict[str, float]:
        """Full-catalog ranking eval (reference `Main.py:390-420`).
        ``embeddings``: (u_final, i_final) to rank instead of this Coach's
        forward."""
        blocks = self._fused_eval_blocks(split)
        if blocks is None:
            self.log.info(f"⚠️ eval split {split!r} has no users; skipping")
            return {"Recall": 0.0, "NDCG": 0.0, "Precision": 0.0}
        n_test, blocks = blocks
        with self.timer.phase("eval"):
            sums = self._eval_sums(blocks, embeddings).cpu().numpy()
            settle()
        return {
            "Recall": float(sums[0]) / n_test,
            "NDCG": float(sums[1]) / n_test,
            "Precision": float(sums[2]) / n_test,
        }

    # ------------------------------------------------------------ best epoch
    def capture_best(self, epoch: int) -> None:
        """Copy to the host the state that reproduces this epoch's eval: the
        GCN params and the rebuilt edge buffers (the denoisers do not feed
        eval; a KNN Coach's graphs do not change, so it keeps no buffers).
        Called whenever the best Recall improves."""
        self._capture_best_from(self.gcn_params, self.edge_buffers, epoch)

    def best_state(self):
        """(gcn_params, modal_adjs) of the best-Recall epoch on this Coach's
        device; the live state when no snapshot exists (no eval ran)."""
        snap = self.best_snapshot
        if snap is None:
            if self.modal_adjs is None:
                raise RuntimeError("no trained epoch and no best snapshot to serve from")
            return self.gcn_params, self.modal_adjs
        params = tree_to(snap["gcn_params"], self.device)
        if self.knn:
            return params, self.modal_adjs or self._knn_adjs()
        modal_adjs = [self._make_adj(self.data.train_rows, b.to(self.device))
                      for b in snap["edge_buffers"]]
        return params, modal_adjs

    # ------------------------------------------------------------ checkpoints
    def _whole(self, gcn_params=None, dn_params=None, gcn_state=None, dn_states=None) -> dict:
        """Whole trees from this rank's slices (collectives over the model
        axis: every rank calls it); the trees as they are without a mesh."""
        split = self.split
        g_place, d_place = (None, None) if split is None else (split.gcn_place, split.dn_place)
        out = {}
        if gcn_params is not None:
            out["gcn_params"] = gather_params(tree_to(gcn_params, self.device), g_place, split)
        if dn_params is not None:
            out["dn_params"] = [gather_params(p, d_place, split) for p in dn_params]
        if gcn_state is not None:
            out["gcn_opt_state"] = gather_adam_state(gcn_state, g_place, split)
        if dn_states is not None:
            out["dn_opt_states"] = [gather_adam_state(st, d_place, split) for st in dn_states]
        return out

    def _ckpt_arrays(self) -> dict:
        """The tensors of a checkpoint, whole (on a mesh gathered from the
        ranks' slices, a collective): parameters, Adam moments, the edge
        buffers, the best snapshot (the live state stands in before any
        eval; ``best_snapshot_epoch`` -1 marks it absent) and the
        generator's state; a KNN Coach has no edge buffers (empty lists).
        The Adam counts and the numpy stream go in the JSON part."""
        snap = self.best_snapshot
        buffers = self.edge_buffers or []
        if snap is None:
            best_params, best_buffers = self.gcn_params, buffers
        else:
            best_params, best_buffers = snap["gcn_params"], snap["edge_buffers"] or []
        live = self._whole(self.gcn_params, self.dn_params, self.gcn_opt_state, self.dn_opt_states)
        moments = lambda s: {"mu": s.mu, "nu": s.nu}  # noqa: E731
        return {
            "gcn_params": live["gcn_params"],
            "gcn_opt_state": moments(live["gcn_opt_state"]),
            "dn_params": live["dn_params"],
            "dn_opt_states": [moments(s) for s in live["dn_opt_states"]],
            "edge_buffers": buffers,
            "best_gcn_params": self._whole(best_params)["gcn_params"],
            "best_edge_buffers": best_buffers,
            "generator": self.generator.get_state(),
        }

    def save_checkpoint(self, epoch: int, best: dict) -> None:
        """Save the full training state after ``epoch`` with the run's
        best-metric tracking ``best``. On a mesh every rank takes part in
        gathering the whole arrays, rank 0 writes them, and every rank waits
        for the write."""
        if self.ckpt is None:
            raise RuntimeError("save_checkpoint needs a Coach made with checkpoint_dir")
        arrays = self._ckpt_arrays()
        if self.rank == 0:
            self.ckpt.save(epoch, arrays, aux={
                "epoch": epoch,
                "best": best,
                "np_rng": rng_state_to_json(self.np_rng),
                "gcn_count": self.gcn_opt_state.count,
                "dn_counts": [s.count for s in self.dn_opt_states],
                "best_snapshot_epoch": -1 if self.best_snapshot is None else self.best_snapshot["epoch"],
            })
        if self.mesh is not None:
            dist.barrier()

    def _load_state(self, arrays: dict, aux: dict) -> None:
        """Copy a checkpoint's whole state into this Coach's tensors in
        place (on a mesh this rank's slices of it; the tensors the captured
        steps read keep their addresses) and set its generator, numpy
        stream, Adam counts, edge buffers and best snapshot."""
        split = self.split
        g_place, d_place = (None, None) if split is None else (split.gcn_place, split.dn_place)
        cut = lambda tree, place: shard_params(tree_to(tree, self.device), place, split)  # noqa: E731
        with torch.no_grad():
            for live, saved in zip(tree_leaves(self.gcn_params), tree_leaves(cut(arrays["gcn_params"], g_place))):
                live.copy_(saved)
            for params, saved in zip(self.dn_params, arrays["dn_params"]):
                for live, value in zip(tree_leaves(params), tree_leaves(cut(saved, d_place))):
                    live.copy_(value)
            states = [self.gcn_opt_state, *self.dn_opt_states]
            places = [g_place] + [d_place] * len(self.dn_opt_states)
            saved_states = [arrays["gcn_opt_state"], *arrays["dn_opt_states"]]
            counts = [aux["gcn_count"], *aux["dn_counts"]]
            for state, saved, count, place in zip(states, saved_states, counts, places):
                whole = AdamState(int(count), tree_to(saved["mu"], self.device), tree_to(saved["nu"], self.device))
                placed = place_adam_state(whole, place, split)
                for live, value in zip(state.mu + state.nu, placed.mu + placed.nu):
                    live.copy_(value)
                state.count = int(count)
        self.generator.set_state(arrays["generator"])
        self.np_rng = rng_state_from_json(aux["np_rng"])
        if arrays["edge_buffers"]:
            self.set_edge_buffers([b.to(self.device) for b in arrays["edge_buffers"]])
        elif self.knn and self.modal_adjs is None:
            self.modal_adjs = self._knn_adjs()
        snap_epoch = aux["best_snapshot_epoch"]
        self.best_snapshot = None if snap_epoch < 0 else {
            "epoch": snap_epoch,
            "gcn_params": tree_map(lambda a: a.to("cpu", copy=True), cut(arrays["best_gcn_params"], g_place)),
            "edge_buffers": None if self.knn else list(arrays["best_edge_buffers"]),
        }

    def restore_checkpoint(self) -> dict | None:
        """Restore the latest checkpoint if there is one; returns the saved
        best-metric dict with ``epoch`` set to the saved epoch. The state is
        copied in place; the captured steps are dropped all the same (the
        next epoch captures them again), so none replays over a generator
        state it did not capture."""
        if self.ckpt is None or self.ckpt.latest_epoch() is None:
            return None
        _, arrays, aux = self.ckpt.restore()
        self._load_state(arrays, aux)
        self.graphs.clear()
        best = dict(aux["best"])
        best["epoch"] = aux["epoch"]
        self.log.info(f"Resumed from checkpoint at epoch {aux['epoch']} ♻️")
        return best

    # ------------------------------------------------------------ run
    def make_print(self, name: str, epoch: int, results: dict[str, float],
                   total: int | None = None) -> str:
        """Reference `Main.py:26-33`."""
        s = f"Epoch {epoch}/{total or self.config.train.epoch}, {name}: "
        s += ", ".join(f"{k}={v:.5f}" for k, v in results.items())
        return s + "  "

    def run(self, epochs: int | None = None, eval_split: str = "test") -> dict[str, float]:
        """Epoch loop with best tracking (reference `Main.py:45-82`): resume
        from the latest checkpoint, train in chunks of ``train.epoch_scan``
        epochs where :meth:`_chunk_size` allows (one epoch otherwise), stop
        on non-finite losses, eval every ``train.tstEpoch`` epochs and
        capture the best-Recall epoch, and save checkpoints every
        ``checkpoint_every`` epochs and after the last. Returns the best
        epoch and its metrics."""
        cfg = self.config
        n_epochs = epochs if epochs is not None else cfg.train.epoch
        self.total_epochs = n_epochs  # cosine T_max follows the effective count
        recall_max = ndcg_max = precision_max = 0.0
        his_max = [0.0, 0.0, 0.0]
        best_epoch = 0
        start_epoch = 0
        resumed = self.restore_checkpoint()
        if resumed is not None:
            start_epoch = resumed["epoch"] + 1
            recall_max = resumed.get("Recall", 0.0)
            ndcg_max = resumed.get("NDCG", 0.0)
            precision_max = resumed.get("Precision", 0.0)
            his_max = resumed.get("his_max", his_max)
            best_epoch = resumed.get("best_epoch", 0)
        self.log.info("Model Initialized ✅")
        self.log.info("Start training 🚀")
        try:
            epoch = start_epoch
            while epoch < n_epochs:
                chunk = self._chunk_size(epoch, n_epochs)
                t0 = time.perf_counter()
                eval_results = best_bundle = None
                if chunk > 1:
                    results, eval_results, best_bundle = self.train_epochs_fused(epoch, chunk, eval_split)
                else:
                    results = [self.train_epoch(epoch)]
                self.epoch_times.extend([(time.perf_counter() - t0) / chunk] * chunk)
                # divergence stops the run at the epoch (chunk) boundary; with
                # checkpoints on, the last good epoch is on disk to resume from
                for j, result in enumerate(results):
                    if not all(np.isfinite(v) for v in result.values()):
                        self.log.info(f"💥 Non-finite losses at epoch {epoch + j}: {result}")
                        raise FloatingPointError(f"training diverged at epoch {epoch + j}: {result}")
                    self.log.info(self.make_print("⏩ Train", epoch + j, result, n_epochs))
                self.log.info(f"⏱️ epoch {self.epoch_times[-1]:.2f}s ({self.timer.summary()})")
                self.timer.reset()
                if chunk > 1:
                    # the chunk evaluated on the card; fold its evals into the
                    # best tracking as the single-epoch branch below does
                    improved = False
                    for j, result in enumerate(eval_results or []):
                        if result is None:
                            continue
                        his_max = [max(a, b) for a, b in zip(
                            [result["Recall"], result["NDCG"], result["Precision"]], his_max
                        )]
                        if result["Recall"] > recall_max:
                            recall_max = result["Recall"]
                            ndcg_max = result["NDCG"]
                            precision_max = result["Precision"]
                            best_epoch = epoch + j
                            improved = True
                        self.log.info(self.make_print("🧪 Test", epoch + j, result, n_epochs))
                    if improved and best_bundle is not None:
                        self._capture_best_from(best_bundle[1], best_bundle[2], best_epoch)
                epoch = epoch + chunk - 1  # the chunk's last epoch: checkpoint here
                if chunk == 1 and epoch % cfg.train.tstEpoch == 0:
                    result = self.test_epoch(eval_split)
                    his_max = [max(a, b) for a, b in zip(
                        [result["Recall"], result["NDCG"], result["Precision"]], his_max
                    )]
                    if result["Recall"] > recall_max:
                        recall_max = result["Recall"]
                        ndcg_max = result["NDCG"]
                        precision_max = result["Precision"]
                        best_epoch = epoch
                        self.capture_best(epoch)
                    self.log.info(self.make_print("🧪 Test", epoch, result, n_epochs))
                self.log.info(
                    f"💡 Current best: Epoch: {best_epoch}, "
                    f"Recall: {recall_max:.5f}({his_max[0]:.5f}), "
                    f"NDCG: {ndcg_max:.5f}({his_max[1]:.5f}), "
                    f"Precision: {precision_max:.5f}({his_max[2]:.5f})"
                )
                if self.ckpt is not None and (
                    (epoch + 1) % self.checkpoint_every == 0 or epoch == n_epochs - 1
                ):
                    self.save_checkpoint(epoch, {
                        "Recall": recall_max,
                        "NDCG": ndcg_max,
                        "Precision": precision_max,
                        "his_max": his_max,
                        "best_epoch": best_epoch,
                    })
                epoch += 1
        except KeyboardInterrupt:
            self.log.info("🈲 Training interrupted by user!")
        return {
            "best_epoch": best_epoch,
            "Recall": recall_max,
            "NDCG": ndcg_max,
            "Precision": precision_max,
        }
