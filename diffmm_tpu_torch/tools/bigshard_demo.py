"""Catalog-axis memory at a size past one TPU chip, and the web-scale sparse
configuration, on the ranks of a ``(data, model)`` mesh.

Counterpart of ``tools/bigshard_demo.py``, with its options, defaults and
lines. The ranks are gloo processes spawned here (``parallel/launch.py::
run_ranks``, ``--devices`` of them, ``--model`` on the model axis), which
share the one card (or run on the CPU with ``--device cpu``); each
synthesises the data itself from the seed.

The dense form (the default) builds the 60,000 x 30,000 synthetic that the
JAX package's DESIGN.md records as too large for one TPU chip in dense
graph form, places each rank's catalog shard of every catalog-wide buffer
and parameter (the (U, I) int8 block and train store by columns, ``i_embs``
and the denoisers' wide layers as ``parallel/sharding.py`` cuts them),
prints each one's global and per-rank size, and runs the sharded GCN
forward (K1 on each rank's block) and one distributed top-k eval block:

  python -m diffmm_tpu_torch.tools.bigshard_demo --users 60000 --items 30000 --model 2

``--form sparse`` runs the web-scale configuration instead: the
segment-sum graph form with the O(nnz) CSR membership store at 200,000 x
100,000, where the dense form's blocks alone would need about 80 GB. It
builds the mesh Coach, asserts that no O(U·I) array exists on the host or
the card (``utils/contracts.py``), and runs one block of every phase
(diffusion, rebuild through K2/K3, joint over the full graph through K4's
mesh form) and one distributed eval block:

  python -m diffmm_tpu_torch.tools.bigshard_demo --form sparse --users 200000 \\
      --items 100000 --density 5e-5 --batch 512 --denoise-dim "[64]"

Each timed line says what its first run holds: the kernels were built when
the group started, so a line times the block's first, eager run (gloo
collectives cannot be captured). After the ranks end, each rank's peak card
memory goes on a line of its own, then each rank's kernel launch counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

FIRST_RUN = "first run, eager"
DENSE_DENSITY = 0.0015  # the JAX tool's fixed density of the dense form


def _clock(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _eval_block(u_final, i_final, store, split, batch: int, dev) -> torch.Tensor:
    """One block of ``batch`` users through the ranking eval: each rank its
    rows of the block (``split.rows``) against its catalog shard, the top-k
    merged over the model axis, the sums added over the rows' group (the
    JAX tool's ``make_eval_epoch`` on one block)."""
    from diffmm_tpu_torch.eval.ranking import dcg_table, eval_epoch
    from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_

    a, b = split.rows.span(batch)
    users = torch.arange(batch, dtype=torch.int32, device=dev)[a:b].view(1, -1)
    valid = torch.ones_like(users, dtype=torch.bool)
    items = torch.full((1, b - a, 2), -1, dtype=torch.int32, device=dev)
    counts = torch.ones_like(users)
    sums = eval_epoch(u_final, i_final, users, valid, store, items, counts, dcg_table(20, dev), 20,
                      (split.lo, split.hi), split.cat)
    return all_reduce_sum_(sums, split.rows.group)


def _host_data(cfg, args, say, **kwargs):
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data

    t0 = time.time()
    host = make_synthetic_host_data(cfg, user_num=args.users, item_num=args.items, seed=1, **kwargs)
    say(f"host data: {host.user_num}x{host.item_num}, nnz={host.nnz} ({time.time() - t0:.0f}s)")
    return host


def run_sparse(args, mesh, dev, say) -> None:
    """The sparse graph form with the CSR membership store on the mesh: the
    O(nnz) configuration end to end."""
    from diffmm_tpu_torch.config import Config
    from diffmm_tpu_torch.data.membership import TrainCSR
    from diffmm_tpu_torch.models.gcn import project_features
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.contracts import assert_no_ui_arrays

    cfg = Config()
    cfg.base.latdim = args.latdim
    cfg.base.denoise_dim = args.denoise_dim
    cfg.base.seed = 1
    cfg.hyper.steps = 2
    cfg.train.graph_form = "sparse"
    cfg.train.batch = args.batch
    cfg.train.test_batch = args.batch

    host = _host_data(cfg, args, say, density=args.density, modalities=["image", "text"],
                      feat_dims=[32, 32])
    t0 = time.time()
    coach = Coach(cfg, host, device=dev, mesh=mesh)
    data, split = coach.data, coach.split
    assert isinstance(data.train_store, TrainCSR), type(data.train_store)
    say(f"mesh Coach built ({time.time() - t0:.0f}s); train store: {coach.train_store_form}")

    # the point of the sparse form: nothing O(U·I) anywhere
    U, I = host.user_num, host.item_num
    assert_no_ui_arrays(vars(coach), U, I, "coach")
    assert host._train_dense is None, "the host built its dense (U, I) matrix"
    store = data.train_store
    csr_bytes = sum(x.nbytes for x in (store.cols, store.offsets, store.degrees))
    say(f"  membership store: {csr_bytes / 2**20:.1f} MiB CSR vs "
        f"{U * I / 2**30:.1f} GiB dense (U, I) int8 ({U * I / max(csr_bytes, 1):.0f}x)")

    hp, lr, batch = coach.hp(), cfg.train.lr, args.batch
    users = torch.arange(batch, dtype=torch.int32, device=dev)
    weights = torch.ones(batch, dtype=torch.float32, device=dev)
    t0 = _clock(dev)
    with torch.no_grad():
        feats = project_features(coach.gcn_params, data.raw_feats)
    losses = steps.diffusion_block(
        coach.schedule, coach.dn_params, coach.dn_opt_states, feats, coach.gcn_params["i_embs"], store,
        users, weights, lr, hp, I, generator=coach.generator, split=split,
    )
    say(f"diffusion block (B={batch}, CSR rows in-program): {_clock(dev) - t0:.1f}s ({FIRST_RUN})")

    t0 = _clock(dev)
    k_table = min(host.k_max, 64)
    with torch.no_grad():
        denoisers, apply = steps.rebuild_forward(coach.dn_params, cfg.train.rebuild_compute, None, split)
        tables = steps.rebuild_block_tables(coach.schedule, denoisers, store, users, I, 0, k_table,
                                            coach.generator, apply, split)
    say(f"rebuild block: {_clock(dev) - t0:.1f}s ({FIRST_RUN})")

    # joint step over the full graph (K4's mesh form), train-shaped edge buffers
    t0 = _clock(dev)
    modal_adjs = [coach._make_adj(data.train_rows, data.train_cols) for _ in host.modalities]
    pos = data.train_cols[:batch]
    metrics = steps.joint_block(
        coach.gcn_params, coach.gcn_opt_state, data.adj, modal_adjs, data.raw_feats,
        data.train_rows[:batch], pos, torch.remainder(pos + 1, I).to(torch.int32), lr, hp,
        cfg.base.cl_method, cfg.train.segsum_compute, generator=coach.generator, split=split,
    )
    say(f"joint block (full {U}x{I} graph, mesh segsum): {_clock(dev) - t0:.1f}s ({FIRST_RUN})")

    with torch.no_grad():
        u_final, i_final = steps.gcn_forward(coach.gcn_params, data.adj, modal_adjs, data.raw_feats, hp,
                                             cfg.train.segsum_compute, split)
        t0 = _clock(dev)
        sums = _eval_block(u_final, i_final, store, split, batch, dev)
    say(f"distributed-top-k eval block (CSR seen lists): {_clock(dev) - t0:.1f}s ({FIRST_RUN})")
    assert_no_ui_arrays(vars(coach), U, I, "coach after the blocks")
    finite = all(bool(torch.isfinite(x).all()) for x in (losses, metrics, sums, u_final, i_final))
    assert finite, "non-finite losses, metrics or embeddings"
    a, b = split.rows.span(batch)
    assert all(t.shape == (b - a, k_table) for t in tables), [t.shape for t in tables]
    say("bigshard sparse demo ok")


def run_dense(args, mesh, dev, say) -> None:
    """The dense form's per-rank table, the sharded GCN forward and one
    eval block."""
    from diffmm_tpu_torch.config import Config
    from diffmm_tpu_torch.data.loader import to_device
    from diffmm_tpu_torch.data.membership import DenseShard
    from diffmm_tpu_torch.models.denoise import init_denoise_params
    from diffmm_tpu_torch.models.gcn import gcn_mm, init_gcn_params
    from diffmm_tpu_torch.ops.graph import build_dense_bi_adj_device
    from diffmm_tpu_torch.parallel.sharding import catalog_range, make_split, shard_device_data, shard_params
    from diffmm_tpu_torch.train.coach import resolve_dense_store
    from diffmm_tpu_torch.train.steps import whole_gcn

    cfg = Config()
    cfg.base.latdim = args.latdim
    cfg.base.denoise_dim = args.denoise_dim
    cfg.train.graph_form = "dense"
    host = _host_data(cfg, args, say, density=DENSE_DENSITY)
    U, I = host.user_num, host.item_num
    data = shard_device_data(to_device(host, dev, "dense", store_cols=catalog_range(I, mesh)), mesh)
    host._train_dense = None  # the rank's columns are on the device

    gen = torch.Generator(device=dev).manual_seed(0)
    gcn = init_gcn_params(gen, U, I, cfg.base.latdim, host.feat_dims, dev)
    dns = [init_denoise_params(gen, I, cfg.base.denoise_dims(), cfg.base.d_emb_size, cfg.base.latdim, dev)
           for _ in host.modalities]
    split = make_split(mesh, gcn, dns[0])
    store_dtype, _ = resolve_dense_store(cfg.train.dense_store)
    adj = build_dense_bi_adj_device(data.train_rows, data.train_cols, U, I, store_dtype,
                                    cols=(split.lo, split.hi))._replace(shard=split)
    w_in, w_out = dns[0]["in_layers"][0]["w"], dns[0]["out_layers"][-1]["w"]
    d_emb = w_in.shape[0] - I
    # the global sizes from the whole leaves, then each rank keeps its slices
    whole = {"adj": U * I * adj.mat.element_size(), "store": U * I, "i_embs": gcn["i_embs"].nbytes,
             "w1x": I * w_in.shape[1] * w_in.element_size(), "w_out": w_out.nbytes}
    gcn = shard_params(gcn, split.gcn_place, split)
    dns = [shard_params(p, split.dn_place, split) for p in dns]
    w_in, w_out = dns[0]["in_layers"][0]["w"], dns[0]["out_layers"][-1]["w"]
    n = split.hi - split.lo
    store = data.train_store  # a DenseShard where the model axis cuts the catalog
    local = {"adj": adj.mat.numel() * adj.mat.element_size(),
             "store": (store.block if isinstance(store, DenseShard) else store).nbytes,
             "i_embs": gcn["i_embs"].nbytes, "w1x": w_in[:n].nbytes, "w_out": w_out.nbytes}
    labels = {
        "adj": f"dense adjacency (U, I) {str(adj.mat.dtype).removeprefix('torch.')}",
        "store": "train_store (dense (U, I) int8 or O(nnz) CSR)",
        "i_embs": "i_embs (I, d)",
        # the port cuts JAX's (I+demb, H) in-layer along the catalog: the
        # catalog rows (W1x) on the model axis, the d_emb time rows whole
        "w1x": f"denoiser in w catalog rows (I, H) of JAX's (I+demb, H), demb {d_emb}",
        "w_out": "denoiser out w (H, I)",
    }
    say("catalog-dim buffers on the mesh:")
    for key, label in labels.items():
        say(f"  {label:34s} global {whole[key] / 2**20:9.1f} MiB   per-device "
            f"{local[key] / 2**20:9.1f} MiB   x{whole[key] // local[key]}   "
            f"({whole[key]} / {local[key]} bytes)")

    t0 = _clock(dev)
    with torch.no_grad():
        out = gcn_mm(whole_gcn(gcn, split), adj, [adj] * len(host.modalities), data.raw_feats,
                     modal_adj_weight=0.5, residual_weight=0.5)
    say(f"sharded GCN forward over {args.users}x{args.items}: {_clock(dev) - t0:.1f}s ({FIRST_RUN})")
    t0 = _clock(dev)
    with torch.no_grad():
        sums = _eval_block(out.u_final, out.i_final, store, split, 64, dev)
    say(f"distributed-top-k eval block: {_clock(dev) - t0:.1f}s ({FIRST_RUN})")
    assert all(bool(torch.isfinite(x).all()) for x in (out.u_final, out.i_final, sums)), "non-finite output"
    say("bigshard demo ok")


def _rank(args) -> dict:
    """One rank of the demo: its mesh, its form, its peak card memory."""
    import torch.distributed as dist

    from diffmm_tpu_torch.ops.kernels import launch_counts
    from diffmm_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.devices))  # the ranks share the host
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # the context first: the peak counters need it
        torch.cuda.reset_peak_memory_stats(dev)
    rank = dist.get_rank()

    def say(line: str) -> None:
        if rank == 0:
            print(line, flush=True)

    mesh = make_mesh(args.devices, model_parallel=args.model)
    (run_sparse if args.form == "sparse" else run_dense)(args, mesh, dev, say)
    return {"peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
            "launches": launch_counts()}  # this process's, all of them the demo's


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--users", type=int, default=60_000)
    parser.add_argument("--items", type=int, default=30_000)
    parser.add_argument("--devices", type=int, default=8, help="ranks of the mesh (gloo processes)")
    parser.add_argument("--model", type=int, default=2, help="model-axis size")
    parser.add_argument("--latdim", type=int, default=64)
    parser.add_argument("--denoise-dim", default="[1024]")
    parser.add_argument("--form", default="dense", choices=["dense", "sparse"])
    parser.add_argument("--density", type=float, default=0.0015,
                        help="the sparse form's density (the dense form keeps 0.0015, as the JAX tool)")
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu: the ranks run the kernels' plain versions on the CPU")
    args = parser.parse_args(argv)

    from diffmm_tpu_torch.parallel.launch import run_ranks
    from diffmm_tpu_torch.parallel.mesh import mesh_refusal
    from diffmm_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: stop here
    refusal = mesh_refusal(args.devices, args.devices, args.model)
    if refusal:
        print(f"bigshard_demo: {refusal}", file=sys.stderr)
        return 1
    sys.stdout.flush()
    results = run_ranks(_rank, args.devices, (args,), backend="gloo", timeout=1800.0)
    for r, out in enumerate(results):
        peak = "not measured (cpu)" if out["peak_bytes"] is None else f"{out['peak_bytes']} bytes"
        print(f"rank {r} peak card memory: {peak}")
    for r, out in enumerate(results):
        print(f"rank {r} kernel launches: {json.dumps(out['launches'], sort_keys=True)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
