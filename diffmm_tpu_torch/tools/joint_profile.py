"""Decompose the joint step's time into measured components, the port of
``tools/joint_profile.py``.

After one training epoch (which builds the modality graphs and captures
each phase's CUDA graph), it times on the card, with the JAX tool's keys:

* ``spmm_fwd`` / ``spmm_bwd``: one propagation pass over the main graph
  (``ops/graph.py::spmm_bi``: one K1 launch on the dense form, a
  ``Propagate`` each way, K4, on the sparse form) at the config's shapes,
  and its gradient (forward and backward) of a squared-sum objective;
* ``gcn_forward``: the full multi-modal forward;
* ``joint_nocl``: the value and gradient of BPR + L2 alone;
* ``joint_step``: one replay of the Coach's captured joint step (forward,
  both CL terms, gradient, Adam), as training replays it;
* ``dispatch_overhead_ms``: the host's cost to launch one replay of that
  step (the host clock around the launches alone, the card drained after);
* on the sparse form also ``spmm_modal_fwd`` / ``spmm_modal_bwd`` (the same
  pass over the first modality graph), and the H100's least time for one
  pass from its bytes at 3.35 TB/s (``adj_pass_roofline_ms``: the (U, I)
  block's storage; ``sparse_pass_roofline_ms``: each direction's table
  rows in the messages' type, its edge indices and offsets, and its f32
  output).

Each component runs as the card runs a compiled program: captured once
in a CUDA graph and replayed (the port's counterpart of the JAX tool's
jitted sub-programs, and how training runs its steps), so a component's
time is the card's work and not the host's launches of it. It is timed
with CUDA events over ``--inner`` replays after two warm ones, the median
of ``--reps`` such runs. The JAX tool's ``lax.scan`` amortisation and its
per-rep input changes worked around its remote device's dispatch and
memoisation; a CUDA event pair times the card's own work. Its sparse
route rows ``spmm_scatter_*`` (the XLA scatter) have no counterpart: the
port has one sparse route, K4. The replays train the Coach's parameters as
they go, as the JAX tool's scan does.

  python -m diffmm_tpu_torch.tools.joint_profile -c conf/tiktok_tuned.toml --synthetic tiktok --inner 32
  python -m diffmm_tpu_torch.tools.joint_profile -c conf/tiktok_tuned.toml --synthetic tiktok \\
      --set train.graph_form=sparse --set train.segsum_compute=bf16

Prints one JSON line. It runs on the card; ``--device cpu`` runs the plain
versions on the CPU, where every time is the host clock's, ``joint_step``
runs the step eagerly (no graph exists there), and
``dispatch_overhead_ms`` is null.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from diffmm_tpu_torch.config import apply_overrides, load_config
from diffmm_tpu_torch.data.synthetic import SHAPES, host_data
from diffmm_tpu_torch.utils.device import HBM_BYTES_S, resolve_device, synchronize
from diffmm_tpu_torch.utils.logging import NullLog


def median_ms(fn, dev, inner: int, reps: int, warmup: int = 2) -> float:
    """The median over ``reps`` runs of ``inner`` back-to-back calls of
    ``fn`` of the milliseconds a call: CUDA events on the card, the host
    clock (each run ending in a drain) on the CPU."""
    for _ in range(warmup):
        fn()
    synchronize(dev)
    runs = []
    for _ in range(reps):
        if dev.type == "cuda":
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            stop.record()
            stop.synchronize()
            runs.append(start.elapsed_time(stop) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / inner)
    return float(np.median(runs))


def graphed(fn, dev):
    """``fn`` captured once in a CUDA graph (after two calls on a side
    stream, which set up the libraries' handles and workspaces outside the
    capture, as ``train/graphs.py`` does): returns the graph's replay. On
    the CPU, ``fn`` itself."""
    if dev.type != "cuda":
        return fn
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def launch_ms(fn, dev, inner: int, reps: int) -> float:
    """The median over ``reps`` runs of the host milliseconds it takes to
    launch ``inner`` calls of ``fn``, a call; the card drained between runs."""
    runs = []
    for _ in range(reps):
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        runs.append((time.perf_counter() - t0) * 1e3 / inner)
    synchronize(dev)
    return float(np.median(runs))


def _pass_grad(adj, compute: str):
    """The gradient of sum(y * y) over one pass's outputs, w.r.t. its
    inputs (a linear objective's gradient would not depend on them)."""
    from diffmm_tpu_torch.ops.graph import spmm_bi

    def run(xu, xi):
        xu, xi = xu.detach().requires_grad_(), xi.detach().requires_grad_()
        with torch.enable_grad():
            loss = sum((y * y).sum() for y in spmm_bi(adj, xu, xi, compute))
            return torch.autograd.grad(loss, (xu, xi))
    return run


def _sparse_pass_bytes(adj, d: int, compute: str) -> int:
    """The bytes of one sparse pass, both directions: each reads its source
    table's rows once (bf16 or f32 messages), its edge indices (int32) and
    offsets (int64), and writes its f32 output."""
    elt = 2 if compute == "bf16" else 4
    nnz, users, items = adj.ui_rows.shape[0], adj.user_num, adj.item_num
    out = 0
    for n_src, n_out in ((items, users), (users, items)):
        out += n_src * d * elt + nnz * 4 + (n_out + 1) * 8 + n_out * d * 4
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", "-c", default="conf/tiktok_tuned.toml")
    p.add_argument("--inner", type=int, default=32, help="calls a timed run")
    p.add_argument("--reps", type=int, default=7, help="timed runs (median taken)")
    p.add_argument("--data-root", default=None)
    p.add_argument("--set", action="append", default=[], dest="overrides", metavar="SECTION.KEY=VALUE",
                   help="config overrides, as the CLI's (e.g. --set train.graph_form=sparse)")
    p.add_argument("--device", default=None,
                   help="cuda (the default; needs a card) or cpu (plain PyTorch versions)")
    p.add_argument("--synthetic", default=None, choices=sorted(SHAPES),
                   help="synthesise the data at this dataset's shape")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from diffmm_tpu_torch.models.gcn import gcn_mm
    from diffmm_tpu_torch.ops.gather import gather, gather_plan
    from diffmm_tpu_torch.ops.graph import spmm_bi
    from diffmm_tpu_torch.ops.losses import bpr_loss, l2_reg_loss
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.train.optim import tree_leaves, tree_map

    config = load_config(args.config)
    apply_overrides(config, args.overrides)
    host = host_data(config, args.synthetic, data_root=args.data_root)
    coach = Coach(config, host, device=dev, log=NullLog())
    coach.train_epoch(0)  # builds the modality graphs; captures each phase's graph

    data, hp = coach.data, coach.hp()
    compute, cl_method = config.train.segsum_compute, config.base.cl_method
    adj, modal_adjs = data.adj, list(coach.modal_adjs)
    batch, d = config.train.batch, config.base.latdim
    rng = np.random.default_rng(0)

    def ints(n):
        return torch.as_tensor(rng.integers(0, n, batch, dtype=np.int32), device=dev)

    users, pos, neg = ints(host.user_num), ints(host.item_num), ints(host.item_num)
    xu = torch.as_tensor(rng.standard_normal((host.user_num, d), dtype=np.float32), device=dev)
    xi = torch.as_tensor(rng.standard_normal((host.item_num, d), dtype=np.float32), device=dev)
    K, R = args.inner, args.reps

    def timed(fn):
        return round(median_ms(graphed(fn, dev), dev, K, R), 3)

    def nocl():
        live = tree_map(lambda t: t.detach().requires_grad_(), coach.gcn_params)
        with torch.enable_grad():
            out = gcn_mm(live, adj, modal_adjs, data.raw_feats, hp["modal_adj_weight"],
                         hp["residual_weight"], compute)
            rec = bpr_loss(gather(out.u_final, users, gather_plan(users, host.user_num)),
                           gather(out.i_final, pos, gather_plan(pos, host.item_num)),
                           gather(out.i_final, neg, gather_plan(neg, host.item_num)))
            loss = rec + l2_reg_loss(hp["reg"], [live["u_embs"], live["i_embs"]])
            return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))

    if dev.type == "cuda":
        joint = coach.graphs.find("joint")[0].graph.replay
        dispatch_ms = round(launch_ms(joint, dev, K, R), 3)
        joint_ms = round(median_ms(joint, dev, K, R), 3)
    else:
        def joint():
            steps.joint_block(coach.gcn_params, coach.gcn_opt_state, adj, modal_adjs, data.raw_feats,
                              users, pos, neg, config.train.lr, hp, cl_method, compute,
                              generator=coach.generator)
        dispatch_ms = None
        joint_ms = timed(joint)

    with torch.no_grad():
        spmm_fwd = timed(lambda: spmm_bi(adj, xu, xi, compute))
        gcn_fwd = timed(coach.forward)
    res = {
        "config": args.config,
        "backend": dev.type,
        "graph_form": "dense" if coach.dense_graphs else "sparse",
        "dense_store": config.train.dense_store,
        "inner_iters": K,
        "dispatch_overhead_ms": dispatch_ms,
        "spmm_fwd_ms": spmm_fwd,
        "spmm_bwd_ms": timed(lambda: _pass_grad(adj, compute)(xu, xi)),
        "gcn_forward_ms": gcn_fwd,
        "joint_nocl_ms": timed(nocl),
        "joint_step_ms": joint_ms,
    }
    # derived: what the CL terms and Adam add to the plain BPR gradient step
    res["cl_plus_adam_ms"] = round(res["joint_step_ms"] - res["joint_nocl_ms"], 3)
    if coach.dense_graphs:
        mat = adj.mat
        res["adj_pass_roofline_ms"] = round(mat.numel() * mat.element_size() / HBM_BYTES_S * 1e3, 3)
    else:
        with torch.no_grad():
            res["spmm_modal_fwd_ms"] = timed(lambda: spmm_bi(modal_adjs[0], xu, xi, compute))
        res["spmm_modal_bwd_ms"] = timed(lambda: _pass_grad(modal_adjs[0], compute)(xu, xi))
        res["sparse_pass_roofline_ms"] = round(_sparse_pass_bytes(adj, d, compute) / HBM_BYTES_S * 1e3, 3)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
