#!/usr/bin/env python3
"""Smoke run of diffmm_tpu_torch on one NVIDIA card (the port's quickest
proof that it still starts on the GPU).

    python3 chip_smoke.py                 # one card

It runs every phase below, in order; any error fails the run (non-zero
exit, no result line):

1. build: every kernel source (``diffmm_tpu_torch/csrc/*.cu``) with one
   ``nvcc`` each, all at once; prints ptxas's register/shared-memory lines.
2. kernels: each kernel's wrapper on card tensors at the main paths' shapes
   (K1 ``spmm_dual`` at U 9,308 x I 6,710 x d 64, int8, bf16 and packed
   int4 storage (int4 also bitwise against the int8 launch),
   also bitwise across two launches, with its launch plan and scratch, and
   its backward through autograd (``SpmmDual``), and on the model axis's
   catalog shard, 9,308 x 3,355, int8 and int4, forward and backward;
   K2/K3 ``denoise_mlp`` at B 1,024, H 1,024 and I 6,710 and 20,000 (K2 as
   the rebuild runs it, its partial product ``kNone``, and with its tanh
   epilogue), and on the model axis's shards, K2's partial at K 3,355 and
   10,000, K3 at N 3,355 and 10,000, and at path S's shapes (hidden 64:
   K3 in the strip form, held bitwise against the gemm form and timed
   beside it), on weights prepared once (also
   bitwise across two launches and within twice the plain f32 product's
   error against float64); K4 ``segsum_gather`` (the gather-fused sorted
   segment sum) at the yelp shape: the user direction, n 38,403, nnz
   307,200, d 64; the item direction, n 20,000, ids with gaps; two
   modalities stacked in one launch; the item direction of a rebuilt graph,
   one hub of 38,389 edges; f32 and bf16 tables; the backward of the sparse
   form's three autograd Functions, user and item directions, stacked user
   and multi-item; the loss gathers' backward; the KNN prototypes at width
   4,096) against its plain PyTorch version within the stated tolerance
   (K1's and K4's also bitwise across two launches, K4's also bitwise the
   unfused route it replaces, ``index_select`` then K4 on the messages);
   times (CUDA events, warm, many launches) of the kernel, the plain
   version, one PyTorch library call computing the same function and, for
   K4, the unfused route, beside the bound. Adam's one pass
   (``ops/kernels/adam.py``, replacing no TPU kernel) on each benchmark
   configuration's denoiser trees (a diffusion step's, one launch a tree;
   electronics's gradients views of one flat buffer, as a mesh sums them)
   and GCN tree (a joint step's): three steps bitwise ``_adam_f32``, its
   time beside the bound (28 bytes a parameter), ``_adam_f32``'s and
   ``torch._fused_adam_``'s (a yardstick the port never calls).
3. reference: a tiny synthetic Coach on the card against the same Coach on
   the CPU (plain versions) with the same parameters, dense form and sparse
   form; the sparse one also against the dense one on the same graphs; and
   one diffusion_block and one joint_block on both from the same
   parameters, Adam states and injected draws.
4. path A (tiktok shape, dense form): synthetic 9,308 x 6,710 at density
   0.000953, feature widths 128/768/128, conf/test.toml hypers, seed 1818:
   rebuild -> test_epoch -> build_index -> 8 recommend requests (k=20).
5. path B: path A's steps on data/tiktok_mini at full model width (latdim
   64, hidden 1,024) with batch 256, so its real degree skew gives the
   two-bucket rebuild plan.
6. path C (yelp shape, sparse form): synthetic 38,403 x 20,000 at density
   0.0004, image and text features at widths 4,096 and 1,024,
   conf/yelp.toml hypers with ``train.graph_form="sparse"`` (the train
   store resolves to CSR): path A's steps; no (U, I) tensor.
7. path D: path B with ``train.graph_form="sparse"``: the CSR store's
   head/tail split and K4's hub segments.
8. path E (training, dense form): path A's data and Coach settings,
   ``train_epoch(0)`` and ``train_epoch(1)`` fenced, then ``test_epoch``:
   per-phase seconds, losses, peak memory, launches; K1 launched forward
   and backward in every joint step.
9. path F (training, sparse form): path C's data and settings, one epoch
   and ``test_epoch``, the same records; K4 forward and backward in every
   joint step; no (U, I) tensor.
10. path G: two epochs on data/tiktok_mini with the configuration of
    tests/test_regression_mini.py, Recall@20 in that test's band; four
    epochs on data/baby_mini with the configuration of
    tests/test_regression_baby_mini.py, Recall@20 in that test's band
    (0.006-0.018) at its seed, the seeds 1-5 recorded.
11. C1 (training repeats bit for bit): two joint_blocks from one saved state
    and one set of draws, dense at E's shape and sparse at F's, equal
    bitwise; a second fresh Coach at E gives path E's two epochs' losses
    bitwise.
12. graph replay: one block of each phase (joint, diffusion, rebuild) of E
    and F replayed from its captured CUDA graph against the same step run
    eagerly from one saved state, bitwise.
13. path H (fused, dense form): path E's data with ``train.epoch_scan=2``
    and ``tstEpoch=1`` through ``Coach.run`` (one chunk of two epochs with
    the eval on the card) against a twin Coach's ``run`` of single epochs:
    losses, evals, best epoch and snapshot, parameters and edge buffers
    bitwise; the chunk's wall time; one more epoch of the fused Coach run
    under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside
    a replayed epoch).
14. resume: save after epoch 0, restore into a new Coach, train epoch 1:
    bitwise the twin's uninterrupted epoch 1.
15. path R (the measuring programs, after H and before any profile):
    (a) the port's bench (``diffmm_tpu_torch.bench.main --synthetic
    tiktok``, in this process, 3 single epochs, fused chunks of 2): the
    JAX bench's keys, every time above 0, the sparse rows on the CSR store,
    the roofline fraction in (0, 1.05], each kernel launched (K1 in the
    dense rows, K2/K3 in both rebuilds, K4 in the sparse rows and the loss
    gathers); (b) a sparse Coach at tiktok's shape with bf16 messages, a
    fused chunk of two epochs bitwise a twin's two single epochs; (c) one
    sparse diffusion_block and joint_block with bf16 messages on the card
    against the CPU (bf16 tolerance); (d) each probe of
    ``diffmm_tpu_torch/tools/`` once in a subprocess at small counts
    (scale_probe at the yelp shape, store_ab_probe, fused_overhead_probe,
    joint_profile on both forms), its line parsed with the JAX tool's keys.
16. path I (after A): path A with ``train.dense_store="int4"`` (packed
    blocks, K1's int4 read): edge buffers, embeddings and metrics bitwise
    A's.
17. path J (after E): path E with ``train.dense_store="int4"``: its epoch-1
    loss bitwise E's (K1's int4 plan is its int8 plan), its memory beside
    E's and the blocks' expected saving, a third epoch, the in-place block
    rebuild timed beside E's.
18. path K (after G): path E's data with the KNN ablation (``hyper.
    use_knn_adj``, knn_topk 10), one epoch: no rebuild, ``rebuild_graphs``
    refuses, K1 and K4 launches a joint step as counted, the KNN graphs
    against their plain version (K4 prototypes, top-k outside ties).
19. path L: path E's data, one epoch each with bf16 denoisers (K2/K3 as in
    E) and with the bf16 rebuild of a [1024, 1024] denoiser (no K2/K3), on
    captured graphs, one more epoch of each with no host sync; path G's run
    at seed 1818 under each of G_KNOBS, Recall@20 recorded.
20. path M (after R): path E's index exported, loaded onto the card
    and served over HTTP (``eval/serve_http.py``) on 127.0.0.1: health,
    error paths, 200 requests each equal to a direct ``recommend``; their
    latencies beside the direct calls'; ``recommend(approx=True)`` equal
    to ``approx=False`` (ids, scores bitwise) and 20 requests to an
    ``approx`` server equal to direct calls; the port's serve_bench
    (``python -m diffmm_tpu_torch.tools.serve_bench``, a subprocess on the
    card) against that index and a random one at the yelp shape, 2,000
    requests from 4 clients each, p50/p95/p99 and throughput printed.
21. path Q (the sweep tool): path B's configuration (data/tiktok_mini,
    conf/test.toml at full width, batch 256, dense form); a reused-Coach
    sweep (``tools/sweep.py::_sweep_one``) of ``residual_weight``,
    ``sampling_step`` and ``train.lr``, two values and one epoch each,
    bitwise equal to one fresh Coach a value (rows, losses, state); a
    ``--forked`` sweep of ``hyper.steps`` 5,3 whose rows equal a
    ``--run-once`` child each; each run's seconds beside a first epoch's
    (its graph captures) and a second's.
22. profiles (torch.profiler, after every path's host-clock times): A's
    and C's rebuild + eval, one more joint phase of E at epoch 1's
    learning rate, replayed from its graph and run eagerly, and one more
    joint phase of F replayed; each with its idle share and the shares of
    PyTorch's ``index_select`` and of K4 in its device time.
23. path N (the mesh, in one spawned NCCL rank): E's and F's data and
    settings, two epochs, each with ``test_epoch``, on a 1x1 mesh, the steps
    captured with their all-reduces inside, bitwise the Coach without a
    mesh (losses, metrics, parameters, moments, edge buffers, generator),
    its kernel counters set to 0 just before and read just after; K4's
    mesh form (``parallel/segsum.py``) at F's shapes bitwise the whole
    ``segsum_gather``, timed per rank, with its all-reduce, bound and
    library; ``recommend(mesh)`` at model 1 bitwise the plain call; F's
    blocks of path O; the gradient all-reduce's time a step.
24. path O (two spawned gloo ranks on the one card, eager steps; a
    correctness path: its times are not speed figures): E's settings, one
    epoch and ``test_epoch``, twice (the ranks and the runs bitwise equal,
    the difference from N recorded); E's and F's settings, one
    diffusion_block and three joint_blocks from one state and one set of
    draws, twice: the ranks' states bitwise equal after every step, the
    runs bitwise equal, and within rel 2e-3 / abs 1e-5 of path N's same
    steps; K4's mesh form at F's user,
    item, item-hub (the hub cut by the rank boundary) and stacked shapes
    and a Propagate's backward within K4's rule of the whole call;
    ``recommend`` over E's index at model 2 (ids equal, scores within
    1e-5) and 20 requests to the two-shard HTTP server against direct
    calls; each rank's seconds, peak memory and Coach state.
25. path P (model-axis training: two spawned gloo ranks on the one card, a
    1x2 mesh, eager steps; a correctness path like O): E's settings, one
    diffusion_block and three joint_blocks from path N's state and draws
    (K1 on each rank's (U, I/2) block, K2's partial product summed over the
    ranks, K3 on each rank's columns), within rel 2e-3 / abs 1e-5 of N's,
    the ranks' whole states bitwise equal after every step; then one epoch
    and ``test_epoch``, its kernel counters set to 0 just before and read
    just after, the ranks bitwise equal; F's settings (sparse form), the
    same blocks against N's; E's rebuild at sampling_step 0 against one
    device's (scores within rtol 1e-4 / atol 1e-4, edge sets equal outside
    near-ties); a checkpoint written at 1x2 restored into a Coach without a
    mesh, whose ``test_epoch`` agrees with the mesh's; each rank's peak
    memory and Coach state beside path O's.

26. path S (after Q, before the profiles; the web-scale configuration): (a)
    one sparse Coach at the JAX ``tools/bigshard_demo.py``'s sparse settings,
    200,000 x 100,000 at density 5e-5 (about 1.0 M edges), two modalities
    with 32-wide features, latdim 64, one hidden layer of 64, 2 steps,
    batch 512: one fenced ``train_epoch(0)`` and ``test_epoch`` on the card,
    its counters set to 0 just before and read just after (K2/K3 in the
    rebuild, K4 in every propagation and loss gather), the no-O(U·I) walk
    (``utils/contracts.py``) over the Coach after both, the host's dense
    matrix never built, the peak below U·I = 2.0e10 bytes, the CSR store's
    bytes beside the dense matrix's, K3's launches in the strip form (hidden
    64), then one more rebuild under the profiler; (b) the port's
    ``bigshard_demo`` in a subprocess of 8 gloo ranks on the card, both JAX
    docstring commands
    (the dense form at 60,000 x 30,000 on a 4x2 mesh: its five rows at x2,
    K1 on each rank's (60,000, 15,000) block; the sparse form at (a)'s
    shape: K2/K3 and K4's mesh form), each rank's peak and launches.

Every path's K4 launches are the fused entry's: each path checks that the
unfused entry launched no time.

It then prints a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. A full report
(``chip_smoke.json``) and the profile table go to ``--report-dir``
(``smoke_report/`` by default, listed in ``.gitignore``).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# the named shapes the bench synthesises too (fails here outside a checkout)
from diffmm_tpu_torch.data.synthetic import SHAPES  # noqa: E402

# Published H100 SXM peaks (dense): HBM bytes/s, bf16, TF32 and f32 FLOP/s.
# TF32 is the card's fastest rate for f32 operands: the bound of an f32
# product.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12

# Tolerances of kernel vs plain version (elementwise, torch.allclose):
# K1 sums exact products (0/1 x bf16) in f32 in another order than the
# plain f32 matmul: rtol 1e-5, atol 1e-5. K2/K3 sum 6,710 or 20,000 (K2)
# or 1,024 (K3) 3xTF32 products (f32 accuracy) in another order than
# cuBLAS's f32 ones (no TF32 on the plain side): rtol 1e-5, atol 5e-5.
# K4 sums each segment in edge order, the plain index_add_ in the order
# its atomics land; a reordered f32 sum moves by a few eps (1.2e-7) of the
# sum of its terms' magnitudes, which a hub segment of thousands of edges
# makes large: |kernel - plain| <= rtol * sum|msgs| + atol per output
# element, rtol 1e-6, atol 1e-6.
TOL = {"spmm_dual": (1e-5, 1e-5), "denoise_layer1": (1e-5, 5e-5), "denoise_layer2": (1e-5, 5e-5),
       "segsum": (1e-6, 1e-6)}

# the entries of K2 that the rebuild launches (ops/kernels/denoise_mlp.py::
# denoise_forward_fused): on one device the kernel with its tanh epilogue,
# as the TPU kernel; on a mesh its partial product (the ``kNone``
# epilogue), summed over the model axis before the tanh
K2_ENTRY = "denoise_layer1"
K2_MESH_ENTRY = "denoise_layer1_partial"
KERNELS = {
    "spmm_dual": {
        "source": "diffmm_tpu_torch/csrc/spmm_dual.cu",
        "replaces": "diffmm_tpu/ops/pallas/spmm_dual.py:78",
    },
    "denoise_layer1": {
        "source": "diffmm_tpu_torch/csrc/denoise_mlp.cu",
        "replaces": "diffmm_tpu/ops/pallas/denoise_mlp.py:105",
    },
    "denoise_layer2": {
        "source": "diffmm_tpu_torch/csrc/denoise_mlp.cu",
        "replaces": "diffmm_tpu/ops/pallas/denoise_mlp.py:127",
    },
    "segsum": {
        "source": "diffmm_tpu_torch/csrc/segsum.cu",
        "replaces": "diffmm_tpu/ops/pallas/segsum.py:127",
    },
}
# what the kernels line keeps of each K4 case
K4_CASE_FIELDS = ("ok", "ms", "unfused_ms", "plain_ms", "library_ms", "library_refused", "bound_ms", "bound_by",
                  "l2_rate_gb_s", "bitwise_unfused", "bitwise_across_launches", "max_abs_err", "backward_ms",
                  "launches_per_call", "launches_per_backward")
# Path A's shape: tiktok's catalog at its density, its feature widths
# (conf/test.toml's dataset; the full data is not in the repository)
TIKTOK = SHAPES["tiktok"]
# Path C's shape: yelp's catalog and feature widths (conf/yelp.toml), its
# padded train edge count (307,180 edges + 20 sentinel pads), and the hub of
# its rebuilt item directions (38,389 of 38,403 users on one item)
YELP = {**SHAPES["yelp"], "edges": 307200, "hub": 38389}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return float((got - want).abs().max())


# --------------------------------------------------------------- phases
def phase_build() -> dict:
    from diffmm_tpu_torch.ops.kernels import build_all

    t0 = time.perf_counter()
    reports = build_all()
    secs = time.perf_counter() - t0
    for name, log in reports.items():
        for line in log.splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "error", "warning")):
                print(f"[ptxas {name}] {line.strip()}")
    print(f"[build] {len(reports)} kernel sources in {secs:.1f} s")
    return {"seconds": secs}


def phase_kernels(dev) -> dict:
    """Each kernel at the main path's shapes against its plain version."""
    import torch

    from diffmm_tpu_torch.ops.kernels import denoise_mlp as dm
    from diffmm_tpu_torch.ops.kernels import spmm_dual as sd
    from diffmm_tpu_torch.tools.joint_profile import graphed

    gen = torch.Generator(device=dev).manual_seed(1818)
    out = {}

    # K1 at tiktok shape: realistic density (the kernel's work is dense);
    # int8 (the paths' storage), bf16 and packed int4 (two cells a byte)
    U, I, d = TIKTOK["user_num"], TIKTOK["item_num"], 64
    mask = torch.rand((U, I), generator=gen, device=dev) < TIKTOK["density"]
    z_u = torch.randn((U, d), generator=gen, device=dev)
    z_i = torch.randn((I, d), generator=gen, device=dev)
    zu16, zi16 = z_u.to(torch.bfloat16), z_i.to(torch.bfloat16)
    rtol, atol = TOL["spmm_dual"]
    int8_y = int8_plan = None
    for store in (torch.int8, torch.bfloat16, torch.uint8):
        kind = sd.store_kind(store)
        # the dense adjacency's layout: rows on 16-byte boundaries
        mat = sd.dense_storage(U, I, store, dev)
        mat.copy_(sd.pack_int4(mask) if kind == "int4" else mask)
        yu, yi = sd.spmm_dual(mat, z_u, z_i)
        yu2, yi2 = sd.spmm_dual(mat, z_u, z_i)
        pu, pi = sd.spmm_dual_plain(mat, z_u, z_i)
        torch.cuda.synchronize()
        err = max(max_err(yu, pu), max_err(yi, pi))
        bitwise = torch.equal(yu, yu2) and torch.equal(yi, yi2)
        ok = (torch.allclose(yu, pu, rtol=rtol, atol=atol) and torch.allclose(yi, pi, rtol=rtol, atol=atol)
              and bitwise)
        check(ok, f"spmm_dual[{kind}] vs plain: max_abs_err {err}, bitwise across launches: {bitwise}")
        m16 = mask.to(torch.bfloat16)
        # M (its stored bytes) and the f32 z the kernel takes read once, the
        # f32 y written once
        n_bytes = mat.numel() * mat.element_size() + (U + I) * d * 4 + (U + I) * d * 4
        b, by = bound_ms(n_bytes, 2 * 2 * U * I * d, BF16_FLOPS)
        p = sd.plan(U, I, d, kind, dev)
        plan_rec = {"cluster": p.cluster, "col_blocks": p.col_blocks, "row_blocks": p.row_blocks,
                    "rows": p.rows, "groups": p.groups}
        rec = {
            "ok": ok,
            "store": kind,
            "max_abs_err": err,
            "bitwise_across_launches": bitwise,
            "plan": plan_rec,
            "scratch_bytes": p.partial_bytes(U, I, d),
            "m_bytes": mat.numel() * mat.element_size(),
            "ms": time_ms(lambda: sd.spmm_dual(mat, z_u, z_i), 50),
            "plain_ms": time_ms(lambda: sd.spmm_dual_plain(mat, z_u, z_i), 10),
            "bound_ms": b,
            "bound_by": by,
            "library_ms": time_ms(lambda: (m16 @ zi16, m16.T @ zu16), 50),
            # the device's time alone: replays of one captured call (eager,
            # the wrapper's host work can set the pace of back-to-back calls)
            "graph_ms": time_ms(graphed(lambda: sd.spmm_dual(mat, z_u, z_i), dev), 50),
            "library_graph_ms": time_ms(graphed(lambda: (m16 @ zi16, m16.T @ zu16), dev), 50),
        }
        del m16
        if kind == "int8":
            int8_y, int8_plan = (yu, yi), plan_rec
        if kind == "int4":
            # the same cells and, where the plans agree, the same tiles and
            # sums as the int8 launch: bitwise; else within TOL
            same_plan = plan_rec == int8_plan
            if same_plan:
                rec["bitwise_vs_int8"] = torch.equal(yu, int8_y[0]) and torch.equal(yi, int8_y[1])
                ok = ok and rec["bitwise_vs_int8"]
            else:
                print(f"[kernels] int4 plan {plan_rec} differs from int8's {int8_plan}: held within TOL")
                ok = ok and all(torch.allclose(a, b_, rtol=rtol, atol=atol) for a, b_ in zip((yu, yi), int8_y))
            rec["ok"] = ok
            rec["same_plan_as_int8"] = same_plan
            check(ok, f"spmm_dual[int4] vs the int8 launch: {rec}")
        key = {"int8": "spmm_dual", "bf16": "spmm_dual_bf16", "int4": "spmm_dual_int4"}[kind]
        out[key] = rec
        print(f"[kernels] {key}: {json.dumps(rec)}")
        if kind != "bf16":  # the paths' storage and int4: the backward too
            # int4's from a stream of its own: the later cases draw from gen
            # what they drew before the int4 case existed (the parent's data)
            bw_gen = gen if kind == "int8" else torch.Generator(device=dev).manual_seed(4)
            out[key + "_backward"] = _spmm_dual_backward(dev, bw_gen, mat, I)
    del int8_y
    out.update(_spmm_dual_shard_cases(dev, mask, z_u, z_i))

    out.update(_denoise_cases(dev, gen))
    out.update(_s_shape_cases(dev))
    out.update(_segsum_cases(dev, gen))
    out.update(_segsum_backward_cases(dev, gen))
    out.update(_gather_backward_cases(dev, gen))
    out["adam"] = _adam_cases(dev)
    return out


# the benchmark's configurations (benchmark/configs): users, items and the
# modalities' feature widths; every one at latdim 64, hidden 1,024 and a
# time embedding of 10, as conf/tiktok.toml and conf/sports.toml
ADAM_CELLS = {"tiktok": (9308, 6710, [128, 768, 128]), "sports": (35598, 18357, [4096, 1024]),
              "electronics": (48101, 63001, [4096, 1024])}


def _adam_case(dev, trees: list, grads: list, steps: int = 3) -> dict:
    """One Adam step over each of ``trees`` (leaf lists; ``grads`` theirs):
    ``steps`` steps from zero moments bitwise ``_adam_f32`` on copies, then
    the times of a step over all the trees (one launch a tree)."""
    import torch

    from diffmm_tpu_torch.ops.kernels.adam import LAUNCHES, fused_adam, least_bytes
    from diffmm_tpu_torch.train.optim import _adam_f32, adam_scalars

    mus = [[torch.zeros_like(p) for p in t] for t in trees]
    nus = [[torch.zeros_like(p) for p in t] for t in trees]
    twins = ([[p.clone() for p in t] for t in trees], [[m.clone() for m in t] for t in mus],
             [[v.clone() for v in t] for t in nus])
    rows = torch.as_tensor(adam_scalars(1e-3, 0, steps), device=dev)
    before = LAUNCHES["adam"]
    bitwise = True
    for k in range(steps):
        for t, g, mu, nu, tp, tm, tn in zip(trees, grads, mus, nus, *twins):
            fused_adam(t, g, mu, nu, rows[k])
            _adam_f32(tp, g, tm, tn, rows[k, 0], rows[k, 1], rows[k, 2])
        torch.cuda.synchronize()
        bitwise = bitwise and all(torch.equal(a, b) for xs, ys in zip((trees, mus, nus), twins)
                                  for x, y in zip(xs, ys) for a, b in zip(x, y))
    launches = (LAUNCHES["adam"] - before) // steps
    del twins
    n = sum(p.numel() for t in trees for p in t)
    row = rows[0]
    steps_t = [[torch.ones((), device=dev) for _ in t] for t in trees]
    b, by = bound_ms(least_bytes(n), 0, F32_FLOPS)
    rec = {
        "params": n, "trees": len(trees), "launches_per_step": launches, "bitwise": bitwise,
        "ms": time_ms(lambda: [fused_adam(t, g, mu, nu, row) for t, g, mu, nu in zip(trees, grads, mus, nus)],
                      20),
        "bound_ms": b, "bound_by": by,
        "plain_ms": time_ms(lambda: [_adam_f32(t, g, mu, nu, row[0], row[1], row[2])
                                     for t, g, mu, nu in zip(trees, grads, mus, nus)], 10),
        "library_ms": time_ms(lambda: [torch._fused_adam_(t, g, mu, nu, [], st, lr=1e-3, beta1=0.9, beta2=0.999,
                                                          weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)
                                       for t, g, mu, nu, st in zip(trees, grads, mus, nus, steps_t)], 20),
    }
    rec["ok"] = bitwise and launches == len(trees)
    return rec


def _adam_cases(dev) -> dict:
    """Adam's one pass at each configuration's trees: the denoisers (a
    diffusion step: one launch each) and the GCN (a joint step)."""
    import torch

    from diffmm_tpu_torch.models.denoise import init_denoise_params
    from diffmm_tpu_torch.models.gcn import init_gcn_params
    from diffmm_tpu_torch.train.optim import tree_leaves

    out = {}
    for name, (U, I, feats) in ADAM_CELLS.items():
        gen = torch.Generator(device=dev).manual_seed(23)
        dns = [tree_leaves(init_denoise_params(gen, I, [1024], 10, 64, dev)) for _ in feats]
        gcn = [tree_leaves(init_gcn_params(gen, U, I, 64, feats, dev))]
        if name == "electronics":
            # a mesh's summed gradients: views of one flat buffer, cut at the
            # leaves' boundaries (parallel/collectives.py::all_reduce_grads)
            flat = torch.randn(sum(p.numel() for t in dns for p in t), generator=gen, device=dev) * 1e-3
            parts = iter(flat.split([p.numel() for t in dns for p in t]))
            dn_grads = [[next(parts).view(p.shape) for p in t] for t in dns]
        else:
            dn_grads = [[torch.randn(p.shape, generator=gen, device=dev) * 1e-3 for p in t] for t in dns]
        gcn_grads = [[torch.randn(p.shape, generator=gen, device=dev) * 1e-2 for p in t] for t in gcn]
        out[name] = {"diffusion": _adam_case(dev, dns, dn_grads), "joint": _adam_case(dev, gcn, gcn_grads)}
        print(f"[kernels] adam {name}: {json.dumps(out[name])}")
        del dns, gcn, dn_grads, gcn_grads
        gc.collect()
        torch.cuda.empty_cache()
    check(all(r["ok"] for cell in out.values() for r in cell.values()), f"adam: {out}")
    return out


def _gather_backward_cases(dev, gen) -> dict:
    """K4 in the backward of the loss gathers (``ops/gather.py``) at path E's
    shapes: a joint block's 1,024 users gathered from u_final (9,308 x 64)
    and its 1,024 items from i_final (6,710 x 64), indices drawn from the
    train edges as the joint phase draws them. One fused launch a backward
    call (the cotangent's rows named by the plan's int32 permutation),
    against the plain version within TOL["segsum"] (scaled by the sum of
    each row's |terms|), bitwise across two calls; the launch alone through
    :func:`_k4_case` (bitwise the unfused route, ``g[perm]`` then K4, as the
    parent ran it), beside the library's scatter (``index_add_``, atomic
    adds) and the whole autograd call."""
    import torch

    from diffmm_tpu_torch.ops.gather import gather, gather_plan
    from diffmm_tpu_torch.ops.kernels import segsum as sg

    U, I, B, d = TIKTOK["user_num"], TIKTOK["item_num"], 1024, 64
    rows = sorted_segment_ids(gen, U, 59202, 0, 1.0, dev)  # path E's edges per user
    out = {}
    rtol, atol = TOL["segsum"]
    for name, n, src in (("users", U, rows), ("items", I, None)):
        pick = torch.randint(0, rows.shape[0], (B,), generator=gen, device=dev)
        idx = (src[pick] if src is not None
               else torch.randint(0, n, (B,), generator=gen, device=dev)).to(torch.int32)
        table = torch.randn((n, d), generator=gen, device=dev).requires_grad_()
        g = torch.randn((B, d), generator=gen, device=dev)
        plan = gather_plan(idx, n)
        y = gather(table, idx, plan)

        def backward():
            return torch.autograd.grad(y, table, g, retain_graph=True)[0]

        before = dict(sg.LAUNCHES)
        got, again = backward(), backward()
        per_call = {k: (v - before[k]) / 2 for k, v in sg.LAUNCHES.items()}
        want = sg.segsum_gather_plain(g, plan.perm, plan.offsets)
        scale = sg.segsum_gather_plain(g.abs(), plan.perm, plan.offsets)
        torch.cuda.synchronize()
        bitwise = torch.equal(got, again)
        rec = _k4_case(g, plan.perm, plan.offsets)
        ok = (bool(((got - want).abs() <= rtol * scale + atol).all()) and bitwise and rec["ok"]
              and per_call == {"segsum": 1, "segsum_unfused": 0})
        check(ok, f"gather backward[{name}] vs plain: max_abs_err {max_err(got, want)}, bitwise {bitwise}, "
                  f"launches {per_call}, launch {rec}")
        idx_l = idx.long()
        rec.update({"ok": ok, "max_abs_err": max_err(got, want), "bitwise_across_launches": bitwise,
                    "launches_per_backward": per_call["segsum"], "backward_ms": time_ms(backward, 50),
                    "index_add_ms": time_ms(lambda: torch.zeros((n, d), device=dev).index_add_(0, idx_l, g), 50)})
        out[f"segsum_gather_backward_{name}"] = rec
        print(f"[kernels] segsum_gather_backward_{name}: {json.dumps(rec)}")
    return out


def _spmm_dual_shard_cases(dev, mask, z_u, z_i) -> dict:
    """K1 on the model axis's catalog shard (path P's): the (U, I/2) block of
    the second half of tiktok's columns, 9,308 x 3,355 at d 64, built in
    place from the whole edges as the mesh Coach builds it
    (``build_dense_bi_adj_device(cols=...)``), int8 and packed int4 (odd
    width: the last high nibble zero). Forward against the plain version
    within TOL and bitwise across two launches; both halves' user sums
    against the whole block's within TOL; the backward through ``SpmmDual``
    (one launch) against the plain version. Library: two bf16 matmuls on a
    bf16 copy of the shard."""
    import torch

    from diffmm_tpu_torch.ops.graph import build_dense_bi_adj_device
    from diffmm_tpu_torch.ops.kernels import spmm_dual as sd
    from diffmm_tpu_torch.tools.joint_profile import graphed

    U, I = mask.shape
    d = z_u.shape[1]
    edges = mask.nonzero()
    rows, cols = edges[:, 0].to(torch.int32), edges[:, 1].to(torch.int32)
    rtol, atol = TOL["spmm_dual"]
    bw_gen = torch.Generator(device=dev).manual_seed(12)
    g_u = torch.randn((U, d), generator=bw_gen, device=dev)
    out = {}
    for store in (torch.int8, torch.uint8):
        kind = sd.store_kind(store)
        halves = [build_dense_bi_adj_device(rows, cols, U, I, store, cols=c).mat
                  for c in ((0, I // 2), (I // 2, I))]
        whole_u = sd.spmm_dual(build_dense_bi_adj_device(rows, cols, U, I, store).mat, z_u, z_i)[0]
        lo, hi = I // 2, I
        mat, zi = halves[1], z_i[lo:hi]
        before = sd.LAUNCHES["spmm_dual"]
        yu, yi = sd.spmm_dual(mat, z_u, zi)
        launches = sd.LAUNCHES["spmm_dual"] - before
        yu2, yi2 = sd.spmm_dual(mat, z_u, zi)
        pu, pi = sd.spmm_dual_plain(mat, z_u, zi)
        summed = sd.spmm_dual(halves[0], z_u, z_i[:lo])[0] + yu
        g_i = torch.randn((hi - lo, d), generator=bw_gen, device=dev)
        zu_g, zi_g = z_u.clone().requires_grad_(), zi.clone().requires_grad_()
        outs = sd.SpmmDual.apply(mat, zu_g, zi_g)
        before = sd.LAUNCHES["spmm_dual"]
        grads = torch.autograd.grad(outs, (zu_g, zi_g), (g_u, g_i))
        bw_launches = sd.LAUNCHES["spmm_dual"] - before
        bw_want = sd.spmm_dual_plain(mat, g_u, g_i)
        torch.cuda.synchronize()
        err = max(max_err(yu, pu), max_err(yi, pi))
        bw_err = max(max_err(a, b) for a, b in zip(grads, bw_want))
        bitwise = torch.equal(yu, yu2) and torch.equal(yi, yi2)
        ok = (torch.allclose(yu, pu, rtol=rtol, atol=atol) and torch.allclose(yi, pi, rtol=rtol, atol=atol)
              and bitwise and launches == 1 and bw_launches == 1
              and torch.allclose(summed, whole_u, rtol=rtol, atol=atol)
              and all(torch.allclose(a, b, rtol=rtol, atol=atol) for a, b in zip(grads, bw_want)))
        check(ok, f"spmm_dual_shard[{kind}]: max_abs_err {err}, backward {bw_err}, bitwise {bitwise}, "
                  f"launches {launches}/{bw_launches}, halves' sum err {max_err(summed, whole_u)}")
        m16 = (sd.unpack_int4(mat, hi - lo) if kind == "int4" else mat).to(torch.bfloat16)
        zu16, zi16 = z_u.to(torch.bfloat16), zi.to(torch.bfloat16)
        n_bytes = mat.numel() * mat.element_size() + 2 * (U + hi - lo) * d * 4
        b, by = bound_ms(n_bytes, 2 * 2 * U * (hi - lo) * d, BF16_FLOPS)
        p = sd.plan(U, hi - lo, d, kind, dev)
        rec = {
            "ok": ok, "store": kind, "shape": [U, hi - lo, d], "columns": [lo, hi], "max_abs_err": err,
            "backward_max_abs_err": bw_err, "bitwise_across_launches": bitwise,
            "halves_sum_max_abs_err": max_err(summed, whole_u), "launches_per_call": launches,
            "launches_per_backward": bw_launches,
            "plan": {"cluster": p.cluster, "col_blocks": p.col_blocks, "row_blocks": p.row_blocks,
                     "rows": p.rows, "groups": p.groups},
            "m_bytes": mat.numel() * mat.element_size(),
            "ms": time_ms(lambda: sd.spmm_dual(mat, z_u, zi), 50),
            "plain_ms": time_ms(lambda: sd.spmm_dual_plain(mat, z_u, zi), 10),
            "backward_ms": time_ms(lambda: sd.spmm_dual(mat, g_u, g_i), 50),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(lambda: (m16 @ zi16, m16.T @ zu16), 50),
            "graph_ms": time_ms(graphed(lambda: sd.spmm_dual(mat, z_u, zi), dev), 50),
            "library_graph_ms": time_ms(graphed(lambda: (m16 @ zi16, m16.T @ zu16), dev), 50),
        }
        del m16, halves
        out[f"spmm_dual_shard_{kind}"] = rec
        print(f"[kernels] spmm_dual_shard_{kind}: {json.dumps(rec)}")
    return out


def _spmm_dual_backward(dev, gen, mat, I: int) -> dict:
    """K1's backward through autograd (``SpmmDual``) at the path's shape:
    the cotangents' gradients against the plain version's (the same call
    with the cotangents in place of z), within TOL, bitwise across two
    backward calls, one launch a call; timed as a whole autograd call and as
    its launch alone."""
    import torch

    from diffmm_tpu_torch.ops.kernels import spmm_dual as sd
    from diffmm_tpu_torch.tools.joint_profile import graphed

    U, d = mat.shape[0], 64
    z_u = torch.randn((U, d), generator=gen, device=dev).requires_grad_()
    z_i = torch.randn((I, d), generator=gen, device=dev).requires_grad_()
    g_u = torch.randn((U, d), generator=gen, device=dev)
    g_i = torch.randn((I, d), generator=gen, device=dev)
    outs = sd.SpmmDual.apply(mat, z_u, z_i)

    def backward():
        return torch.autograd.grad(outs, (z_u, z_i), (g_u, g_i), retain_graph=True)

    before = sd.LAUNCHES["spmm_dual"]
    got, again = backward(), backward()
    launches = (sd.LAUNCHES["spmm_dual"] - before) / 2
    want = sd.spmm_dual_plain(mat, g_u, g_i)  # (M @ g_i, Mᵀ @ g_u)
    torch.cuda.synchronize()
    rtol, atol = TOL["spmm_dual"]
    err = max(max_err(a, b) for a, b in zip(got, want))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = (all(torch.allclose(a, b, rtol=rtol, atol=atol) for a, b in zip(got, want)) and bitwise
          and launches == 1)
    kind = sd.store_kind(mat.dtype)
    check(ok, f"spmm_dual backward[{kind}] vs plain: max_abs_err {err}, bitwise {bitwise}, "
              f"launches {launches}")
    g16 = g_u.to(torch.bfloat16), g_i.to(torch.bfloat16)
    m16 = (sd.unpack_int4(mat, I) if kind == "int4" else mat).to(torch.bfloat16)
    n_bytes = mat.numel() * mat.element_size() + 2 * (U + I) * d * 4
    b, by = bound_ms(n_bytes, 2 * 2 * U * I * d, BF16_FLOPS)
    # ms: the backward's launch alone (the kernel on the cotangents);
    # backward_ms: the whole autograd call, host included
    rec = {"ok": ok, "store": kind, "shape": [U, I, d], "max_abs_err": err,
           "bitwise_across_launches": bitwise,
           "launches_per_backward": launches, "backward_ms": time_ms(backward, 50),
           "ms": time_ms(lambda: sd.spmm_dual(mat, g_u, g_i), 50),
           "plain_ms": time_ms(lambda: sd.spmm_dual_plain(mat, g_u, g_i), 10), "bound_ms": b,
           "bound_by": by, "library_ms": time_ms(lambda: (m16 @ g16[1], m16.T @ g16[0]), 50),
           "graph_ms": time_ms(graphed(lambda: sd.spmm_dual(mat, g_u, g_i), dev), 50),
           "library_graph_ms": time_ms(graphed(lambda: (m16 @ g16[1], m16.T @ g16[0]), dev), 50)}
    print(f"[kernels] spmm_dual_backward[{kind}]: {json.dumps(rec)}")
    return rec


def _gemm_case(name: str, shape, kern, plain, exact, lib_call, n_bytes: int, prep_ms: float) -> dict:
    """One K2/K3 case: ``kern(form)`` launches the kernel in ``form`` (None:
    the form its shape takes, ``denoise_form``). The kernel against its
    plain version within TOL, bitwise across two launches, within twice the
    plain f32 product's max error against float64; where its shape takes
    the strip form, also bitwise the gemm form on the same inputs, whose
    time stands beside its own. Its times beside three bounds: the
    function's (``bound_ms``: its 2·B·K·N products at the TF32 rate, the
    card's fastest for f32 operands, or its bytes at the HBM rate, the
    larger), the design's (3xTF32, three TF32 products per f32 one) and the
    f32 FMA rate's; the kernel's and the library's also as replays of a
    captured call (``graph_ms``)."""
    import torch

    from diffmm_tpu_torch.ops.kernels.denoise_mlp import denoise_form
    from diffmm_tpu_torch.tools.joint_profile import graphed

    B, K, N = shape
    form = denoise_form(K)
    got, again, want = kern(None), kern(None), plain()
    ref = exact()
    torch.cuda.synchronize()
    rtol, atol = TOL["denoise_layer2" if name.startswith("denoise_layer2") else "denoise_layer1"]
    err = max_err(got, want)
    err_f64, plain_f64 = max_err(got.double(), ref), max_err(want.double(), ref)
    del ref
    bitwise = torch.equal(got, again)
    # the strip form does the gemm form's arithmetic step for step
    same_as_gemm = form == "gemm" or torch.equal(got, kern("gemm"))
    ok = (torch.allclose(got, want, rtol=rtol, atol=atol) and bitwise and err_f64 <= 2 * plain_f64
          and same_as_gemm)
    check(ok, f"{name} ({form} form): max_abs_err {err} vs plain, {err_f64} vs f64 (plain "
              f"{plain_f64}), bitwise across launches: {bitwise}, bitwise the gemm form: {same_as_gemm}")
    flops = 2 * B * K * N
    b, by = bound_ms(n_bytes, flops, TF32_FLOPS)
    rec = {
        "ok": ok,
        "form": form,
        "shape": [B, K, N],
        "max_abs_err": err,
        "max_err_vs_f64": err_f64,
        "plain_max_err_vs_f64": plain_f64,
        "bitwise_across_launches": bitwise,
        "bitwise_vs_gemm_form": same_as_gemm,
        "ms": time_ms(lambda: kern(None), 20),
        "plain_ms": time_ms(plain, 20),
        "bound_ms": b,
        "bound_by": by,
        "bound_design_ms": bound_ms(n_bytes, 3 * flops, TF32_FLOPS)[0],
        "bound_design": "3xTF32: 3 TF32 products per f32 one at 495 TFLOP/s",
        "bound_f32_fma_ms": bound_ms(n_bytes, flops, F32_FLOPS)[0],
        "library_ms": time_ms(lib_call, 20),
        "prepare_ms": prep_ms,
    }
    # the device's time beside the eager one (replays of one captured call):
    # at a short kernel the wrapper's host work can set the eager time
    dev = got.device
    rec["graph_ms"] = time_ms(graphed(lambda: kern(None), dev), 20)
    rec["library_graph_ms"] = time_ms(graphed(lib_call, dev), 20)
    rec["ms_over_library_ms"] = rec["ms"] / rec["library_ms"]
    if form == "strip":
        rec["gemm_form_ms"] = time_ms(lambda: kern("gemm"), 20)
    print(f"[kernels] {name}: {json.dumps(rec)}")
    return rec


def _denoise_cases(dev, gen) -> dict:
    """K2/K3 at the rebuild's shapes, tiktok's catalog (path A) and yelp's
    (path C), on weights prepared once as the rebuild prepares them (the
    preparation timed beside them), each as :func:`_gemm_case` holds it: K2
    with its tanh epilogue (``denoise_layer1``, one device) and as its raw
    partial product (``denoise_layer1_partial``, a mesh), and K3. Then the model
    axis's shapes (path P and F's catalog cut in two), on data of their own
    stream: K2's partial at K 3,355 and 10,000 (a rank's catalog rows of
    W1x) and K3 at N 3,355 and 10,000 (a rank's columns of W2)."""
    import torch

    from diffmm_tpu_torch.ops.kernels import denoise_mlp as dm

    out = {}
    B, H = 1024, 1024
    for K, suffix in ((TIKTOK["item_num"], ""), (YELP["item_num"], "_yelp")):
        x = torch.randn((B, K), generator=gen, device=dev)
        w1x = torch.randn((K, H), generator=gen, device=dev) * math.sqrt(2.0 / (K + 10 + H))
        tp = torch.randn((B, H), generator=gen, device=dev) * 0.1
        w2 = torch.randn((H, K), generator=gen, device=dev) * math.sqrt(2.0 / (H + K))
        b2 = torch.randn((K,), generator=gen, device=dev) * 0.001
        w1p, w2p = dm.prepare_weight(w1x), dm.prepare_weight(w2)
        prep_ms = {"w1x": time_ms(lambda: dm.prepare_weight(w1x), 5),
                   "w2": time_ms(lambda: dm.prepare_weight(w2), 5)}
        print(f"[kernels] prepare_weight{suffix}, once per rebuild and modality, ms: {json.dumps(prep_ms)}")
        h = dm.layer1_plain(x, w1x, tp)
        # both kernels on weights in the JAX layout, prepared per call
        full = dm.denoise_layer2(dm.denoise_layer1(x, w1x, tp), w2, b2)
        want_full = dm.layer2_plain(h, w2, b2)
        out[K2_ENTRY + suffix] = _gemm_case(
            K2_ENTRY + suffix, (B, K, H), lambda form: dm.denoise_layer1(x, w1p, tp, form),
            lambda: dm.layer1_plain(x, w1x, tp), lambda: torch.tanh(x.double() @ w1x.double() + tp.double()),
            lambda: torch.tanh(torch.addmm(tp, x, w1x)), (B * K + K * H + 2 * B * H) * 4, prep_ms["w1x"])
        out[K2_MESH_ENTRY + suffix] = _gemm_case(
            K2_MESH_ENTRY + suffix, (B, K, H), lambda form: dm.denoise_layer1_partial(x, w1p, form),
            lambda: dm.layer1_partial_plain(x, w1x), lambda: x.double() @ w1x.double(),
            lambda: torch.matmul(x, w1x), (B * K + K * H + B * H) * 4, prep_ms["w1x"])
        out["denoise_layer2" + suffix] = _gemm_case(
            "denoise_layer2" + suffix, (B, H, K), lambda form: dm.denoise_layer2(h, w2p, b2, form),
            lambda: dm.layer2_plain(h, w2, b2), lambda: h.double() @ w2.double() + b2.double(),
            lambda: torch.addmm(b2, h, w2), (B * H + H * K + K + B * K) * 4, prep_ms["w2"])
        err = max_err(full, want_full)
        check(torch.allclose(full, want_full, rtol=1e-5, atol=1e-4), f"K2 then K3{suffix}: {err}")
        print(f"[kernels] K2 then K3{suffix} (weights prepared per call) vs plain: max_abs_err {err}")
        del x, w1x, tp, w2, b2, w1p, w2p, h, full, want_full
    shard_gen = torch.Generator(device=dev).manual_seed(10)
    for K, suffix in ((TIKTOK["item_num"] // 2, "_shard"), (YELP["item_num"] // 2, "_yelp_shard")):
        # a rank's own contiguous columns of x (as the rebuild holds them)
        x = torch.randn((B, K), generator=shard_gen, device=dev)
        w1x = torch.randn((K, H), generator=shard_gen, device=dev) * math.sqrt(2.0 / (2 * K + 10 + H))
        h = torch.tanh(torch.randn((B, H), generator=shard_gen, device=dev))
        w2 = torch.randn((H, K), generator=shard_gen, device=dev) * math.sqrt(2.0 / (H + 2 * K))
        b2 = torch.randn((K,), generator=shard_gen, device=dev) * 0.001
        w1p, w2p = dm.prepare_weight(w1x), dm.prepare_weight(w2)
        prep_ms = {"w1x": time_ms(lambda: dm.prepare_weight(w1x), 5),
                   "w2": time_ms(lambda: dm.prepare_weight(w2), 5)}
        out[K2_MESH_ENTRY + suffix] = _gemm_case(
            K2_MESH_ENTRY + suffix, (B, K, H), lambda form: dm.denoise_layer1_partial(x, w1p, form),
            lambda: dm.layer1_partial_plain(x, w1x), lambda: x.double() @ w1x.double(),
            lambda: torch.matmul(x, w1x), (B * K + K * H + B * H) * 4, prep_ms["w1x"])
        out["denoise_layer2" + suffix] = _gemm_case(
            "denoise_layer2" + suffix, (B, H, K), lambda form: dm.denoise_layer2(h, w2p, b2, form),
            lambda: dm.layer2_plain(h, w2, b2), lambda: h.double() @ w2.double() + b2.double(),
            lambda: torch.addmm(b2, h, w2), (B * H + H * K + K + B * K) * 4, prep_ms["w2"])
        del x, w1x, h, w2, b2, w1p, w2p
    return out


def _s_shape_cases(dev) -> dict:
    """K1-K3 at path S's shapes, on data of their own stream. K1 (int8) on
    the dense demo's rank block: the columns [15,000, 30,000) of the
    60,000 x 30,000 catalog at density 0.0015, built in place from the
    whole unique edges as the demo builds it, d 64 (the demo's GCN forward:
    no backward). K2 with its tanh epilogue at S (a)'s rebuild, (512,
    100,000, 64), and as its partial product there and on the sparse demo's
    rank block, (128, 50,000, 64): 128 of the block's 512 rows over the
    data axis of 4, 50,000 of the 100,000 columns over the model axis of 2.
    K3 at (512, 64, 100,000) and (128, 64, 50,000). K1 against its plain
    version within TOL, bitwise across two launches, one launch a call; K2
    and K3 as :func:`_gemm_case` holds them."""
    import torch

    from diffmm_tpu_torch.ops.graph import build_dense_bi_adj_device
    from diffmm_tpu_torch.ops.kernels import denoise_mlp as dm
    from diffmm_tpu_torch.ops.kernels import spmm_dual as sd
    from diffmm_tpu_torch.tools.joint_profile import graphed

    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    U, I, d = 60_000, 30_000, 64
    flat = torch.unique(torch.randint(0, U * I, (int(U * I * 0.0015),), generator=gen, device=dev))
    rows, cols = (flat // I).to(torch.int32), (flat % I).to(torch.int32)
    lo, hi = I // 2, I
    mat = build_dense_bi_adj_device(rows, cols, U, I, torch.int8, cols=(lo, hi)).mat
    del flat, rows, cols
    z_u = torch.randn((U, d), generator=gen, device=dev)
    z_i = torch.randn((hi - lo, d), generator=gen, device=dev)
    before = sd.LAUNCHES["spmm_dual"]
    yu, yi = sd.spmm_dual(mat, z_u, z_i)
    launches = sd.LAUNCHES["spmm_dual"] - before
    yu2, yi2 = sd.spmm_dual(mat, z_u, z_i)
    pu, pi = sd.spmm_dual_plain(mat, z_u, z_i)
    torch.cuda.synchronize()
    rtol, atol = TOL["spmm_dual"]
    err = max(max_err(yu, pu), max_err(yi, pi))
    bitwise = torch.equal(yu, yu2) and torch.equal(yi, yi2)
    ok = (torch.allclose(yu, pu, rtol=rtol, atol=atol) and torch.allclose(yi, pi, rtol=rtol, atol=atol)
          and bitwise and launches == 1)
    check(ok, f"spmm_dual_s_shard: max_abs_err {err}, bitwise {bitwise}, launches {launches}")
    del yu, yi, yu2, yi2, pu, pi
    m16 = mat.to(torch.bfloat16)
    zu16, zi16 = z_u.to(torch.bfloat16), z_i.to(torch.bfloat16)
    n_bytes = mat.numel() * mat.element_size() + 2 * (U + hi - lo) * d * 4
    b, by = bound_ms(n_bytes, 2 * 2 * U * (hi - lo) * d, BF16_FLOPS)
    p = sd.plan(U, hi - lo, d, "int8", dev)
    rec = {
        "ok": ok, "store": "int8", "shape": [U, hi - lo, d], "columns": [lo, hi], "edges_in_block": int(
            (mat != 0).sum()), "max_abs_err": err, "bitwise_across_launches": bitwise,
        "launches_per_call": launches,
        "plan": {"cluster": p.cluster, "col_blocks": p.col_blocks, "row_blocks": p.row_blocks,
                 "rows": p.rows, "groups": p.groups},
        "scratch_bytes": p.partial_bytes(U, hi - lo, d), "m_bytes": mat.numel() * mat.element_size(),
        "ms": time_ms(lambda: sd.spmm_dual(mat, z_u, z_i), 20),
        "plain_ms": time_ms(lambda: sd.spmm_dual_plain(mat, z_u, z_i), 5),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: (m16 @ zi16, m16.T @ zu16), 20),
        "graph_ms": time_ms(graphed(lambda: sd.spmm_dual(mat, z_u, z_i), dev), 20),
        "library_graph_ms": time_ms(graphed(lambda: (m16 @ zi16, m16.T @ zu16), dev), 20),
    }
    del m16, mat, z_u, z_i
    out["spmm_dual_s_shard"] = rec
    print(f"[kernels] spmm_dual_s_shard: {json.dumps(rec)}")

    H = 64
    for B, K, whole_k, suffix in ((512, 100_000, 100_000, "_s"), (128, 50_000, 100_000, "_s_shard")):
        x = torch.randn((B, K), generator=gen, device=dev)
        w1x = torch.randn((K, H), generator=gen, device=dev) * math.sqrt(2.0 / (whole_k + 10 + H))
        tp = torch.randn((B, H), generator=gen, device=dev) * 0.1
        h = torch.tanh(torch.randn((B, H), generator=gen, device=dev))
        w2 = torch.randn((H, K), generator=gen, device=dev) * math.sqrt(2.0 / (H + whole_k))
        b2 = torch.randn((K,), generator=gen, device=dev) * 0.001
        w1p, w2p = dm.prepare_weight(w1x), dm.prepare_weight(w2)
        prep_ms = {"w1x": time_ms(lambda: dm.prepare_weight(w1x), 5),
                   "w2": time_ms(lambda: dm.prepare_weight(w2), 5)}
        if suffix == "_s":  # one device: the tanh epilogue
            out[K2_ENTRY + suffix] = _gemm_case(
                K2_ENTRY + suffix, (B, K, H), lambda form: dm.denoise_layer1(x, w1p, tp, form),
                lambda: dm.layer1_plain(x, w1x, tp), lambda: torch.tanh(x.double() @ w1x.double() + tp.double()),
                lambda: torch.tanh(torch.addmm(tp, x, w1x)), (B * K + K * H + 2 * B * H) * 4, prep_ms["w1x"])
        out[K2_MESH_ENTRY + suffix] = _gemm_case(
            K2_MESH_ENTRY + suffix, (B, K, H), lambda form: dm.denoise_layer1_partial(x, w1p, form),
            lambda: dm.layer1_partial_plain(x, w1x), lambda: x.double() @ w1x.double(),
            lambda: torch.matmul(x, w1x), (B * K + K * H + B * H) * 4, prep_ms["w1x"])
        out["denoise_layer2" + suffix] = _gemm_case(
            "denoise_layer2" + suffix, (B, H, K), lambda form: dm.denoise_layer2(h, w2p, b2, form),
            lambda: dm.layer2_plain(h, w2, b2), lambda: h.double() @ w2.double() + b2.double(),
            lambda: torch.addmm(b2, h, w2), (B * H + H * K + K + B * K) * 4, prep_ms["w2"])
        del x, w1x, tp, h, w2, b2, w1p, w2p
    return out


def sorted_segment_ids(gen, n: int, nnz: int, pads: int, skew: float, device):
    """(nnz,) int32 ascending segment ids, the last ``pads`` of them
    sentinels equal to n. With ``skew`` > 1 the ids come from 90% of
    [0, n), piled on the low ones (a hub segment first), so the rest of the
    segments are empty: a rebuilt graph's item layout."""
    import torch

    present = torch.arange(n, device=device)
    if skew > 1:
        present = torch.sort(torch.randperm(n, generator=gen, device=device)[: n * 9 // 10]).values
    u = torch.rand(nnz - pads, generator=gen, device=device) ** skew
    ids = present[(u * len(present)).long().clamp_max(len(present) - 1)]
    ids = torch.sort(ids.to(torch.int32)).values
    return torch.cat([ids, torch.full((pads,), n, dtype=torch.int32, device=device)])


def hub_segment_ids(gen, n: int, nnz: int, pads: int, hub: int, device):
    """(nnz,) int32 ascending segment ids with path C's rebuilt item layout:
    one id (drawn from ``gen``) holds ``hub`` edges, the other real edges are
    spread uniformly over the other n - 1 ids, and the last ``pads`` are
    sentinels equal to n."""
    import torch

    hub_id = int(torch.randint(0, n, (1,), generator=gen, device=device))
    others = torch.randint(0, n - 1, (nnz - pads - hub,), generator=gen, device=device)
    others = others + (others >= hub_id).long()
    ids = torch.cat([others, torch.full((hub,), hub_id, device=device)])
    ids = torch.sort(ids.to(torch.int32)).values
    return torch.cat([ids, torch.full((pads,), n, dtype=torch.int32, device=device)])


def _unfused(tables, srcs, offsets, zero_row: bool):
    """The route the fused K4 replaces, as the parent ran it: each
    modality's rows gathered per edge with ``index_select`` (a forward's
    pads clamped to the last row, or a backward's cotangent with a zero row
    appended for the forward's pads), side by side, then K4 on the (nnz,
    M·d) messages (``segsum``, its unfused entry)."""
    import torch

    from diffmm_tpu_torch.ops.kernels import segsum as sg

    R, d = tables.shape[1:]
    msgs = [torch.cat([t, t.new_zeros((1, d))]).index_select(0, s.clamp_max(R)) if zero_row
            else t.index_select(0, s.clamp_max(R - 1)) for t, s in zip(tables, srcs)]
    return sg.segsum(msgs[0] if len(msgs) == 1 else torch.cat(msgs, dim=1), offsets)


def _library_ms(tables, srcs, offsets, iters: int):
    """The library's call for the same function: ``torch.sparse.mm`` of a
    CSR matrix (the offsets, the real edges' indices, ones; zero for an
    index past the table) by each table, the matrices built once outside
    the timing. Returns (ms, None), or (None, the refusal) where the library
    does not take the table's type."""
    import torch

    R = tables.shape[1]
    n, real = offsets.numel() - 1, int(offsets[-1])
    mats = []
    for s in srcs:
        s = s[:real].long()
        valid = (s >= 0) & (s < R)
        mats.append(torch.sparse_csr_tensor(offsets, s.clamp(0, R - 1), valid.to(tables.dtype), size=(n, R)))

    def call():
        return [torch.sparse.mm(a, t) for a, t in zip(mats, tables)]

    try:
        call()
    except RuntimeError as exc:  # a library refusal (its type support), never one of the port's kernels
        return None, str(exc).splitlines()[0][:160]
    return time_ms(call, iters), None


def _k4_case(table, src, offsets, zero_row: bool = False, iters: int = 50) -> dict:
    """K4's fused entry on one case: against its plain version within
    TOL["segsum"] (scaled by the sum of each output's |terms|), bitwise
    across two calls and bitwise the unfused route (:func:`_unfused`), one
    launch a call; the fused launch timed beside the unfused route, the
    plain version and the library (:func:`_library_ms`); the bound counts
    the table's rows that the real edges name, their indices, the offsets
    and the output, each once, and one add per gathered element; the L2
    rate is the gathered rows' bytes over the fused time."""
    import torch

    from diffmm_tpu_torch.ops.kernels import segsum as sg

    tables = table[None] if table.dim() == 2 else table
    srcs = [src] if isinstance(src, torch.Tensor) else list(src)
    M, R, d = tables.shape
    n, real = offsets.numel() - 1, int(offsets[-1])
    before = dict(sg.LAUNCHES)
    got = sg.segsum_gather(table, src, offsets)
    again = sg.segsum_gather(table, src, offsets)
    per_call = {k: (v - before[k]) / 2 for k, v in sg.LAUNCHES.items()}
    unfused = _unfused(tables, srcs, offsets, zero_row)
    want = sg.segsum_gather_plain(table, src, offsets)
    scale = sg.segsum_gather_plain(table.abs(), src, offsets)
    torch.cuda.synchronize()
    rtol, atol = TOL["segsum"]
    close = bool(((got - want).abs() <= rtol * scale + atol).all())
    bitwise, bitwise_unfused = torch.equal(got, again), torch.equal(got, unfused)
    ok = close and bitwise and bitwise_unfused and per_call == {"segsum": 1, "segsum_unfused": 0}
    elem = tables.element_size()
    named = sum(int(torch.unique(s[:real][(s[:real] >= 0) & (s[:real] < R)]).numel()) for s in srcs)
    n_bytes = named * d * elem + 4 * real * M + 8 * (n + 1) + 4 * n * M * d
    b, by = bound_ms(n_bytes, real * M * d, F32_FLOPS)
    del unfused, want, scale, again
    ms = time_ms(lambda: sg.segsum_gather(table, src, offsets), iters)
    library_ms, library_refused = _library_ms(tables, srcs, offsets, max(iters // 5, 3))
    gathered = real * M * d * elem
    rec = {
        "ok": ok, "shape": [n, R, real, M, d], "table": str(tables.dtype).removeprefix("torch."),
        "merge_group": sg.merge_group(n, srcs[0].numel()),
        "empty_segments": int((offsets.diff() == 0).sum()), "max_segment": int(offsets.diff().max()),
        "max_abs_err": max_err(got, sg.segsum_gather_plain(table, src, offsets)),
        "bitwise_across_launches": bitwise, "bitwise_unfused": bitwise_unfused, "close": close,
        "launches_per_call": per_call,
        "ms": ms,
        "unfused_ms": time_ms(lambda: _unfused(tables, srcs, offsets, zero_row), max(iters // 2, 3)),
        "plain_ms": time_ms(lambda: sg.segsum_gather_plain(table, src, offsets), max(iters // 5, 3)),
        "library_ms": library_ms, "library_refused": library_refused,
        "bound_ms": b, "bound_by": by, "bound_bytes": n_bytes,
        "gathered_bytes": gathered, "l2_rate_gb_s": gathered / (ms * 1e-3) / 1e9,
    }
    return rec


def _segsum_cases(dev, gen) -> dict:
    """K4 (fused) at path C's and F's shapes: the user direction (38,403
    segments of about 8 edges, the train rows, over the 20,000 x 64 item
    table), the item direction (20,000 segments, skewed ids with gaps:
    :func:`sorted_segment_ids`, over the 38,403 x 64 user table), the
    stacked user direction (two modalities' tables and indices, one launch
    at width 128), and the item direction of a rebuilt graph (one hub
    segment of 38,389 edges: :func:`hub_segment_ids`); f32 and bf16 tables;
    307,180 real edges plus 20 sentinel pads (index one past the table,
    past offsets[n], never read). Then the KNN prototypes at yelp's image
    width: F's train rows over a 20,000 x 4,096 f32 feature table."""
    import torch

    from diffmm_tpu_torch.ops.kernels import segsum as sg

    U, I, nnz = YELP["user_num"], YELP["item_num"], YELP["edges"]
    out = {}
    # path C's rebuilt modality graphs put 38,389 of 38,403 users on one item
    for case, n, R, M, skew in (("user", U, I, 1, 1.0), ("item", I, U, 1, 2.0), ("stacked", U, I, 2, 1.0),
                                ("item_hub", I, U, 1, None)):
        ids = (hub_segment_ids(gen, n, nnz, 20, YELP["hub"], dev) if skew is None
               else sorted_segment_ids(gen, n, nnz, 20, skew, dev))
        offsets = sg.segment_offsets(ids, n)
        srcs = []
        for _ in range(M):
            src = torch.randint(0, R, (nnz,), generator=gen, device=dev).to(torch.int32)
            src[int(offsets[-1]):] = R  # the pads' index: one past the table
            srcs.append(src)
        for dtype in (torch.float32, torch.bfloat16):
            tables = torch.randn((M, R, 64), generator=gen, device=dev).to(dtype)
            table, src = (tables[0], srcs[0]) if M == 1 else (tables, srcs)
            rec = _k4_case(table, src, offsets)
            key = f"segsum_{case}" + ("" if dtype == torch.float32 else "_bf16")
            check(rec["ok"], f"{key}: {rec}")
            out[key] = rec
            print(f"[kernels] {key}: {json.dumps(rec)}")
    # the KNN prototypes (ops/knn.py) at yelp's image feature width
    rows = sorted_segment_ids(gen, U, nnz, 20, 1.0, dev)
    offsets = sg.segment_offsets(rows, U)
    cols = torch.randint(0, I, (nnz,), generator=gen, device=dev).to(torch.int32)
    cols[int(offsets[-1]):] = I
    feats = torch.randn((I, YELP["feat_dims"][0]), generator=gen, device=dev)
    rec = _k4_case(feats, cols, offsets, iters=10)
    check(rec["ok"], f"segsum_knn_prototypes: {rec}")
    out["segsum_knn_prototypes"] = rec
    print(f"[kernels] segsum_knn_prototypes: {json.dumps(rec)}")
    del feats
    return out


def _yelp_graphs(gen, dev, n_modal: int = 2):
    """Path C's graph layout at the yelp shape: the train edges (users of
    about 8 edges, items drawn uniformly, 20 sentinel pads) as a ``BiAdj``,
    and ``n_modal`` rebuilt modality graphs on the same rows, the first with
    path C's item hub (38,389 edges on one item), the others uniform."""
    import torch

    from diffmm_tpu_torch.ops.graph import build_bi_adj_device

    U, I, nnz = YELP["user_num"], YELP["item_num"], YELP["edges"]
    rows = sorted_segment_ids(gen, U, nnz, 20, 1.0, dev)
    real = nnz - 20

    def cols_of(ids):
        shuffled = ids[:real][torch.randperm(real, generator=gen, device=dev)]
        return torch.cat([shuffled, torch.full((20,), I, dtype=torch.int32, device=dev)])

    uniform = lambda: torch.randint(0, I, (nnz,), generator=gen, device=dev).to(torch.int32)  # noqa: E731
    main = build_bi_adj_device(rows, cols_of(uniform()), U, I)
    modal = [build_bi_adj_device(rows, cols_of(hub_segment_ids(gen, I, nnz, 20, YELP["hub"], dev) if m == 0
                                               else uniform()), U, I)
             for m in range(n_modal)]
    return main, modal


def _segsum_backward_cases(dev, gen) -> dict:
    """K4 in the backward of the sparse form's three Functions at path C's
    shape (``ops/graph.py``): a user-direction and an item-direction
    ``Propagate``, ``StackedUserPropagate`` (one launch a modality, the
    first over a hub) and ``MultiItemPropagate`` (one launch over both
    modalities' cotangents). Each backward call's gradient against the
    plain version of its launches within TOL["segsum"] scaled by the sum of
    each output's |terms|, bitwise across two calls, its K4 launches a
    call, and the call's time; each launch alone through :func:`_k4_case`
    (bitwise the unfused route with the cotangent's zero row, the times,
    the bound), summed over the call's launches."""
    import torch

    from diffmm_tpu_torch.ops import graph as og
    from diffmm_tpu_torch.ops.kernels import segsum as sg

    main, modal = _yelp_graphs(gen, dev)
    U, I, d = main.user_num, main.item_num, 64
    M = len(modal)
    cases = {
        # name: (function of z, z shape, output shape, its launches: (table of g, indices, offsets))
        "user_direction": (lambda z: og.Propagate.apply(z, main.ui_cols, main.ui_offsets, main.iu_cols,
                                                        main.iu_offsets, "f32"),
                           (I, d), (U, d), lambda g: [(g, main.iu_cols, main.iu_offsets)]),
        "item_direction": (lambda z: og.Propagate.apply(z, main.iu_cols, main.iu_offsets, main.ui_cols,
                                                        main.ui_offsets, "f32"),
                           (U, d), (I, d), lambda g: [(g, main.ui_cols, main.ui_offsets)]),
        "stacked_user": (lambda z: og.StackedUserPropagate.apply(z, tuple(modal), "f32"),
                         (M, I, d), (M, U, d),
                         lambda g: [(g[m].contiguous(), a.iu_cols, a.iu_offsets) for m, a in enumerate(modal)]),
        "multi_item": (lambda z: og.MultiItemPropagate.apply(z, tuple(modal), "f32"),
                       (M, U, d), (M, I, d), lambda g: [(g, [a.ui_cols for a in modal], modal[0].ui_offsets)]),
    }
    out = {}
    for name, (fn, z_shape, y_shape, launches_of) in cases.items():
        z = torch.randn(z_shape, generator=gen, device=dev).requires_grad_()
        g = torch.randn(y_shape, generator=gen, device=dev)
        y = fn(z)

        def backward():
            return torch.autograd.grad(y, z, g, retain_graph=True)[0]

        before = dict(sg.LAUNCHES)
        got, again = backward(), backward()
        per_call = {k: (v - before[k]) / 2 for k, v in sg.LAUNCHES.items()}
        launches = launches_of(g)
        want = [sg.segsum_gather_plain(t, src, o) for t, src, o in launches]
        scale = [sg.segsum_gather_plain(t.abs(), src, o) for t, src, o in launches]
        if name == "multi_item":
            want, scale = ([x[0].view(U, M, d).permute(1, 0, 2)] for x in (want, scale))
        got_parts = list(got) if name == "stacked_user" else [got]
        torch.cuda.synchronize()
        rtol, atol = TOL["segsum"]
        close = all(bool(((a - b).abs() <= rtol * c + atol).all()) for a, b, c in zip(got_parts, want, scale))
        bitwise = torch.equal(got, again)
        parts = [_k4_case(t, src, o, zero_row=True) for t, src, o in launches]
        ok = (close and bitwise and all(p["ok"] for p in parts)
              and per_call == {"segsum": len(launches), "segsum_unfused": 0})
        check(ok, f"segsum backward[{name}]: close {close}, bitwise {bitwise}, launches {per_call}, "
                  f"parts {parts}")
        rec = {
            "ok": ok, "z_shape": list(z_shape), "launches_per_backward": per_call["segsum"],
            "bitwise_across_launches": bitwise,
            "max_abs_err": max(max_err(a, b) for a, b in zip(got_parts, want)),
            "backward_ms": time_ms(backward, 20),
            "parts": parts,
            **{key: sum(p[key] for p in parts) for key in ("ms", "unfused_ms", "plain_ms", "bound_ms",
                                                          "gathered_bytes")},
            "library_ms": (sum(p["library_ms"] for p in parts)
                           if all(p["library_ms"] is not None for p in parts) else None),
            "bound_by": parts[0]["bound_by"],
        }
        rec["l2_rate_gb_s"] = rec["gathered_bytes"] / (rec["ms"] * 1e-3) / 1e9
        out[f"segsum_backward_{name}"] = rec
        print(f"[kernels] segsum_backward_{name}: {json.dumps(rec)}")
        del z, g, y, got, again, want, scale
    return out


def _small_config():
    from diffmm_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[64]"
    cfg.train.batch = 64
    cfg.train.test_batch = 64
    cfg.hyper.sampling_step = 0
    return cfg


def _reference_pair(dev, cfg):
    """A tiny synthetic Coach on the CPU (plain versions) and the same Coach
    on the card with the CPU one's parameters, each after its own rebuild;
    the card's graphs are then set to the CPU's, so the forwards compare on
    the same graphs. Returns (cpu coach, card coach, edge agreement)."""
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.train.coach import Coach

    host = make_synthetic_host_data(cfg, user_num=300, item_num=200, density=0.05, seed=5)
    cpu = Coach(cfg, host, device="cpu")
    gpu = Coach(cfg, host, device=dev)
    gpu.load_params(cpu.gcn_params, cpu.dn_params)
    bufs_c = cpu.rebuild_graphs()
    bufs_g = gpu.rebuild_graphs()
    same = [float((a == b.cpu()).float().mean()) for a, b in zip(bufs_c, bufs_g)]
    # scores differ in the last bits (f32 sums in another order), which may
    # swap items on exact ties only
    check(min(same) >= 0.99, f"edge buffers agree on {same}")
    gpu.set_edge_buffers([b.to(dev) for b in bufs_c])
    return cpu, gpu, same


def _check_close(got, want, rtol, atol, what) -> float:
    import torch

    err = max(max_err(g.cpu(), w.cpu()) for g, w in zip(got, want))
    ok = all(torch.allclose(g.cpu(), w.cpu(), rtol=rtol, atol=atol) for g, w in zip(got, want))
    check(ok, f"{what}: max_abs_err {err}")
    return err


def phase_reference(dev) -> dict:
    """Tiny Coaches on the card (kernels) against the same Coaches on the CPU
    (plain versions), same data, parameters and graphs: the dense form
    (bf16 tolerance on both sides, rtol 1e-2, atol 1e-3), the sparse form
    (f32 throughout, rtol 1e-4, atol 1e-5), and the card's sparse form
    against its dense form on the same graphs (the dense form's bf16
    rounding of z: rtol 1e-2, atol 1e-3; with bf16 messages the sparse form
    rounds z the same way, so only the f32 order of K1's and K4's sums
    differs, over two hops: rtol 1e-5, atol 1e-5)."""
    cfg = _small_config()
    rec = {}
    for form in ("dense", "sparse"):
        cfg.train.graph_form = form
        cpu, gpu, same = _reference_pair(dev, cfg)
        emb_c, emb_g = cpu.forward(), gpu.forward()
        tol = (1e-2, 1e-3) if form == "dense" else (1e-4, 1e-5)
        err = _check_close(emb_g, emb_c, *tol, f"{form} embeddings, card vs CPU")
        m_c = cpu.test_epoch(embeddings=emb_c)
        m_g = gpu.test_epoch(embeddings=tuple(e.to(dev) for e in emb_c))
        check(all(abs(m_c[k] - m_g[k]) < 1e-6 for k in m_c), f"{form} metrics {m_c} vs {m_g}")
        rec[form] = {"edge_agreement": same, "embedding_max_abs_err": err, "metrics": m_g,
                     "train_store": gpu.train_store_form}
    check(rec["sparse"]["train_store"] == "csr", f"sparse reference store {rec['sparse']}")

    # the card's sparse Coach against its dense one, on the sparse one's graphs
    for compute, tol in (("f32", (1e-2, 1e-3)), ("bf16", (1e-5, 1e-5))):
        cfg.train.graph_form, cfg.train.segsum_compute = "dense", "f32"
        dense = _twin(dev, cfg, gpu)
        cfg.train.graph_form, cfg.train.segsum_compute = "sparse", compute
        sparse = _twin(dev, cfg, gpu)
        err = _check_close(sparse.forward(), dense.forward(), *tol,
                           f"sparse ({compute} messages) vs dense form on the card")
        rec[f"sparse_{compute}_vs_dense_max_abs_err"] = err
    for form in ("dense", "sparse"):
        rec[f"train_step_{form}"] = _train_step_reference(dev, _small_config(), form)
    print(f"[reference] {json.dumps(rec)}")
    return rec


def _train_step_reference(dev, cfg, form: str, compute: str = "f32") -> dict:
    """One diffusion_block and one joint_block on the card and on the CPU
    from the same parameters, Adam states (after one CPU epoch, so the
    updates are smooth functions of the gradients) and injected draws:
    losses and updated parameters. Diffusion: f32 on both sides (cuBLAS
    without TF32), rtol 1e-4 / atol 1e-5; joint: the sparse form with f32
    messages, rtol 1e-4 / atol 1e-5; the dense form, and the sparse form
    with bf16 messages (``compute``, ``train.segsum_compute``), at the bf16
    tolerance, rtol 1e-2 / atol 1e-3: both sides round each propagation's
    input to bf16, and an input that differs in its last f32 bits (the
    sums' order) may round to the neighbouring bf16 value. The card's
    joint step must launch K1 (dense) or K4 (sparse) as often backward as
    forward, and K4 once for each loss gather's backward
    (:func:`joint_step_launches`)."""
    import torch

    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.models.gcn import project_features
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.train.optim import tree_leaves

    cfg.train.graph_form, cfg.train.segsum_compute = form, compute
    host = make_synthetic_host_data(cfg, user_num=300, item_num=200, density=0.05, seed=5)
    cpu = Coach(cfg, host, device="cpu")
    cpu.train_epoch(0)
    gpu = Coach(cfg, host, device=dev)
    gpu.load_params(cpu.gcn_params, cpu.dn_params, cpu.gcn_opt_state, cpu.dn_opt_states)
    gpu.set_edge_buffers([b.to(dev) for b in cpu.edge_buffers])
    M, B, I, d = cpu.n_modal, cfg.train.batch, host.item_num, cfg.base.latdim
    gen = torch.Generator().manual_seed(3)
    users = torch.randperm(host.user_num, generator=gen)[:B].to(torch.int32)
    weights = (torch.arange(B) < B - 5).to(torch.float32)
    t = torch.randint(0, cfg.hyper.steps, (M, B), generator=gen)
    noise = torch.randn((M, B, I), generator=gen)
    pick = torch.randint(0, host.nnz, (B,), generator=gen)
    rows, cols = torch.as_tensor(host.train_rows), torch.as_tensor(host.train_cols)
    batch = (rows[pick], cols[pick], torch.randint(0, I, (B,), generator=gen).to(torch.int32))
    cl_noise = [torch.rand((host.user_num if j % 2 == 0 else I, d), generator=gen) for j in range(6)]
    out = []
    for coach in (cpu, gpu):
        dv = coach.device
        hp = coach.hp()
        with torch.no_grad():
            feats = project_features(coach.gcn_params, coach.data.raw_feats)
        _zero_counters()
        diff = steps.diffusion_block(
            coach.schedule, coach.dn_params, coach.dn_opt_states, feats, coach.gcn_params["i_embs"],
            coach.data.train_store, users.to(dv), weights.to(dv), 1e-3, hp, I, t=t.to(dv), noise=noise.to(dv),
        )
        joint = steps.joint_block(
            coach.gcn_params, coach.gcn_opt_state, coach.data.adj, coach.modal_adjs, coach.data.raw_feats,
            *(x.to(dv) for x in batch), 1e-3, hp, cfg.base.cl_method, cfg.train.segsum_compute,
            cl_noise=[x.to(dv) for x in cl_noise],
        )
        out.append((diff, joint, {k: v for counts in _counters() for k, v in counts.items()}))
    (d_c, j_c, _), (d_g, j_g, launches) = out
    label = f"{form} ({compute} messages)"
    rec = {"launches": launches, "segsum_compute": compute}
    rec["diffusion_loss_max_abs_err"] = _check_close([d_g], [d_c], 1e-4, 1e-5, f"{label} diffusion losses")
    rec["denoiser_max_abs_err"] = _check_close(
        [p for dn in gpu.dn_params for p in tree_leaves(dn)],
        [p for dn in cpu.dn_params for p in tree_leaves(dn)], 1e-4, 1e-5, f"{label} denoisers after a step")
    tol = (1e-2, 1e-3) if form == "dense" or compute == "bf16" else (1e-4, 1e-5)
    rec["joint_metrics_max_abs_err"] = _check_close([j_g], [j_c], *tol, f"{label} joint metrics")
    rec["gcn_max_abs_err"] = _check_close(tree_leaves(gpu.gcn_params), tree_leaves(cpu.gcn_params), *tol,
                                          f"{label} GCN after a joint step")
    want = joint_step_launches(form == "dense", M, cfg.base.cl_method)
    check(all(launches[k] == v for k, v in want.items()),
          f"{label} joint step launches {launches}, want {want} (forward and backward, loss gathers)")
    rec["losses"] = {"diffusion": d_g.tolist(), "joint": j_g.tolist()}
    return rec


def joint_step_launches(dense: bool, n_modal: int, cl_method: int, knn: bool = False) -> dict:
    """Kernel launches of one joint step (forward and backward). Dense: K1
    once a propagation each way, M + 4 propagations (M modal, 2 main, 2 in
    the cross-layer CL). Sparse: K4 M + 9 times each way (1 stacked user +
    M item directions, 2 x 2 main, 2 x 2 cross-layer CL). Both forms: K4
    once for the backward of each loss gather: BPR 3, the cross-layer CL
    2 x 2, the modal CL 2 x 2 per modality (cl_method 0) or per pair of
    modalities (cl_method 1). The KNN ablation's modality graphs are sparse
    on both forms and propagate one by one (no stacking): K4 twice each way
    a modality, K1 (dense) or K4 (sparse) for the 4 main-graph propagations.
    Every K4 launch is the fused entry's: the unfused one never launches."""
    pairs = n_modal * (n_modal - 1) // 2 if cl_method == 1 else n_modal
    gathers = 3 + 4 + 4 * pairs
    if knn:
        modal = 2 * 2 * n_modal
        if dense:
            return {"spmm_dual": 2 * 4, "segsum": modal + gathers, "segsum_unfused": 0}
        return {"spmm_dual": 0, "segsum": modal + 2 * 2 * 4 + gathers, "segsum_unfused": 0}
    if dense:
        return {"spmm_dual": 2 * (n_modal + 4), "segsum": gathers, "segsum_unfused": 0}
    return {"spmm_dual": 0, "segsum": 2 * (n_modal + 9) + gathers, "segsum_unfused": 0}


def rebuild_runs_k2k3(cfg) -> bool:
    """Whether the rebuild runs the denoiser kernels K2/K3: a rebuild (no
    KNN ablation) in f32 with one hidden layer (``train/steps.py::
    rebuild_forward``)."""
    return (not cfg.hyper.use_knn_adj and cfg.train.rebuild_compute == "f32"
            and len(cfg.base.denoise_dims()) == 1)


def _twin(dev, cfg, like):
    """A Coach for ``cfg`` on the card with ``like``'s parameters and graphs."""
    from diffmm_tpu_torch.train.coach import Coach

    coach = Coach(cfg, like.host, device=dev)
    coach.load_params(like.gcn_params, like.dn_params)
    coach.set_edge_buffers(like.edge_buffers)
    return coach


def _counters():
    from diffmm_tpu_torch.ops.kernels import adam, denoise_mlp, segsum, spmm_dual

    return (spmm_dual.LAUNCHES, denoise_mlp.LAUNCHES, segsum.LAUNCHES, adam.LAUNCHES)


def _zero_counters() -> None:
    """Set every kernel's launch count to 0."""
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def tensor_numels(obj) -> set:
    """Element counts of every tensor ``obj`` holds, through dicts, lists,
    tuples and dataclasses; of a Coach, pass ``vars(coach)``: its data,
    store, adjacencies, parameters and graphs."""
    import dataclasses

    import torch

    sizes, todo = set(), [obj]
    while todo:
        obj = todo.pop()
        if isinstance(obj, torch.Tensor):
            sizes.add(obj.numel())
        elif isinstance(obj, dict):
            todo.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            todo.extend(obj)
        elif dataclasses.is_dataclass(obj):
            todo.extend(getattr(obj, f.name) for f in dataclasses.fields(obj))
    return sizes


def held_bytes(obj) -> int:
    """Bytes of the card storages ``obj`` holds (each storage once), walked
    as :func:`tensor_numels` walks it."""
    import dataclasses

    import torch

    seen, total, todo = set(), 0, [obj]
    while todo:
        obj = todo.pop()
        if isinstance(obj, torch.Tensor):
            st = obj.untyped_storage()
            if obj.is_cuda and st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif isinstance(obj, dict):
            todo.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            todo.extend(obj)
        elif dataclasses.is_dataclass(obj):
            todo.extend(getattr(obj, f.name) for f in dataclasses.fields(obj))
    return total


def coach_state_bytes(coach) -> dict:
    """A Coach's own state on the card: its parameters with their Adam
    moments, and everything it holds (data, train store, adjacencies,
    parameters, moments)."""
    states = [coach.gcn_opt_state, *coach.dn_opt_states]
    return {"params_and_moments": held_bytes([coach.gcn_params, coach.dn_params,
                                              [s.mu + s.nu for s in states]]),
            "all": held_bytes(vars(coach))}


def drive_path(dev, cfg, host, label: str):
    """Rebuild -> test_epoch -> build_index -> 8 recommend requests, with
    every kernel counter set to 0 just before and read just after. Returns
    the record and the Coach (warm, for the profile)."""
    import torch

    from diffmm_tpu_torch.eval.serving import build_index, recommend
    from diffmm_tpu_torch.train.coach import Coach

    times = {}

    def fence(name, t0):
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0

    gc.collect()  # earlier paths' garbage is not counted as held
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    coach = Coach(cfg, host, device=dev)
    fence("setup_s", t0)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _zero_counters()
    t0 = time.perf_counter()
    bufs = coach.rebuild_graphs()
    fence("rebuild_s", t0)
    t0 = time.perf_counter()
    metrics = coach.test_epoch()
    fence("eval_s", t0)
    t0 = time.perf_counter()
    index = build_index(coach)
    fence("build_index_s", t0)
    gen = torch.Generator().manual_seed(cfg.base.seed)
    requests = torch.randint(0, host.user_num, (8,), generator=gen)
    answers = []
    t0 = time.perf_counter()
    for u in requests:
        answers.append(recommend(index, u.view(1), 20))
    fence("recommend_8_s", t0)
    launches = {k: v for counts in _counters() for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    check(all(b.shape == (coach.edge_buf_len,) for b in bufs), "edge buffer shape")
    for k, v in metrics.items():
        check(math.isfinite(v) and 0.0 <= v <= 1.0, f"{label} {k}={v}")
    seen = index.seen_indptr.cpu().numpy(), index.seen_indices.cpu().numpy()
    for u, (ids, scores) in zip(requests.tolist(), answers):
        ids, scores = ids.cpu()[0], scores.cpu()[0]
        check(ids.shape == (20,) and bool(((ids >= 0) & (ids < host.item_num)).all()),
              f"{label} ids out of range for user {u}")
        check(bool(torch.isfinite(scores).all()) and bool((scores[:-1] >= scores[1:]).all()),
              f"{label} scores not finite and sorted for user {u}")
        user_seen = set(seen[1][seen[0][u]:seen[0][u + 1]].tolist())
        check(not (set(ids.tolist()) & user_seen), f"{label} seen item served to user {u}")
    n_fwd = 2  # test_epoch and build_index
    blocks = sum(int(b.shape[0]) for b in coach.rebuild_blocks)
    want_dn = coach.n_modal * cfg.hyper.steps * blocks
    check(launches[K2_ENTRY] == want_dn and launches["denoise_layer2"] == want_dn
          and launches[K2_MESH_ENTRY] == 0, f"{label} denoise launches {launches}, want {want_dn} each")
    if coach.dense_graphs:
        # one per modality graph, two over the main graph
        per_fwd, kernel, other = coach.n_modal + 2, "spmm_dual", "segsum"
    else:
        # two per main-graph propagation, one stacked user direction, one
        # item direction per modality
        per_fwd, kernel, other = 2 * 2 + 1 + coach.n_modal, "segsum", "spmm_dual"
    check(launches[kernel] >= per_fwd * n_fwd and launches[other] == 0 and launches["segsum_unfused"] == 0,
          f"{label} launches {launches}, want {kernel} >= {per_fwd * n_fwd}, no {other}, no unfused K4")
    if not coach.dense_graphs:
        # K4's longest segments: the largest item degree of the main graph
        # and of each rebuilt modality graph
        hubs = [int(a.iu_offsets.diff().max()) for a in (coach.data.adj, *coach.modal_adjs)]
    rec = {
        "shape": [host.user_num, host.item_num, host.nnz],
        "graph_form": "dense" if coach.dense_graphs else "sparse",
        "max_item_degree": None if coach.dense_graphs else hubs,
        "train_store": coach.train_store_form,
        "metrics": metrics,
        "times": times,
        "peak_mem_bytes": peak,
        # allocated when the peak was reset: what earlier phases still hold
        # (Coaches kept for later paths, cached kernel scratch) and this
        # Coach's own state (parameters, Adam moments, graphs, train store)
        "held_at_start_bytes": held,
        "coach_bytes": held - before,
        "launches": launches,
        "rebuild_widths": list(coach.rebuild_widths),
        "gcn_forwards": n_fwd,
    }
    print(f"[path {label}] {json.dumps(rec)}")
    return rec, coach


def _tiktok_shape():
    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.data.synthetic import synthesize_shape

    cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
    t0 = time.perf_counter()
    host = synthesize_shape(cfg, "tiktok")
    print(f"[path A] synthetic data in {time.perf_counter() - t0:.1f} s")
    return cfg, host


# the named ranges of Coach.timer's phases (utils/profiling.py annotate)
PHASE_RANGES = {"neg_sampling", "diffusion", "rebuild", "joint", "eval", "fused"}


def phase_profile(work, label: str, report_dir: str) -> dict:
    """torch.profiler over ``work()`` on a warm Coach (a path's rebuild +
    eval, or a training path's joint phase): device time by kernel name and
    the device's busy share of the wall time. The table goes to
    ``<report_dir>/profile_path_<label>.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # kernel rows only (the operator rows carry their kernels' time too, and
    # the Coach's phase ranges show as device rows spanning their kernels)
    kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in PHASE_RANGES]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    busy = sum(dev_us.values()) / 1e6
    top = sorted(((v, k) for k, v in dev_us.items() if v > 0), reverse=True)[:14]
    with open(os.path.join(report_dir, f"profile_path_{label}.txt"), "w") as fh:
        fh.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    counts = {e.key: e.count for e in kernels}
    # the port's own kernels, whether or not they make the top rows
    own = ("dual_kernel", "gemm_3xtf32", "strip_3xtf32", "splitk_sum", "segsum_kernel", "segsum_plan",
           "adam_kernel")

    def share(*names):
        return sum(v for k, v in dev_us.items() if any(name in k for name in names)) / 1e6 / busy

    rec = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
           # PyTorch's row gathers (index_select: vectorized_gather_kernel on this
           # PyTorch, indexSelect* on older ones) and K4 (its plan and sums), shares of the busy time
           "index_select_share": share("vectorized_gather_kernel", "indexSelect"),
           "segsum_share": share("segsum_kernel", "segsum_plan"),
           "top_device_ms": [[k[:60], v / 1e3, counts[k]] for v, k in top],
           "port_kernels_ms": [[k[:60], v / 1e3, counts[k]] for k, v in dev_us.items()
                               if any(name in k for name in own)]}
    print(f"[profile {label}] {json.dumps(rec)}")
    return rec


def _rebuild_and_eval(coach):
    def work():
        coach.rebuild_graphs()
        coach.test_epoch()
    return work


def phase_path_a(dev) -> tuple[dict, object, object]:
    cfg, host = _tiktok_shape()
    rec, coach = drive_path(dev, cfg, host, "A")
    check(rec["graph_form"] == "dense" and rec["train_store"] == "dense", f"A form {rec}")
    return rec, coach, host


def _tiktok_mini(sparse: bool):
    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.data.loader import load_host_data

    cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
    cfg.data.name = "tiktok_mini"
    # 600 users make one block at batch 1024; at 256 the real degree skew
    # (max 576, median 2) gives the two-bucket rebuild plan
    cfg.train.batch = 256
    if sparse:
        cfg.train.graph_form = "sparse"
    return cfg, load_host_data(cfg, data_root=os.path.join(REPO, "data"))


def phase_path_b(dev) -> dict:
    rec, _ = drive_path(dev, *_tiktok_mini(sparse=False), "B")
    check(len(rec["rebuild_widths"]) == 2, f"B rebuild plan {rec['rebuild_widths']}")
    return rec


def _yelp_shape():
    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.data.synthetic import synthesize_shape

    cfg = load_config(os.path.join(REPO, "conf", "yelp.toml"))
    cfg.train.graph_form = "sparse"  # the train store stays "auto"
    t0 = time.perf_counter()
    host = synthesize_shape(cfg, "yelp")
    print(f"[path C] synthetic data in {time.perf_counter() - t0:.1f} s")
    return cfg, host


def phase_path_c(dev) -> tuple[dict, object, object]:
    cfg, host = _yelp_shape()
    rec, coach = drive_path(dev, cfg, host, "C")
    check(rec["graph_form"] == "sparse" and rec["train_store"] == "csr", f"C form {rec}")
    blocks = -(-host.user_num // cfg.train.batch)  # 38 at 1,024 users a block
    check(rec["launches"][K2_ENTRY] == 2 * cfg.hyper.steps * blocks,
          f"C denoise launches {rec['launches']}")
    ui = host.user_num * host.item_num
    check(ui not in tensor_numels(vars(coach)), "C holds a (U, I) tensor")
    rec["holds_ui_tensor"] = False
    return rec, coach, host


def phase_path_d(dev) -> dict:
    rec, coach = drive_path(dev, *_tiktok_mini(sparse=True), "D")
    store = coach.data.train_store
    check(rec["train_store"] == "csr" and store.heavy_ids is not None and store.k_cut < store.k_max,
          f"D store {rec['train_store']}: no head/tail split")
    rec["head_tail"] = {"k_cut": store.k_cut, "k_max": store.k_max, "heavy": int(store.heavy_ids.numel())}
    check(coach.host.user_num * coach.host.item_num not in tensor_numels(vars(coach)),
          "D holds a (U, I) tensor")
    return rec


def drive_training(dev, cfg, host, label: str, epochs: int, overflowing: tuple = ()):
    """``train_epoch(e, fence=True)`` for ``epochs`` epochs, then
    ``test_epoch``, with every kernel counter set to 0 just before and read
    just after; each epoch's joint phase counts its own launches (its
    K1/K4 forward and backward). Returns the record and the warm Coach.
    Every loss must be finite but those named in ``overflowing``, which
    must not be NaN (path S: see ``S_OVERFLOWING``)."""
    import torch

    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.train.optim import tree_leaves

    gc.collect()
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    coach = Coach(cfg, host, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    joint_launches = []
    joint_phase = coach._joint_phase

    def counted(*args, **kwargs):
        before = {k: v for counts in _counters() for k, v in counts.items()}
        result = joint_phase(*args, **kwargs)
        joint_launches.append({k: v - before[k] for counts in _counters() for k, v in counts.items()})
        return result

    coach._joint_phase = counted
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _zero_counters()
    epochs_rec = []
    for epoch in range(epochs):
        coach.timer.reset()
        t0 = time.perf_counter()
        losses = coach.train_epoch(epoch, fence=True)
        wall = time.perf_counter() - t0
        check(all(math.isfinite(v) or (k in overflowing and not math.isnan(v)) for k, v in losses.items()),
              f"{label} epoch {epoch} losses {losses}")
        epochs_rec.append({"epoch": epoch, "wall_s": wall, "phases_s": dict(coach.timer.totals),
                           "losses": losses, "joint_launches": joint_launches[-1]})
        print(f"[path {label}] epoch {epoch}: {json.dumps(epochs_rec[-1])}")
    t0 = time.perf_counter()
    metrics = coach.test_epoch()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {k: v for counts in _counters() for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    coach._joint_phase = joint_phase
    for k, v in metrics.items():
        check(math.isfinite(v) and 0.0 <= v <= 1.0, f"{label} {k}={v}")
    batch = cfg.train.batch
    n_joint = -(-host.nnz // batch)
    n_diff = -(-host.user_num // batch)
    blocks = sum(int(b.shape[0]) for b in coach.rebuild_blocks)
    want_dn = coach.n_modal * cfg.hyper.steps * blocks * epochs if rebuild_runs_k2k3(cfg) else 0
    check(launches[K2_ENTRY] == want_dn and launches["denoise_layer2"] == want_dn
          and launches[K2_MESH_ENTRY] == 0,
          f"{label} denoise launches {launches}, want {want_dn} each (the rebuilds)")
    # every joint step's launches, replayed steps included (a graph's count
    # a replay times its replays)
    want = {k: v * n_joint for k, v in joint_step_launches(
        coach.dense_graphs, coach.n_modal, cfg.base.cl_method, coach.knn).items()}
    for e in epochs_rec:
        got = e["joint_launches"]
        check(all(got[k] == v for k, v in want.items()),
              f"{label} joint launches {got}, want {want}")
    check(launches["segsum_unfused"] == 0, f"{label}: the unfused K4 launched ({launches})")
    # Adam's one pass: a launch a tree a step, every f32 tree (bf16
    # denoisers take the op-by-op step)
    f32_dn = sum(all(p.dtype == torch.float32 for p in tree_leaves(dn)) for dn in coach.dn_params)
    want_adam = epochs * (n_diff * f32_dn + n_joint)
    check(launches["adam"] == want_adam, f"{label}: {launches['adam']} Adam launches, want {want_adam}")
    graphs = {key[0] + ("" if key[0] != "rebuild" else f"_{key[1]}"):
              {"replays": g.replays, "launches_a_replay": g.launches}
              for key, g in coach.graphs.graphs.items()}
    want_graphs = {"diffusion", "joint"} | (set() if coach.knn else {"rebuild_0"})
    check(set(graphs) >= want_graphs and (not coach.knn or "rebuild" not in str(set(graphs))),
          f"{label} graphs {graphs}")
    rec = {
        "shape": [host.user_num, host.item_num, host.nnz],
        "graph_form": "dense" if coach.dense_graphs else "sparse",
        "train_store": coach.train_store_form,
        "cl_method": cfg.base.cl_method,
        "setup_s": setup_s,
        "epochs": epochs_rec,
        "eval_s": eval_s,
        "metrics": metrics,
        "peak_mem_bytes": peak,
        "held_at_start_bytes": held,  # as in drive_path
        "coach_bytes": held - before,
        "launches": launches,
        "joint_blocks": n_joint,
        "diffusion_blocks": n_diff,
        "joint_launches_wanted": want,
        "graphs": graphs,
    }
    print(f"[path {label}] {json.dumps(rec)}")
    return rec, coach


def phase_path_e(dev, host) -> tuple[dict, object]:
    """Training at full width on path A's data and conf/test.toml hypers."""
    from diffmm_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
    rec, coach = drive_training(dev, cfg, host, "E", epochs=2)
    check(rec["graph_form"] == "dense", f"E form {rec['graph_form']}")
    return rec, coach


def phase_path_f(dev, host) -> tuple[dict, object]:
    """Training at full width on path C's data, conf/yelp.toml hypers
    (cl_method 1), the sparse form; no (U, I) tensor anywhere."""
    from diffmm_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "conf", "yelp.toml"))
    cfg.train.graph_form = "sparse"
    rec, coach = drive_training(dev, cfg, host, "F", epochs=1)
    check(rec["graph_form"] == "sparse" and rec["train_store"] == "csr" and rec["cl_method"] == 1,
          f"F form {rec}")
    check(host.user_num * host.item_num not in tensor_numels(vars(coach)), "F holds a (U, I) tensor")
    rec["holds_ui_tensor"] = False
    return rec, coach


# The JAX package's accuracy bar (tests/test_regression_mini.py:28-51):
# Recall@20 after two epochs on data/tiktok_mini with this configuration at
# seed 1818. A two-epoch Recall there counts a handful of hits among 398
# test users and spreads from seed to seed (the JAX package's own run on
# the CPU lands in the band at about half its seeds), so the run at seed
# 1818 is checked and the runs at G_SEEDS are recorded beside it.
RECALL_BAND = (0.008, 0.019)
G_SEEDS = tuple(range(1, 10))


def _mini_recall(dev, host, seed: int, **settings) -> tuple[dict, list]:
    from diffmm_tpu_torch.config import Config
    from diffmm_tpu_torch.train.coach import Coach

    cfg = Config()
    cfg.data.name = "tiktok_mini"
    cfg.base.seed = seed
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[64]"
    cfg.train.batch = 256
    cfg.train.test_batch = 256
    cfg.train.epoch = 2
    for name, value in settings.items():
        section, key = name.split(".")
        setattr(getattr(cfg, section), key, value)
    coach = Coach(cfg, host, device=dev)
    losses = [coach.train_epoch(epoch) for epoch in range(2)]
    return coach.test_epoch(), losses


# The JAX package's baby_mini bar (tests/test_regression_baby_mini.py:27-51):
# Recall@20 after four epochs on data/baby_mini (both feature blobs
# synthesised, svd) at seed 1818; the seeds around it recorded.
BABY_BAND = (0.006, 0.018)
BABY_SEEDS = tuple(range(1, 6))


def _baby_recall(dev, host, seed: int) -> dict:
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import NullLog

    cfg = _baby_config()
    cfg.base.seed = seed
    coach = Coach(cfg, host, device=dev, log=NullLog())
    for epoch in range(4):
        coach.train_epoch(epoch)
    return coach.test_epoch()


def _baby_config():
    from diffmm_tpu_torch.config import Config

    cfg = Config()
    cfg.data.name = "baby_mini"
    cfg.data.missing_modalities = "svd"
    cfg.base.latdim = 32
    cfg.base.denoise_dim = "[64]"
    cfg.train.batch = 512
    cfg.train.test_batch = 512
    cfg.train.epoch = 4
    return cfg


def phase_path_g(dev) -> dict:
    """Two epochs on data/tiktok_mini with the configuration of
    tests/test_regression_mini.py on the card: Recall@20 at seed 1818 in
    RECALL_BAND; the other seeds' recorded. Then four epochs on
    data/baby_mini with the configuration of
    tests/test_regression_baby_mini.py: Recall@20 at seed 1818 in
    BABY_BAND; BABY_SEEDS' recorded."""
    from diffmm_tpu_torch.config import Config
    from diffmm_tpu_torch.data.loader import load_host_data

    cfg = Config()
    cfg.data.name = "tiktok_mini"
    host = load_host_data(cfg, data_root=os.path.join(REPO, "data"))
    t0 = time.perf_counter()
    metrics, losses = _mini_recall(dev, host, 1818)  # the eval ends in a host copy
    rec = {"losses": losses, "metrics": metrics, "band": list(RECALL_BAND),
           "wall_s": time.perf_counter() - t0,
           "other_seeds_recall": {s: _mini_recall(dev, host, s)[0]["Recall"] for s in G_SEEDS}}
    baby_host = load_host_data(_baby_config(), data_root=os.path.join(REPO, "data"))
    check((baby_host.user_num, baby_host.item_num) == (2000, 7050) and baby_host.synthesized == ["image", "text"],
          f"G baby_mini {baby_host.user_num} x {baby_host.item_num}, synthesised {baby_host.synthesized}")
    t0 = time.perf_counter()
    baby = _baby_recall(dev, baby_host, 1818)
    rec["baby_mini"] = {"metrics": baby, "band": list(BABY_BAND), "wall_s": time.perf_counter() - t0,
                        "other_seeds_recall": {s: _baby_recall(dev, baby_host, s)["Recall"] for s in BABY_SEEDS}}
    print(f"[path G] {json.dumps(rec)}")
    check(RECALL_BAND[0] <= metrics["Recall"] <= RECALL_BAND[1],
          f"G Recall@20 {metrics['Recall']} outside {RECALL_BAND}")
    check(BABY_BAND[0] <= baby["Recall"] <= BABY_BAND[1],
          f"G baby_mini Recall@20 {baby['Recall']} outside {BABY_BAND}")
    return rec


def _joint_phase_work(coach, epoch: int, graphed: bool = True):
    """One more joint phase of a trained Coach at ``epoch``'s learning
    rate, on fresh negatives and a fresh permutation (the profiled part of
    a training path): replayed from the Coach's captured graph, or run
    eagerly (``graphed=False``)."""
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.optim import cosine_lr

    cfg, data = coach.config, coach.data
    negs = coach.sample_negatives()
    perm = coach._epoch_tables(epoch, 1)[0]["perm"]
    lr = cosine_lr(epoch, cfg.train.lr, coach.total_epochs)
    if graphed:
        return lambda: coach._joint_phase(perm, negs, lr, coach.hp())
    nb = perm.shape[0] // cfg.train.batch
    users, pos, neg = (a.index_select(0, perm).reshape(nb, cfg.train.batch)
                       for a in (data.train_rows, data.train_cols, negs))
    return lambda: steps.joint_epoch(
        coach.gcn_params, coach.gcn_opt_state, data.adj, coach.modal_adjs, data.raw_feats,
        users, pos, neg, lr, coach.hp(), cfg.base.cl_method, cfg.train.segsum_compute,
        coach.generator, graphs=None,
    )


# ------------------------------------------------------- I-M: the knobs, KNN, HTTP
def _test_config(**settings):
    """conf/test.toml (paths A and E) with ``settings`` ({"section.key": value})."""
    from diffmm_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
    for name, value in settings.items():
        section, key = name.split(".")
        setattr(getattr(cfg, section), key, value)
    return cfg


def raises_value_error(fn) -> bool:
    """Whether ``fn()`` raises ValueError (a refusal, made before any kernel)."""
    try:
        fn()
    except ValueError:
        return True
    return False


def _storage_bytes(t) -> int:
    return t.untyped_storage().nbytes()


def phase_path_i(dev, host, coach_a, rec_a) -> dict:
    """Path I: path A's serving path with ``train.dense_store="int4"``
    (packed blocks, K1's int4 read), held against path A at int8: edge
    buffers, embeddings and metrics equal bitwise (the same cells, and K1's
    int4 plan is its int8 plan)."""
    import torch

    rec, coach = drive_path(dev, _test_config(**{"train.dense_store": "int4"}), host, "I")
    check(coach.data.adj.mat.dtype == torch.uint8 and all(a.mat.dtype == torch.uint8 for a in coach.modal_adjs),
          "I: the blocks are not packed int4")
    same = {
        "edge_buffers": _bitwise(coach.edge_buffers, coach_a.edge_buffers),
        "embeddings": _bitwise(list(coach.forward()), list(coach_a.forward())),
        "metrics": rec["metrics"] == rec_a["metrics"],
    }
    check(all(same.values()), f"I (int4) vs A (int8): {same}")
    rec["equal_to_A"] = same
    blocks = [coach.data.adj, *coach.modal_adjs]
    rec["block_bytes"] = {"int4": sum(_storage_bytes(a.mat) for a in blocks),
                          "int8": sum(_storage_bytes(a.mat) for a in (coach_a.data.adj, *coach_a.modal_adjs))}
    print(f"[path I] vs A: {json.dumps(rec['equal_to_A'])}, block bytes {json.dumps(rec['block_bytes'])}")
    return rec


def phase_path_j(dev, host, rec_e, coach_e) -> dict:
    """Path J: path E's training with ``train.dense_store="int4"``, epochs
    0 and 1 fenced and test_epoch; its epoch-1 loss held bitwise against
    E's where K1's int4 and int8 plans agree; its memory beside E's and the
    blocks' expected saving; one more fenced epoch (the steady rebuild) and
    the in-place rebuild of the modality blocks (``set_edge_buffers``) timed
    beside E's."""
    from diffmm_tpu_torch.ops.kernels import spmm_dual as sd

    rec, coach = drive_training(dev, _test_config(**{"train.dense_store": "int4"}), host, "J", epochs=2)
    U, I, d = host.user_num, host.item_num, coach.config.base.latdim
    layout = lambda p: (p.cluster, p.col_blocks, p.row_blocks, p.rows, p.groups)  # noqa: E731
    plans_agree = layout(sd.plan(U, I, d, "int4", dev)) == layout(sd.plan(U, I, d, "int8", dev))
    losses_j, losses_e = rec["epochs"][1]["losses"], rec_e["epochs"][1]["losses"]
    if plans_agree:
        check(losses_j == losses_e, f"J epoch 1 {losses_j} vs E's {losses_e}")
    else:
        print("[path J] K1's int4 and int8 plans differ: the losses are not held bitwise")
    n_blocks = coach.n_modal + 1
    expected = {"int8": n_blocks * (U + 1) * (-(-I // 16) * 16),
                "int4": n_blocks * (U + 1) * (-(-I // 32) * 32) // 2}
    need = lambda r: r["peak_mem_bytes"] - r["held_at_start_bytes"] + r["coach_bytes"]  # noqa: E731
    rec["vs_E"] = {
        "plans_agree": plans_agree,
        "epoch1_losses_equal": losses_j == losses_e,
        "expected_block_bytes": expected,
        "expected_saving_bytes": expected["int8"] - expected["int4"],
        "coach_bytes": {"E": rec_e["coach_bytes"], "J": rec["coach_bytes"]},
        "coach_and_run_bytes": {"E": need(rec_e), "J": need(rec)},
        "measured_saving_bytes": {"coach": rec_e["coach_bytes"] - rec["coach_bytes"],
                                  "coach_and_run": need(rec_e) - need(rec)},
        "steady_epoch_s": {"E": rec_e["epochs"][1]["wall_s"], "J": rec["epochs"][1]["wall_s"]},
        # three modality blocks rebuilt in place, ending in a synchronize
        "set_edge_buffers_ms": {c: time_ms(lambda co=co: co.set_edge_buffers(co.edge_buffers), 10)
                                for c, co in (("E", coach_e), ("J", coach))},
    }
    coach.timer.reset()
    t0 = time.perf_counter()
    coach.train_epoch(2, fence=True)
    rec["epoch2"] = {"wall_s": time.perf_counter() - t0, "phases_s": dict(coach.timer.totals)}
    print(f"[path J] vs E: {json.dumps(rec['vs_E'])}")
    del coach
    return rec


def phase_path_k(dev, host) -> dict:
    """Path K: path E's data with the KNN ablation (``hyper.use_knn_adj``,
    knn_topk 10), one epoch and test_epoch: no rebuild phase and no rebuild
    graph, ``rebuild_graphs`` refuses, each joint step launches K1 for the
    main graph and K4 for the KNN graphs (``joint_step_launches``); then the
    KNN graphs against the plain version on the card: K4's prototypes (one
    fused launch a modality, no unfused one) within its rule, each user's
    top-k set equal outside similarity ties (1e-6)."""
    import torch

    from diffmm_tpu_torch.ops import knn
    from diffmm_tpu_torch.ops.kernels import segsum as sg
    from diffmm_tpu_torch.ops.losses import l2_normalize

    topk = 10
    rec, coach = drive_training(dev, _test_config(**{"hyper.use_knn_adj": True, "hyper.knn_topk": topk}),
                                host, "K", epochs=1)
    check("rebuild" not in rec["epochs"][0]["phases_s"], f"K ran a rebuild phase: {rec['epochs'][0]}")
    check(raises_value_error(coach.rebuild_graphs), "K: rebuild_graphs did not refuse")
    rows, cols, U = coach.data.train_rows, coach.data.train_cols, host.user_num
    offsets = sg.segment_offsets(rows, U)
    rtol, atol = TOL["segsum"]
    checks = []
    for m, (feats, adj) in enumerate(zip(coach.data.raw_feats, coach.modal_adjs)):
        feats = feats.to(torch.float32)
        before = dict(sg.LAUNCHES)
        got = knn.knn_prototypes(rows, cols, feats, U)
        _, got_cols = knn.knn_edges(rows, cols, feats, U, topk)
        launched = {k: v - before[k] for k, v in sg.LAUNCHES.items()}
        want = sg.segsum_gather_plain(feats, cols.to(torch.int32), offsets)
        scale = sg.segsum_gather_plain(feats.abs(), cols.to(torch.int32), offsets)
        counts = torch.clamp_min(offsets.diff().to(torch.float32), 1.0)[:, None]
        proto_ok = (bool(((got - want / counts).abs() <= (rtol * scale + atol) / counts).all())
                    and launched == {"segsum": 2, "segsum_unfused": 0})
        proto = want / counts
        sim = l2_normalize(proto, dim=1) @ l2_normalize(feats, dim=1).T
        plain_cols = torch.topk(sim, topk, dim=1).indices
        got_cols = got_cols.view(U, topk).long()
        check(torch.equal(adj.ui_cols.view(U, topk).long(), got_cols), f"K modality {m}: graph != knn_edges")
        kth = sim.gather(1, plain_cols[:, -1:])
        got_in = torch.zeros_like(sim, dtype=torch.bool).scatter_(1, got_cols, True)
        want_in = torch.zeros_like(sim, dtype=torch.bool).scatter_(1, plain_cols, True)
        differ = got_in ^ want_in
        ties_only = bool(((sim - kth).abs()[differ] <= 1e-6).all())
        checks.append({"modality": m, "width": int(feats.shape[1]), "prototypes_ok": proto_ok,
                       "prototype_launches": launched,
                       "prototype_max_abs_err": max_err(got, want / counts), "edges_differing": int(differ.sum()),
                       "edges_equal_outside_ties": ties_only})
        check(proto_ok and ties_only, f"K KNN graph {m} vs plain: {checks[-1]}")
    rec["knn_checks"] = checks
    rec["rebuild_graphs_refuses"] = True
    print(f"[path K] KNN graphs vs plain: {json.dumps(checks)}")
    del coach
    return rec


# the knobs path G repeats under (its own configuration, seed 1818)
G_KNOBS = {
    "bf16_params": {"base.denoise_param_dtype": "bf16"},
    "bf16_rebuild": {"train.rebuild_compute": "bf16"},
    "deep_denoiser": {"base.denoise_dim": "[64, 64]"},
}


def phase_path_l(dev, host) -> dict:
    """Path L: path E's data, one epoch and test_epoch, (1) with bf16
    denoisers (K2/K3 launch as in E, on the weights widened to f32) and (2)
    with the bf16 rebuild and a [1024, 1024] denoiser (no K2/K3 launch in
    the rebuild); each finite, on captured graphs, and one more epoch under
    ``set_sync_debug_mode("error")``. Then path G's run at seed 1818 under
    each of G_KNOBS, its Recall@20 recorded against RECALL_BAND."""
    import torch

    from diffmm_tpu_torch.config import Config
    from diffmm_tpu_torch.data.loader import load_host_data
    from diffmm_tpu_torch.train.optim import tree_leaves

    out = {}
    for label, settings in (("L1", {"base.denoise_param_dtype": "bf16"}),
                            ("L2", {"train.rebuild_compute": "bf16", "base.denoise_dim": "[1024, 1024]"})):
        rec, coach = drive_training(dev, _test_config(**settings), host, label, epochs=1)
        if label == "L1":
            check(all(p.dtype == torch.bfloat16 for dn in coach.dn_params for p in tree_leaves(dn)),
                  "L1: the denoisers are not bf16")
        rec["settings"] = settings
        rec["no_sync_epoch_s"] = no_sync_epoch(coach, 1)
        out[label] = rec
        print(f"[path {label}] settings {json.dumps(settings)}, no-sync epoch {rec['no_sync_epoch_s']} s")
        del coach
    cfg = Config()
    cfg.data.name = "tiktok_mini"
    mini = load_host_data(cfg, data_root=os.path.join(REPO, "data"))
    g = {}
    for name, settings in G_KNOBS.items():
        metrics, losses = _mini_recall(dev, mini, 1818, **settings)
        g[name] = {"settings": settings, "metrics": metrics, "losses": losses,
                   "in_band": RECALL_BAND[0] <= metrics["Recall"] <= RECALL_BAND[1]}
    out["G_under_knobs"] = g
    print(f"[path L] G at seed 1818 under each knob: {json.dumps(g)}")
    return out


def _http_get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# the port's serve_bench at path M: requests, client threads, and the yelp
# shape's random index beside E's exported one
BENCH_REQUESTS, BENCH_CLIENTS = 2000, 4
BENCH_SYNTHETIC = f"synthetic:{YELP['user_num']},{YELP['item_num']},64"


def _serve_bench(index: str) -> dict:
    """``python -m diffmm_tpu_torch.tools.serve_bench`` on the card against
    ``index`` (a path or ``synthetic:U,I,d``): its JSON line."""
    cmd = [sys.executable, "-m", "diffmm_tpu_torch.tools.serve_bench", index, "--requests",
           str(BENCH_REQUESTS), "--clients", str(BENCH_CLIENTS), "--k", "20"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"M serve_bench {index}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["wall_s"] = time.perf_counter() - t0
    check(out["requests"] == BENCH_REQUESTS and out["device"] == "cuda"
          and out["p99_ms"] >= out["p95_ms"] >= out["p50_ms"] > 0 and out["throughput_rps"] > 0,
          f"M serve_bench {index}: {out}")
    return out


def _approx_checks(dev, index, users: list, base_url_of) -> dict:
    """``recommend(approx=True)`` against ``approx=False`` on the card (ids
    equal, scores bitwise) at several k and both mask modes, and 20
    requests to an ``--approx`` server, each equal to a direct
    ``approx=True`` call."""
    import torch

    from diffmm_tpu_torch.eval import serving

    batch = torch.tensor(users, dtype=torch.int32, device=dev)
    same = []
    for k in (1, 20, 100):
        for mask_seen in (True, False):
            exact = serving.recommend(index, batch, k, mask_seen)
            approx = serving.recommend(index, batch, k, mask_seen, approx=True)
            same.append(torch.equal(exact[0], approx[0]) and torch.equal(exact[1], approx[1]))
    served = []
    with base_url_of(approx=True) as base:
        for u in users[:20]:
            code, body = _http_get(base + f"/recommend?user={u}&k=20")
            ids, scores = serving.recommend(index, torch.tensor([u], dtype=torch.int32, device=dev), 20,
                                            approx=True)
            served.append(code == 200 and body["items"] == ids[0].tolist() and body["scores"] == scores[0].tolist())
    rec = {"recommend_bitwise_exact": all(same), "cases": len(same), "served_equal_direct": served.count(True)}
    check(all(same), f"M: recommend(approx=True) differs from approx=False: {same}")
    check(all(served) and len(served) == 20, f"M: --approx server answers differ from direct calls: {served}")
    return rec


def phase_path_m(dev, coach_e, report_dir: str) -> dict:
    """Path M: path E's index exported, loaded onto the card and served over
    HTTP on 127.0.0.1 (``eval/serve_http.py``, warmup k=20) in a thread:
    /health, the error paths, and 200 single-user ``/recommend?k=20``
    requests, each equal to a direct ``recommend`` (ids, scores bitwise);
    host-clock latencies of the requests (the first one, on a fresh server
    thread, apart) and of the direct calls (each ending in its host read).
    Then ``approx`` (``_approx_checks``), and the port's serve_bench as a
    subprocess on the card against the exported index and against a random
    index at the yelp shape."""
    import contextlib
    import threading

    import numpy as np
    import torch

    from diffmm_tpu_torch.eval import serve_http, serving

    path = os.path.join(report_dir, "index_E.npz")
    serving.save_index(serving.build_index(coach_e), path)
    index = serving.load_index(path)  # onto the card
    check(index.u_final.device.type == "cuda", "M: the index is not on the card")

    @contextlib.contextmanager
    def serving_at(**kwargs):
        """A server over ``index`` on a free port in a thread, shut down and
        joined on leaving."""
        srv = serve_http.make_server(index, "127.0.0.1", 0, warmup_ks=[20], **kwargs)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            yield f"http://127.0.0.1:{srv.server_address[1]}"
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join()
    U, I = index.u_final.shape[0], index.i_final.shape[0]
    gen = torch.Generator().manual_seed(20)
    users = torch.randint(0, U, (200,), generator=gen).tolist()
    http_s, direct_s, same = [], [], []
    with serving_at() as base:
        health = _http_get(base + "/health")
        errors = [_http_get(base + q)[0] for q in
                  ("/recommend", f"/recommend?user={U}&k=20", "/recommend?user=1&k=0", "/nope")]
        for u in users:
            t0 = time.perf_counter()
            code, body = _http_get(base + f"/recommend?user={u}&k=20")
            http_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ids, scores = serving.recommend(index, torch.tensor([u], dtype=torch.int32, device=dev), 20)
            ids, scores = ids[0].tolist(), scores[0].tolist()
            direct_s.append(time.perf_counter() - t0)
            same.append(code == 200 and body["items"] == ids and body["scores"] == scores)
    pct = lambda xs, q: float(np.percentile(np.asarray(xs) * 1e3, q))  # noqa: E731
    rec = {
        "index": [U, I],
        "health": health[1],
        "error_codes": errors,
        "requests": len(users),
        "all_equal_direct": all(same),
        "first_request_ms": http_s[0] * 1e3,
        "http_ms": {"p50": pct(http_s[1:], 50), "p99": pct(http_s[1:], 99)},
        "direct_ms": {"p50": pct(direct_s, 50), "p99": pct(direct_s, 99)},
    }
    print(f"[path M] latency: {json.dumps({k: rec[k] for k in ('first_request_ms', 'http_ms', 'direct_ms')})}")
    check(health[0] == 200 and health[1] == {"status": "ok", "users": U, "items": I}, f"M health {health}")
    check(errors == [400, 400, 400, 404], f"M error codes {errors}")
    check(all(same), f"M: {same.count(False)} responses differ from the direct call")
    rec["approx"] = _approx_checks(dev, index, users, serving_at)
    rec["serve_bench"] = {"E_index": _serve_bench(path), BENCH_SYNTHETIC: _serve_bench(BENCH_SYNTHETIC)}
    os.remove(path)
    for name, out in rec["serve_bench"].items():
        print(f"[path M] serve_bench {name} ({out['users']} x {out['items']}): p50 {out['p50_ms']} ms, "
              f"p95 {out['p95_ms']} ms, p99 {out['p99_ms']} ms, {out['throughput_rps']} requests/s")
    print(f"[path M] {json.dumps(rec)}")
    return rec


# ------------------------------------------------------- Q: the sweep tool
# path Q's reused-Coach sweeps: a hyper the captured steps read as a float,
# a key of the rebuild's graphs, and the learning rate (device scalars made
# every epoch); and the forked sweep of a structural knob
Q_SWEEPS = (("residual_weight", [0.5, 0.2]), ("sampling_step", [0, 1]), ("train.lr", [0.001, 0.003]))
Q_FORKED = ("hyper.steps", [5, 3])


def _recorded(coach, losses: list, seconds: list) -> None:
    """Wrap ``coach``'s ``train_epoch`` and ``run``: each epoch's losses go
    to ``losses``, each run's wall seconds (its captures and eval
    included) to ``seconds``."""
    train_epoch, run = coach.train_epoch, coach.run

    def record_epoch(epoch, fence=False):
        losses.append(train_epoch(epoch, fence))
        return losses[-1]

    def timed_run(*args, **kwargs):
        t0 = time.perf_counter()
        best = run(*args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return best

    coach.train_epoch, coach.run = record_epoch, timed_run


def _q_reused_vs_fresh(dev, cfg, host, param: str, values: list) -> dict:
    """``_sweep_one`` of ``param`` over ``values``, one epoch each, on one
    Coach (reset before the second value) against one fresh Coach a value:
    rows (best metrics), epoch losses and the last value's parameters
    bitwise equal; the two values' losses differ (the value reached the
    steps)."""
    import copy

    import torch

    from diffmm_tpu_torch.tools import sweep
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.train.optim import tree_leaves
    from diffmm_tpu_torch.utils.logging import NullLog

    reused_cfg = copy.deepcopy(cfg)
    reused = Coach(reused_cfg, host, device=dev, log=NullLog())
    losses, seconds = {"reused": [], "fresh": []}, {"reused": [], "fresh": []}
    _recorded(reused, losses["reused"], seconds["reused"])
    rows = sweep._sweep_one(reused, reused_cfg, NullLog(), param, values, epochs=1, fresh=False)
    fresh_rows = []
    for value in values:
        fresh_cfg = copy.deepcopy(cfg)
        obj, key = sweep._resolve(fresh_cfg, param)
        setattr(obj, key, value)
        fresh = Coach(fresh_cfg, host, device=dev, log=NullLog())
        _recorded(fresh, losses["fresh"], seconds["fresh"])
        fresh_rows.append({param: value, **fresh.run(epochs=1)})
    leaves = lambda c: tree_leaves([c.gcn_params, c.dn_params, c.gcn_opt_state.mu])  # noqa: E731
    rec = {"values": values, "rows": rows, "rows_equal_fresh": rows == fresh_rows,
           "losses_equal_fresh": losses["reused"] == losses["fresh"],
           "last_state_bitwise": all(torch.equal(a, b) for a, b in zip(leaves(reused), leaves(fresh))),
           "losses_differ_by_value": losses["reused"][0] != losses["reused"][1],
           "run_s": seconds}
    check(rec["rows_equal_fresh"] and rec["losses_equal_fresh"] and rec["last_state_bitwise"]
          and rec["losses_differ_by_value"],
          f"Q: a reused-Coach sweep of {param} differs from fresh Coaches: {rec} (fresh rows {fresh_rows}, "
          f"losses {losses})")
    return rec


def _sweep_cli(report_dir: str, *args) -> dict:
    """``python -m diffmm_tpu_torch.tools.sweep`` on the card at path Q's
    configuration (B's: data/tiktok_mini, conf/test.toml, batch 256), one
    epoch: the JSON it writes, and its seconds."""
    out = os.path.join(report_dir, "sweep_q.json")
    cmd = [sys.executable, "-m", "diffmm_tpu_torch.tools.sweep", "-c", os.path.join(REPO, "conf", "test.toml"),
           "--epochs", "1", "--set", "data.name=tiktok_mini", "--set", "train.batch=256",
           "--data-root", os.path.join(REPO, "data"), "--out", out, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"Q: sweep {args}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    with open(out) as fh:
        doc = json.load(fh)
    os.remove(out)
    return {"doc": doc, "seconds": seconds}


def phase_path_q(dev, report_dir: str) -> dict:
    """Path Q: the port's sweep tool on the card at path B's configuration
    (dense form, full width). Each of Q_SWEEPS on a reused Coach against
    fresh Coaches (``_q_reused_vs_fresh``), with every kernel counter set to
    0 just before and read just after (K1-K4 launched, the unfused K4 not);
    a first fresh Coach's first epoch (its graphs captured) beside its
    second; then a ``--forked`` sweep of Q_FORKED, whose two rows each
    equal a ``--run-once`` child of that value."""
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import NullLog

    cfg, host = _tiktok_mini(sparse=False)
    coach = Coach(cfg, host, device=dev, log=NullLog())
    epoch_s = []
    for epoch in range(2):
        t0 = time.perf_counter()
        coach.train_epoch(epoch, fence=True)
        epoch_s.append(time.perf_counter() - t0)
    check(coach.dense_graphs, "Q: not the dense form")
    del coach
    _zero_counters()
    sweeps = {param: _q_reused_vs_fresh(dev, cfg, host, param, values) for param, values in Q_SWEEPS}
    launches = {k: v for counts in _counters() for k, v in counts.items()}
    check(all(launches[k] > 0 for k in ("spmm_dual", K2_ENTRY, "denoise_layer2", "segsum"))
          and launches["segsum_unfused"] == 0, f"Q launches {launches}")
    param, values = Q_FORKED
    forked = _sweep_cli(report_dir, "--forked", "--param", param, "--values", ",".join(map(str, values)))
    once = [_sweep_cli(report_dir, "--run-once", "--set", f"{param}={v}") for v in values]
    rows = forked["doc"]["results"]
    rows_equal = [{k: v for k, v in row.items() if k != param} == o["doc"] for row, o in zip(rows, once)]
    rec = {"first_epochs_s": epoch_s, "sweeps": sweeps, "launches": launches,
           "forked": {"param": param, "rows": rows, "rows_equal_run_once": rows_equal,
                      "seconds": forked["seconds"], "run_once_seconds": [o["seconds"] for o in once]}}
    print(f"[path Q] first fresh Coach: epoch 0 {epoch_s[0]:.4f} s (graphs captured), epoch 1 {epoch_s[1]:.4f} s; "
          + "; ".join(f"{p}: runs {r['run_s']}" for p, r in sweeps.items())
          + f"; forked {forked['seconds']:.1f} s, run-once children {rec['forked']['run_once_seconds']}")
    print(f"[path Q] {json.dumps(rec)}")
    check([row[param] for row in rows] == values and all("error" not in row for row in rows) and all(rows_equal),
          f"Q: forked sweep {rows} against run-once children {[o['doc'] for o in once]}")
    return rec


# ------------------------------------------------------- S: the web-scale configuration
# The JAX tool's sparse settings (tools/bigshard_demo.py:60-77, its docstring's
# command): 200,000 x 100,000 at density 5e-5 (about 1.0 M train edges), two
# modalities with 32-wide features, latdim 64, one hidden layer of 64, 2
# diffusion steps, batch 512, seed 1 for the data and the Coach
S_SHAPE = {"user_num": 200_000, "item_num": 100_000, "density": 5e-5, "modalities": ["image", "text"],
           "feat_dims": [32, 32]}
# the JAX docstring's two commands, run by the port's tool on gloo ranks
S_DEMOS = {"dense": [], "sparse": ["--form", "sparse", "--users", "200000", "--items", "100000",
                                   "--density", "5e-5", "--batch", "512", "--denoise-dim", "[64]"]}
# The reference's diffusion-loss accounting (Main.py:174-185; JAX
# diffmm_tpu/train/steps.py:249): acc = (acc + losses) / max(sum(losses),
# 1e-12) per block, so acc grows by 1 / sum(losses) a block wherever a
# block's losses sum below 1, and over S's 391 blocks it overflows f32 to
# inf, in the JAX package's own diffusion_epoch as here (tests/
# test_torch_train_diffusion.py::test_diffusion_accumulator_overflows_as_jax).
# Only the logged value overflows: the step's gradient divides by the
# block's own detached sum. S checks those two losses are not NaN, and the
# blocks' own losses (their sums' range, the blocks below 1, the last
# block's) and the trained parameters finite.
S_OVERFLOWING = ("image loss", "text loss")
S_ROW = re.compile(r"^  (?P<label>.+?)\s+global\s+[\d.]+ MiB\s+per-device\s+[\d.]+ MiB\s+x(?P<f>\d+)\s+"
                   r"\((?P<g>\d+) / (?P<l>\d+) bytes\)$")


def _s_config():
    from diffmm_tpu_torch.config import Config

    cfg = Config()
    cfg.base.latdim = 64
    cfg.base.denoise_dim = "[64]"
    cfg.base.seed = 1
    cfg.hyper.steps = 2
    cfg.train.graph_form = "sparse"
    cfg.train.batch = cfg.train.test_batch = 512
    return cfg


def _s_k4_cases(coach) -> dict:
    """K4 on S (a)'s own graphs after its epoch: the train graph's user
    direction (200,000 segments over the 100,000 x 64 item table) and item
    direction (100,000 segments over the 200,000 x 64 user table), the
    rebuilt graphs' stacked user direction (both modalities, one launch)
    and the first rebuilt graph's item direction; then a hub cut into
    256-edge pieces at S's shape: the train edge count over 100,000 item
    segments, one of them holding 198,000 edges (99% of the users; yelp's
    rebuilt hub holds 38,389 of 38,403), over the user table. Tables drawn
    from a stream of their own; each case as :func:`_k4_case` holds it."""
    import torch

    from diffmm_tpu_torch.ops.kernels import segsum as sg

    dev = coach.device
    adj, modal = coach.data.adj, coach.modal_adjs
    gen = torch.Generator(device=dev).manual_seed(14)
    nnz = adj.ui_cols.numel()
    hub_ids = hub_segment_ids(gen, adj.item_num, nnz, 20, adj.user_num * 99 // 100, dev)
    hub_offsets = sg.segment_offsets(hub_ids, adj.item_num)
    hub_src = torch.randint(0, adj.user_num, (nnz,), generator=gen, device=dev).to(torch.int32)
    hub_src[int(hub_offsets[-1]):] = adj.user_num  # the pads' index: one past the table
    out = {}
    for case, n_rows, src, offsets in (
            ("user", adj.item_num, adj.ui_cols, adj.ui_offsets),
            ("item", adj.user_num, adj.iu_cols, adj.iu_offsets),
            ("stacked", adj.item_num, [m.ui_cols for m in modal], modal[0].ui_offsets),
            ("modal_item", adj.user_num, modal[0].iu_cols, modal[0].iu_offsets),
            ("item_hub", adj.user_num, hub_src, hub_offsets)):
        srcs = [src] if isinstance(src, torch.Tensor) else list(src)
        tables = torch.randn((len(srcs), n_rows, 64), generator=gen, device=dev)
        table, arg = (tables[0], srcs[0]) if len(srcs) == 1 else (tables, srcs)
        rec = _k4_case(table, arg, offsets, iters=20)
        check(rec["ok"], f"S K4 {case}: {rec}")
        out[case] = rec
        print(f"[path S] K4 {case}: {json.dumps(rec)}")
    return out


def _s_one_card(dev, report_dir: str) -> dict:
    """(a) One fenced sparse epoch and its eval at 200,000 x 100,000 on the
    card through the plain Coach (``drive_training``: every counter set to
    0 just before, read just after), the no-O(U·I) walk over the Coach
    after both, and its peak below U·I bytes. The logged diffusion losses
    may overflow (``S_OVERFLOWING``), so the diffusion blocks' own losses,
    which nothing accumulates, are read instead (the last block's, the
    smallest and largest block sum, the blocks summing below 1: copies the
    diffusion step writes, captured with it) and must be finite and
    positive, as must the trained parameters. Then K4 on the Coach's graphs
    (:func:`_s_k4_cases`), and a profile of one more rebuild (its device
    time by kernel, its idle share): S runs last of the host-clock paths in
    this process."""
    import torch

    from diffmm_tpu_torch.data.membership import TrainCSR
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.ops.kernels.denoise_mlp import denoise_form
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.optim import tree_leaves
    from diffmm_tpu_torch.utils.contracts import assert_no_ui_arrays

    cfg = _s_config()
    t0 = time.perf_counter()
    host = make_synthetic_host_data(cfg, seed=1, **S_SHAPE)
    data_s = time.perf_counter() - t0
    U, I = host.user_num, host.item_num
    last = torch.full((len(S_SHAPE["modalities"]),), float("nan"), device=dev)
    sums = torch.tensor([math.inf, -math.inf], device=dev)  # the smallest and largest block sum
    below_one = torch.zeros((), dtype=torch.int32, device=dev)  # blocks whose sum grows the accumulator
    block = steps.diffusion_block

    def recorded(*args, **kwargs):
        losses = block(*args, **kwargs)
        total = losses.sum()
        last.copy_(losses)
        sums.copy_(torch.stack([torch.minimum(sums[0], total), torch.maximum(sums[1], total)]))
        below_one.add_((total < 1).to(torch.int32))
        return losses

    steps.diffusion_block = recorded
    rec, coach = drive_training(dev, cfg, host, "S", epochs=1, overflowing=S_OVERFLOWING)
    steps.diffusion_block = block
    rec.update({"last_diffusion_block_losses": last.tolist(), "diffusion_block_sum_range": sums.tolist(),
                "diffusion_blocks_below_one": int(below_one)})
    check(all(math.isfinite(v) and v > 0 for v in rec["last_diffusion_block_losses"] + rec[
        "diffusion_block_sum_range"]), f"S: the diffusion blocks' own losses {rec['last_diffusion_block_losses']}, "
          f"sums {rec['diffusion_block_sum_range']}")
    params = tree_leaves(coach.gcn_params) + [t for p in coach.dn_params for t in tree_leaves(p)]
    check(all(bool(torch.isfinite(t).all()) for t in params), "S: non-finite parameters after the epoch")
    store = coach.data.train_store
    check(isinstance(store, TrainCSR) and rec["graph_form"] == "sparse", f"S form {rec['graph_form']}")
    rec["arrays_walked"] = assert_no_ui_arrays(vars(coach), U, I, "S coach")
    check(host._train_dense is None, "S: the host built its dense (U, I) matrix")
    own_peak = rec["peak_mem_bytes"] - (rec["held_at_start_bytes"] - rec["coach_bytes"])
    check(rec["peak_mem_bytes"] < U * I and own_peak < U * I,
          f"S: peak {rec['peak_mem_bytes']} (own {own_peak}) bytes, not below U·I = {U * I}")
    csr_bytes = sum(x.nbytes for x in (store.cols, store.offsets, store.degrees))
    rec.update({"data_s": data_s, "own_peak_bytes": own_peak, "ui_bytes": U * I, "csr_store_bytes": csr_bytes,
                "dense_store_gib": U * I / 2**30, "store_factor": U * I / csr_bytes,
                "test_users": int(host.test_users.shape[0])})
    # the kernel forms of the rebuild's launches, by their contraction depths
    hidden = coach.dn_params[0]["out_layers"][0]["w"].shape[0]
    rec["denoise_forms"] = {"denoise_layer1": denoise_form(I), "denoise_layer2": denoise_form(hidden)}
    check(rec["denoise_forms"]["denoise_layer2"] == "strip" and rec["launches"]["denoise_layer2"] > 0,
          f"S: K3 at hidden {hidden} ran {rec['launches']['denoise_layer2']} launches in the "
          f"{rec['denoise_forms']['denoise_layer2']} form, not the strip form")
    print(f"[path S] (a) {json.dumps({k: v for k, v in rec.items() if k != 'graphs'})}")
    rec["k4"] = _s_k4_cases(coach)
    rec["profile_rebuild"] = phase_profile(coach.rebuild_graphs, "S_rebuild", report_dir)
    del coach
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _s_demo(report_dir: str, form: str) -> dict:
    """(b) The port's bigshard_demo, one form, in a subprocess of gloo ranks
    on the card: its lines parsed, its ok line, the dense table's x2
    factors (train_store included) with the bytes behind them, each rank's
    peak and kernel launches."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "diffmm_tpu_torch.tools.bigshard_demo", *S_DEMOS[form]],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    with open(os.path.join(report_dir, f"bigshard_{form}.log"), "w") as fh:
        fh.write(proc.stdout + "\n--- stderr\n" + proc.stderr)
    check(proc.returncode == 0, f"S: bigshard_demo --form {form} exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    ok_line = "bigshard demo ok" if form == "dense" else "bigshard sparse demo ok"
    check(ok_line in lines, f"S: no {ok_line!r} line")
    peaks = [int(m.group(1)) for m in (re.match(r"^rank \d+ peak card memory: (\d+) bytes$", x) for x in lines) if m]
    launches = [json.loads(x.split(": ", 1)[1]) for x in lines if re.match(r"^rank \d+ kernel launches: ", x)]
    check(len(peaks) == len(launches) == 8 and all(p > 0 for p in peaks), f"S {form}: rank lines {peaks}")
    timed = {m.group(1): float(m.group(2)) for m in (re.match(r"^(.+?): (\d+\.\d)s \(", x) for x in lines) if m}
    rec = {"seconds": seconds, "peak_bytes": peaks, "launches": {k: sum(r[k] for r in launches) for k in launches[0]},
           "block_s": timed, "lines": [x for x in lines if not x.startswith("rank ") and " - " not in x[:20]]}
    if form == "dense":
        rows = [S_ROW.match(x).groupdict() for x in lines if S_ROW.match(x)]
        check(len(rows) == 5 and all(r["f"] == "2" and int(r["g"]) == 2 * int(r["l"]) for r in rows),
              f"S: the dense table's factors {rows}")
        rec["rows"] = rows
        check(rec["launches"]["spmm_dual"] > 0, f"S dense: K1 launched {rec['launches']}")
    else:
        check(rec["launches"]["segsum"] > 0 and rec["launches"]["denoise_layer2"] > 0,
              f"S sparse: launches {rec['launches']}")
        check(any("membership store:" in x for x in lines), "S sparse: no membership store line")
    print(f"[path S] (b) {form}: {json.dumps(rec)}")
    return rec


def phase_path_s(dev, report_dir: str) -> dict:
    """Path S: the web-scale configuration, (a) one sparse epoch on one card,
    (b) the bigshard demo's two commands on gloo ranks."""
    t0 = time.perf_counter()
    rec = {"one_card": _s_one_card(dev, report_dir)}
    rec["demo"] = {form: _s_demo(report_dir, form) for form in S_DEMOS}
    rec["seconds"] = time.perf_counter() - t0
    print(f"[path S] {rec['seconds']:.1f} s")
    return rec


# ------------------------------------------------------- C1, graphs, H, resume
def _snapshot(coach):
    """A host copy of a Coach's training state (what a checkpoint holds)."""
    from diffmm_tpu_torch.utils.checkpoint import rng_state_to_json, to_host

    return to_host(coach._ckpt_arrays()), {
        "gcn_count": coach.gcn_opt_state.count, "dn_counts": [s.count for s in coach.dn_opt_states],
        "np_rng": rng_state_to_json(coach.np_rng), "best_snapshot_epoch": -1,
    }


def _state(coach) -> list:
    """Copies of a Coach's whole parameters, Adam moments, edge buffers and
    generator state (on a mesh gathered over the model axis: every rank
    calls it)."""
    from diffmm_tpu_torch.train.optim import tree_leaves

    w = coach._whole(coach.gcn_params, coach.dn_params, coach.gcn_opt_state, coach.dn_opt_states)
    out = tree_leaves(w["gcn_params"]) + tree_leaves(w["dn_params"]) + list(coach.edge_buffers)
    for s in (w["gcn_opt_state"], *w["dn_opt_states"]):
        out += s.mu + s.nu
    return [t.clone() for t in out] + [coach.generator.get_state()]


def _bitwise(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_c1(dev, coach_e, coach_f, host_e, losses_e) -> dict:
    """C1: the joint step repeats bit for bit on the card. Two joint_blocks
    from one saved state (parameters, moments, generator) and one block of
    interactions, dense at E's shape and sparse at F's: metrics, updated
    parameters and moments, bitwise. And a second fresh Coach at E trains
    path E's two epochs to the same losses, bitwise."""
    import torch

    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.coach import Coach

    rec = {}
    for label, coach in (("E", coach_e), ("F", coach_f)):
        arrays, aux = _snapshot(coach)
        B = coach.config.train.batch
        gen = torch.Generator(device=dev).manual_seed(6)
        pick = torch.randint(0, coach.host.nnz, (B,), generator=gen, device=dev)
        block = (coach.data.train_rows[pick], coach.data.train_cols[pick],
                 torch.randint(0, coach.host.item_num, (B,), generator=gen, device=dev).to(torch.int32))
        runs = []
        for _ in range(2):
            coach._load_state(arrays, aux)
            metrics = steps.joint_block(
                coach.gcn_params, coach.gcn_opt_state, coach.data.adj, coach.modal_adjs,
                coach.data.raw_feats, *block, 1e-3, coach.hp(), coach.config.base.cl_method,
                coach.config.train.segsum_compute, generator=coach.generator,
            )
            torch.cuda.synchronize()
            runs.append([metrics.clone(), *_state(coach)])
        same = _bitwise(*runs)
        check(same, f"C1: two {label} joint_blocks from one state differ")
        coach._load_state(arrays, aux)
        rec[f"joint_block_bitwise_{label}"] = same
        rec[f"joint_block_metrics_{label}"] = runs[0][0].tolist()
    cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
    again = Coach(cfg, host_e, device=dev)
    losses = [again.train_epoch(e, fence=True) for e in range(2)]
    check(losses == losses_e, f"C1: a fresh E Coach's losses {losses} vs path E's {losses_e}")
    rec["fresh_coach_epoch_losses_equal"] = True
    rec["epoch1_losses"] = [e["Loss"] for e in losses_e]
    print(f"[C1] {json.dumps(rec)}")
    return rec


def _replay_vs_eager(coach, phase: str) -> bool:
    """One block of ``phase`` replayed from its graph and run eagerly, each
    from the Coach's saved state with the phase's accumulators or tables
    zeroed: parameters, moments, generator and outputs bitwise."""
    import torch

    graph = coach.graphs.find(phase)[0]
    inputs = [x.clone() for x in graph.inputs]
    outputs = [b for key, b in coach.graphs._buffers.items()
               if key[0] in ("diffusion_acc", "joint_acc", "rebuild_table")]
    arrays, aux = _snapshot(coach)
    results = []
    for run in (graph, graph.step):
        coach._load_state(arrays, aux)
        for buf in outputs:
            buf.zero_()
        run(*inputs)
        torch.cuda.synchronize()
        results.append(_state(coach) + [b.clone() for b in outputs])
    coach._load_state(arrays, aux)
    return _bitwise(*results)


def phase_graphs(coach_e, coach_f) -> dict:
    """Each phase's graph replay against its eager step on E and F."""
    rec = {}
    for label, coach in (("E", coach_e), ("F", coach_f)):
        for phase in ("joint", "diffusion", "rebuild"):
            same = _replay_vs_eager(coach, phase)
            check(same, f"graph replay vs eager: {label} {phase} differ")
            rec[f"{label}_{phase}"] = same
    print(f"[graphs] replay == eager: {json.dumps(rec)}")
    return rec


def no_sync_epoch(coach, epoch: int) -> float:
    """One epoch of a Coach whose graphs are captured, its device part run
    under ``torch.cuda.set_sync_debug_mode("error")``: a host sync in it
    raises. Returns the epoch's wall time (its tables uploaded before, its
    results read after)."""
    import torch

    (tables,) = coach._epoch_tables(epoch, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")  # a sync raises, and the run fails
    modal_acc, joint_acc = coach._epoch_on_device(tables)
    torch.cuda.set_sync_debug_mode("default")
    result = coach._epoch_result(joint_acc.cpu().numpy(), modal_acc.cpu().numpy())
    wall = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in result.values()), f"no-sync epoch losses {result}")
    return wall


def phase_path_h(dev, host) -> tuple[dict, object]:
    """Path H: E's data with train.epoch_scan=2 and tstEpoch=1 through
    ``Coach.run(epochs=2)`` (one fused chunk, evals on the card), with every
    kernel counter set to 0 just before and read just after, held bitwise
    against a twin Coach's ``run`` of single epochs. Returns the record and
    the twin (two epochs in, for the resume check)."""
    import torch

    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.train.optim import tree_leaves

    def coach_for(scan):
        cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
        cfg.train.epoch_scan, cfg.train.tstEpoch = scan, 1
        return Coach(cfg, host, device=dev)

    fused, twin = coach_for(2), coach_for(1)
    chunks, singles, evals = [], [], []
    train_fused, train_epoch, test_epoch = fused.train_epochs_fused, twin.train_epoch, twin.test_epoch

    def timed_chunk(e, n, split=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_fused(e, n, split)  # ends in a host read of the chunk's results
        chunks.append({"epochs": [e, e + n], "wall_s": time.perf_counter() - t0, "losses": out[0],
                       "evals": out[1]})
        return out

    def single(e, fence=False):
        singles.append(train_epoch(e, fence))
        return singles[-1]

    def evaluated(split="test", embeddings=None):
        evals.append(test_epoch(split, embeddings))
        return evals[-1]

    fused.train_epochs_fused, twin.train_epoch, twin.test_epoch = timed_chunk, single, evaluated
    _zero_counters()
    best_f = fused.run(epochs=2)
    launches = {k: v for counts in _counters() for k, v in counts.items()}
    t0 = time.perf_counter()
    best_t = twin.run(epochs=2)
    twin_s = time.perf_counter() - t0
    fused.train_epochs_fused, twin.train_epoch, twin.test_epoch = train_fused, train_epoch, test_epoch
    check(len(chunks) == 1, f"H ran {len(chunks)} fused chunks, want 1")
    snap_f, snap_t = fused.best_snapshot, twin.best_snapshot
    same = {
        "losses": chunks[0]["losses"] == singles,
        "evals": chunks[0]["evals"] == evals,
        "best": best_f == best_t,
        "best_snapshot": snap_f["epoch"] == snap_t["epoch"] and _bitwise(
            tree_leaves(snap_f["gcn_params"]) + snap_f["edge_buffers"],
            tree_leaves(snap_t["gcn_params"]) + snap_t["edge_buffers"]),
        "state": _bitwise(_state(fused), _state(twin)),
    }
    check(all(same.values()), f"H fused vs single epochs: {same}")
    n_joint = -(-host.nnz // fused.config.train.batch)
    want = {k: 2 * v * n_joint for k, v in joint_step_launches(True, fused.n_modal, 0).items()}
    check(all(launches[k] >= v for k, v in want.items()) and launches["segsum_unfused"] == 0,
          f"H launches {launches}, want at least {want} and no unfused K4")
    rec = {"bitwise": same, "best": best_f, "chunks": chunks, "single_losses": singles,
           "single_epochs_run_s": twin_s, "launches": launches,
           "graphs": {key[0]: {"replays": g.replays, "launches_a_replay": g.launches}
                      for key, g in fused.graphs.graphs.items()},
           "no_sync_epoch_s": no_sync_epoch(fused, 2)}
    print(f"[path H] {json.dumps(rec)}")
    return rec, twin


def phase_resume(dev, host, twin, want_loss: dict, report_dir: str) -> dict:
    """Save after epoch 0, restore into a new Coach, train epoch 1: equal
    bitwise to the twin's uninterrupted epoch 1 (losses, parameters,
    moments, edge buffers, generator)."""
    import shutil

    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.train.coach import Coach

    ck = os.path.join(report_dir, "resume_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    first = Coach(load_config(os.path.join(REPO, "conf", "test.toml")), host, device=dev,
                  checkpoint_dir=ck)
    first.total_epochs = 2
    first.train_epoch(0)
    first.save_checkpoint(0, {})
    del first
    second = Coach(load_config(os.path.join(REPO, "conf", "test.toml")), host, device=dev,
                   checkpoint_dir=ck)
    second.total_epochs = 2
    check(second.restore_checkpoint()["epoch"] == 0, "resume: no checkpoint at epoch 0")
    loss = second.train_epoch(1)
    same = loss == want_loss and _bitwise(_state(second), _state(twin))
    check(same, f"resume: epoch 1 after a restore ({loss}) differs from the uninterrupted run")
    shutil.rmtree(ck, ignore_errors=True)
    rec = {"bitwise": same, "epoch1_loss": loss["Loss"]}
    print(f"[resume] {json.dumps(rec)}")
    return rec


# ------------------------------------------------------- R: the measuring programs
# The JAX bench's line (bench.py:221-256): its keys, its detail's, and the
# phases both Coaches time
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {
    "headline_epoch_seconds", "headline_path", "epoch_seconds_median_steady", "fused_epoch_seconds_median",
    "epoch_seconds_all", "phase_seconds_median_steady", "phase_seconds_fenced", "joint_hbm_roofline_fraction",
    "eval_seconds_median", "sparse_epoch_seconds_median", "sparse_fused_epoch_seconds_median",
    "sparse_train_store", "baseline", "baseline_epoch_seconds", "device",
}
BENCH_PHASES = {"neg_sampling", "diffusion", "rebuild", "joint"}
# path R's bench counts: three single epochs (two steady), fused chunks of two
R_BENCH_ENV = {"BENCH_EPOCHS": "3", "BENCH_FUSED": "2", "BENCH_SPARSE_FUSED": "2"}
# the JAX tools' JSON keys: tools/scale_probe.py:58-66, 82-85 (no --scan);
# tools/store_ab_probe.py:99-108; tools/joint_profile.py:148-174 (its
# spmm_scatter_* rows time the XLA scatter, which the port does not have)
SCALE_KEYS = {"config", "set", "backend", "shape", "nnz", "graph_form", "train_store", "epoch_s_all",
              "epoch_s_median_steady"}
STORE_AB_KEYS = {"config", "backend", "scan", "fused_epoch_s", "fenced_phase_s"}
JOINT_KEYS = {"config", "backend", "graph_form", "dense_store", "inner_iters", "dispatch_overhead_ms",
              "spmm_fwd_ms", "spmm_bwd_ms", "gcn_forward_ms", "joint_nocl_ms", "joint_step_ms",
              "cl_plus_adam_ms"}
JOINT_FORM_KEYS = {"dense": {"adj_pass_roofline_ms"},
                   "sparse": {"spmm_modal_fwd_ms", "spmm_modal_bwd_ms", "sparse_pass_roofline_ms"}}
# tools/fused_overhead_probe.py's lines
OVERHEAD_LINES = {
    "upload": r"upload probe: ([\d.]+) MB in ([\d.]+)s = ([\d.]+) MB/s",
    "first_chunk": r"compile\+first chunk: ([\d.]+)s",
    "chunk": r"chunk (\d): call\(incl\. host prep\+upload\+result fetch\)=([\d.]+)s  "
             r"\+device drain=([\d.]+)s  -> ([\d.]+)s/epoch wall",
}


def _bench_times(line: dict) -> list[float]:
    """Every time of the bench's line (and its rate)."""
    d = line["detail"]
    return ([line["value"], d["headline_epoch_seconds"], d["epoch_seconds_median_steady"],
             d["fused_epoch_seconds_median"], d["eval_seconds_median"], d["sparse_epoch_seconds_median"],
             d["sparse_fused_epoch_seconds_median"], *d["epoch_seconds_all"]]
            + list(d["phase_seconds_median_steady"].values()) + list(d["phase_seconds_fenced"].values()))




def _r_bench(dev) -> dict:
    """(a) ``diffmm_tpu_torch.bench.main --synthetic tiktok`` in this
    process at R_BENCH_ENV's counts, with every kernel counter set to 0
    just before and read just after: the JAX bench's keys, every time above
    0, the CSR store on the sparse rows, the roofline fraction in (0, 1.05];
    K1 launched in the dense rows (none in the sparse), K2/K3 in both
    rebuilds, K4 in the sparse rows and in the dense rows' loss gathers."""
    import contextlib
    import io

    from diffmm_tpu_torch import bench

    saved = {k: os.environ.get(k) for k in R_BENCH_ENV}
    os.environ.update(R_BENCH_ENV)
    out, sections = io.StringIO(), {}
    _zero_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        status = bench.main(["--synthetic", "tiktok"], sections=sections)
    seconds = time.perf_counter() - t0
    launches = {k: v for counts in _counters() for k, v in counts.items()}
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k)
        else:
            os.environ[k] = v
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"[path R] bench: {json.dumps(line)}")
    d = line["detail"]
    check(status == 0 and set(line) == BENCH_KEYS and set(d) == BENCH_DETAIL_KEYS,
          f"R: bench keys {sorted(line)} / {sorted(d)}")
    check(set(d["phase_seconds_median_steady"]) == BENCH_PHASES == set(d["phase_seconds_fenced"]),
          f"R: bench phases {d['phase_seconds_median_steady']} {d['phase_seconds_fenced']}")
    times = _bench_times(line)
    check(all(isinstance(t, (int, float)) and t > 0 for t in times), f"R: bench times {times}")
    check(d["sparse_train_store"] == "csr", f"R: sparse rows' store {d['sparse_train_store']}")
    fraction = d["joint_hbm_roofline_fraction"]
    check(fraction is not None and 0 < fraction <= 1.05, f"R: roofline fraction {fraction}")
    check(line["vs_baseline"] is None and d["baseline_epoch_seconds"] is not None,
          f"R: synthetic data has no baseline ratio: {line['vs_baseline']}")
    dense, sparse = sections["dense"]["launches"], sections["sparse"]["launches"]
    want = {"dense K1": dense["spmm_dual"], "dense K2": dense[K2_ENTRY], "dense K3": dense["denoise_layer2"],
            "dense K4 (loss gathers)": dense["segsum"], "sparse K2": sparse[K2_ENTRY],
            "sparse K3": sparse["denoise_layer2"], "sparse K4": sparse["segsum"]}
    check(all(v > 0 for v in want.values()) and sparse["spmm_dual"] == 0
          and launches["segsum_unfused"] == 0 and launches == {k: dense[k] + sparse[k] for k in launches},
          f"R: bench launches {want}, sparse {sparse}, all {launches}")
    return {"line": line, "seconds": seconds, "launches": launches, "sections": sections}


def _r_sparse_bf16_fused(dev, host) -> dict:
    """(b) A sparse Coach at tiktok's shape with bf16 messages: a fused
    chunk of two epochs against a twin's two single epochs, losses and
    state (parameters, moments, edge buffers, generator) bitwise, as path H
    holds the dense form; K4 launched, K1 not."""
    import torch

    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.train.coach import Coach

    def coach():
        cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
        cfg.train.graph_form, cfg.train.segsum_compute = "sparse", "bf16"
        return Coach(cfg, host, device=dev)

    fused, twin = coach(), coach()
    check(fused.train_store_form == "csr" and not fused.dense_graphs, "R: the sparse Coach's form")
    _zero_counters()
    t0 = time.perf_counter()
    got = fused.train_epochs_fused(0, 2)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    launches = {k: v for counts in _counters() for k, v in counts.items()}
    want = [twin.train_epoch(e) for e in range(2)]
    same = {"losses": got == want, "state": _bitwise(_state(fused), _state(twin))}
    check(all(same.values()), f"R: sparse bf16 fused chunk vs single epochs: {same} {got} {want}")
    check(launches["segsum"] > 0 and launches["spmm_dual"] == 0 and launches["segsum_unfused"] == 0,
          f"R: sparse bf16 chunk launches {launches}")
    return {"bitwise": same, "losses": got, "chunk_s": chunk_s, "launches": launches}


def _r_probe(report_dir: str, label: str, module: str, *args) -> tuple[str, float]:
    """One of the port's probes in a subprocess on the card; its output goes
    to ``<report_dir>/probe_<label>.log``. Returns its stdout and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"diffmm_tpu_torch.tools.{module}", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    with open(os.path.join(report_dir, f"probe_{label}.log"), "w") as fh:
        fh.write(proc.stdout + "\n--- stderr\n" + proc.stderr)
    check(proc.returncode == 0, f"R: probe {label} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, seconds


def _json_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def _r_probes(report_dir: str) -> dict:
    """(d) Each probe once, at small counts, in a subprocess: its JSON line
    parsed, with the JAX tool's keys (fused_overhead_probe's lines by their
    patterns), and every time it prints above 0."""
    import re

    rec = {}
    out, s = _r_probe(report_dir, "scale_yelp", "scale_probe", "-c", "conf/yelp.toml", "--synthetic", "yelp",
                      "--set", "train.graph_form=sparse", "--epochs", "2")
    line = _json_line(out)
    check(set(line) == SCALE_KEYS and line["shape"] == [YELP["user_num"], YELP["item_num"]]
          and line["train_store"] == "csr" and all(t > 0 for t in line["epoch_s_all"]),
          f"R: scale_probe line {line}")
    rec["scale_probe"] = {"line": line, "seconds": s}

    out, s = _r_probe(report_dir, "store_ab", "store_ab_probe", "-c", "conf/tiktok_tuned.toml", "--synthetic",
                      "tiktok", "--fenced", "1", "--chunks", "1", "--scan", "2")
    line = _json_line(out)
    check(set(line) == STORE_AB_KEYS and set(line["fused_epoch_s"]) == {"dense", "csr"}
          and all(t > 0 for t in line["fused_epoch_s"].values())
          and all(set(ph) == BENCH_PHASES for ph in line["fenced_phase_s"].values()),
          f"R: store_ab_probe line {line}")
    rec["store_ab_probe"] = {"line": line, "seconds": s}

    out, s = _r_probe(report_dir, "fused_overhead", "fused_overhead_probe", "conf/tiktok_tuned.toml", "2",
                      "--synthetic", "tiktok")
    lines = out.strip().splitlines()
    parsed = {"upload": re.fullmatch(OVERHEAD_LINES["upload"], lines[0]),
              "first_chunk": re.fullmatch(OVERHEAD_LINES["first_chunk"], lines[1]),
              "chunks": [re.fullmatch(OVERHEAD_LINES["chunk"], x) for x in lines[2:]]}
    check(len(lines) == 5 and parsed["upload"] and parsed["first_chunk"] and all(parsed["chunks"]),
          f"R: fused_overhead_probe lines {lines}")
    line = {"upload_mb_s": float(parsed["upload"][3]), "first_chunk_s": float(parsed["first_chunk"][1]),
            "chunks": [{"call_s": float(m[2]), "drain_s": float(m[3]), "epoch_wall_s": float(m[4])}
                       for m in parsed["chunks"]]}
    check(all(c["epoch_wall_s"] > 0 for c in line["chunks"]), f"R: fused_overhead_probe {line}")
    rec["fused_overhead_probe"] = {"line": line, "seconds": s}

    for form in ("dense", "sparse"):
        sets = ["--set", "train.graph_form=sparse", "--set", "train.segsum_compute=bf16"] if form == "sparse" else []
        out, s = _r_probe(report_dir, f"joint_{form}", "joint_profile", "-c", "conf/tiktok_tuned.toml",
                          "--synthetic", "tiktok", "--inner", "8", *sets)
        line = _json_line(out)
        timed = [k for k in line if k.endswith("_ms") and k != "cl_plus_adam_ms"]
        check(set(line) == JOINT_KEYS | JOINT_FORM_KEYS[form] and line["graph_form"] == form
              and all(math.isfinite(line[k]) and line[k] > 0 for k in timed),
              f"R: joint_profile {form} line {line}")
        rec[f"joint_profile_{form}"] = {"line": line, "seconds": s}
    print(f"[path R] probes: {json.dumps(rec)}")
    return rec


def phase_path_r(dev, host, report_dir: str) -> dict:
    """Path R, the measuring programs: (a) the port's bench in this process,
    (b) a sparse bf16 fused chunk against single epochs, (c) one sparse
    diffusion and joint block with bf16 messages on the card against the
    CPU, (d) each probe in a subprocess."""
    t0 = time.perf_counter()
    rec = {"bench": _r_bench(dev)}
    rec["sparse_bf16_fused"] = _r_sparse_bf16_fused(dev, host)
    rec["train_step_sparse_bf16"] = _train_step_reference(dev, _small_config(), "sparse", compute="bf16")
    rec["probes"] = _r_probes(report_dir)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[path R] {json.dumps({k: v for k, v in rec.items() if k != 'probes'})}")
    return rec


# ------------------------------------------------------- N, O: the mesh
# Both run in spawned ranks (diffmm_tpu_torch/parallel/launch.py), so that no
# process group outlives its phase in this process; a rank that fails fails
# the run. N: NCCL at world size 1 (the card's own collectives, captured in
# the steps' graphs). O: two gloo ranks sharing the one card, eager: a
# correctness path, and none of its times is a speed figure (the ranks
# share the card and gloo copies through the host). Path O's sizes, cut from
# F's full epoch: three joint_blocks and one diffusion_block (a full F epoch
# through gloo would move tens of GB: 22 (N, 64) f32 all-reduces a joint
# step, over 300 steps). The function is held against N step by step, from
# one state and one set of draws (E's and F's blocks): a whole epoch from a
# fresh Adam state drifts further than the JAX mesh test's tolerance on the
# card (f32 products over a rank's 512 rows round otherwise than over 1,024,
# and Adam's first steps, about lr·sign(g), turn a rounding into an lr-sized
# step: measured on E's diffusion steps, 3,887 parameters off by more than
# 1e-5 after one step, 203,540 after three, the losses within 1e-6), so E's
# epoch is held rank against rank and run against run, bitwise, and its
# difference from N is recorded.
MESH_TOL = {"rel": 2e-3, "abs": 1e-5}  # tests/test_parallel.py:76-79
# P's blocks against N: the port at world size 1, the tolerance of
# tests/test_torch_model_axis.py. The losses and metrics alone cannot see a
# model-axis adjoint that doubles a gradient (Adam's first steps are about
# lr·sign(g)), so the whole first Adam moment, gathered, is held against N's
# too: each leaf's L1 sum, and its norm-wise relative error on a strided
# sample of MOMENT_SAMPLE entries (a doubled gradient reads 1.0 there).
P_TOL = {"rel": 1e-5, "abs": 1e-6}
MOMENT_SAMPLE = 4096


def _digest(tensors) -> str:
    """A hash of the tensors' bytes (for rank-to-rank and run-to-run
    bitwise checks without moving the tensors)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _close(a: float, b: float, tol: dict = MESH_TOL) -> bool:
    return math.isclose(a, b, rel_tol=tol["rel"], abs_tol=tol["abs"])


def _moments(coach, gcn: bool) -> dict:
    """The whole first Adam moment of the GCN's (``gcn``) or the denoisers'
    leaves (on a mesh gathered over the model axis: every rank calls it):
    per leaf its L1 sum and MOMENT_SAMPLE evenly spaced entries."""
    import torch

    from diffmm_tpu_torch.train.optim import tree_leaves

    w = coach._whole(gcn_state=coach.gcn_opt_state) if gcn else coach._whole(dn_states=coach.dn_opt_states)
    leaves = w["gcn_opt_state"].mu if gcn else [t for s in w["dn_opt_states"] for t in s.mu]
    out = {"l1": [], "sample": []}
    for t in tree_leaves(leaves):
        flat = t.detach().reshape(-1).double()
        n, count = flat.numel(), min(MOMENT_SAMPLE, flat.numel())
        at = torch.arange(count, device=flat.device) * (n - 1) // max(count - 1, 1)
        out["l1"].append(float(flat.abs().sum()))
        out["sample"].append(flat[at].tolist())
    return out


def _moments_vs(got: dict, want: dict) -> dict:
    """Per leaf: the L1 sums' relative difference and the sample's
    norm-wise relative error, each at its worst leaf, and whether both hold
    within P_TOL."""
    l1 = [abs(a - b) / max(b, 1e-30) for a, b in zip(got["l1"], want["l1"])]
    norm = []
    ok = len(got["l1"]) == len(want["l1"])
    for a, b, ga, wa in zip(got["sample"], want["sample"], got["l1"], want["l1"]):
        diff = math.sqrt(sum((x - y) ** 2 for x, y in zip(a, b)))
        ref = math.sqrt(sum(y * y for y in b))
        norm.append(diff / max(ref, 1e-30))
        ok = ok and diff <= P_TOL["rel"] * ref + P_TOL["abs"] and _close(ga, wa, P_TOL)
    return {"ok": ok, "leaves": len(l1), "l1_rel_max": max(l1), "sample_norm_rel_max": max(norm)}


def _blocks(coach, split, n_joint: int = 3) -> dict:
    """One diffusion_block, then ``n_joint`` joint_blocks, of a fresh
    Coach (E's or F's) with the train graph as each modality's graph, from
    one set of draws made on the card from seed 11 (users, timesteps, noise,
    the interaction blocks, the CL uniforms): the losses, the joint metrics
    summed over the ranks, the state's digest after each step, and the
    first Adam moments (:func:`_moments`) after the diffusion step and the
    first joint step (each the first step of its optimiser)."""
    import torch

    from diffmm_tpu_torch.models.gcn import project_features
    from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_
    from diffmm_tpu_torch.train import steps

    dev, host, cfg = coach.device, coach.host, coach.config
    B, M, d = cfg.train.batch, coach.n_modal, cfg.base.latdim
    coach.set_edge_buffers([coach.data.train_cols.clone() for _ in range(M)])
    gen = torch.Generator(device=dev).manual_seed(11)
    users = torch.randperm(host.user_num, generator=gen, device=dev)[:B].to(torch.int32)
    t = torch.randint(0, cfg.hyper.steps, (M, B), generator=gen, device=dev)
    noise = torch.randn((M, B, host.item_num), generator=gen, device=dev)
    rec = {"digests": [], "step_s": [], "joint_metrics": []}
    t0 = time.perf_counter()
    feats = project_features(coach.gcn_params, coach.data.raw_feats)
    losses = steps.diffusion_block(coach.schedule, coach.dn_params, coach.dn_opt_states, feats,
                                   coach.gcn_params["i_embs"], coach.data.train_store, users,
                                   torch.ones(B, device=dev), 1e-3, coach.hp(), host.item_num, t=t,
                                   noise=noise, split=split)
    rec["diffusion_losses"] = losses.tolist()
    rec["step_s"].append(time.perf_counter() - t0)
    rec["digests"].append(_digest(_state(coach)))
    rec["dn_moments"] = _moments(coach, gcn=False)
    del t, noise
    for j in range(n_joint):
        pick = torch.randint(0, host.nnz, (B,), generator=gen, device=dev)
        block = (coach.data.train_rows[pick], coach.data.train_cols[pick],
                 torch.randint(0, host.item_num, (B,), generator=gen, device=dev).to(torch.int32))
        cl = [torch.rand((host.user_num if j % 2 == 0 else host.item_num, d), generator=gen, device=dev)
              for j in range(6)]
        t0 = time.perf_counter()
        metrics = steps.joint_block(coach.gcn_params, coach.gcn_opt_state, coach.data.adj, coach.modal_adjs,
                                    coach.data.raw_feats, *block, 1e-3, coach.hp(), cfg.base.cl_method,
                                    cfg.train.segsum_compute, cl_noise=cl, split=split)
        if split is not None:
            metrics = all_reduce_sum_(metrics.contiguous(), split.world.group)
        rec["joint_metrics"].append(metrics.tolist())
        rec["step_s"].append(time.perf_counter() - t0)
        rec["digests"].append(_digest(_state(coach)))
        if j == 0:
            rec["gcn_moments"] = _moments(coach, gcn=True)
    return rec


def _k4_bound(tables, srcs, offsets) -> tuple[float, str, int]:
    """K4's bound over a call's edges (as :func:`_k4_case` counts it): the
    table rows the real edges name, their indices, the offsets and the
    output, each once, and one add per gathered element."""
    import torch

    M, R, d = tables.shape
    n, real = offsets.numel() - 1, int(offsets[-1])
    named = sum(int(torch.unique(s[:real][(s[:real] >= 0) & (s[:real] < R)]).numel()) for s in srcs)
    n_bytes = named * d * tables.element_size() + 4 * real * M + 8 * (n + 1) + 4 * n * M * d
    b, by = bound_ms(n_bytes, real * M * d, F32_FLOPS)
    return b, by, n_bytes


def _k4_mesh_cases(coach) -> dict:
    """Path N: K4's mesh form at F's shapes (the user and item directions of
    the train graph, the stacked user direction of the rebuilt graphs, the
    item direction of the first), at world size 1 under NCCL: bitwise the
    whole ``segsum_gather``; the time per rank (the slice's launch), the
    all-reduce's, the form's; the bound over the rank's slice; the library
    (``torch.sparse.mm`` over the same slice) plus the same all-reduce."""
    import torch
    import torch.distributed as dist

    from diffmm_tpu_torch.ops.kernels import segsum as sg
    from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_
    from diffmm_tpu_torch.parallel.segsum import local_offsets, sharded_segsum_gather, slice_segsum_gather

    dev, world = coach.device, dist.group.WORLD
    adj, modal = coach.data.adj, coach.modal_adjs
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for case, n_rows, src, offsets in (
            ("user", adj.item_num, adj.ui_cols, adj.ui_offsets),
            ("item", adj.user_num, adj.iu_cols, adj.iu_offsets),
            ("stacked", adj.item_num, [m.ui_cols for m in modal], modal[0].ui_offsets),
            ("modal_item", adj.user_num, modal[0].iu_cols, modal[0].iu_offsets)):
        srcs = [src] if isinstance(src, torch.Tensor) else list(src)
        tables = torch.randn((len(srcs), n_rows, 64), generator=gen, device=dev)
        table, arg = (tables[0], srcs[0]) if len(srcs) == 1 else (tables, srcs)
        nnz = srcs[0].numel()
        lo, hi = coach.edge_shard.span(nnz)
        before = dict(sg.LAUNCHES)
        got = sharded_segsum_gather(table, arg, offsets, lo, hi, world)
        launches = sg.LAUNCHES["segsum"] - before["segsum"]
        whole = sg.segsum_gather(table, arg, offsets)
        plain = sg.segsum_gather_plain(table, arg, offsets)
        frame = torch.zeros_like(got)
        local = local_offsets(offsets, lo, hi)
        b, by, n_bytes = _k4_bound(tables, [s[lo:hi] for s in srcs], local)
        allreduce_ms = time_ms(lambda: all_reduce_sum_(frame, world), 50)
        lib_ms, lib_refused = _library_ms(tables, [s[lo:hi] for s in srcs], local, 10)
        rec = {
            "shape": [offsets.numel() - 1, n_rows, nnz, len(srcs), 64], "slice": [lo, hi],
            "bitwise_whole": torch.equal(got, whole), "launches_per_call": launches,
            "max_abs_err": max_err(got, plain),
            "ms": time_ms(lambda: sharded_segsum_gather(table, arg, offsets, lo, hi, world), 50),
            "rank_ms": time_ms(lambda: slice_segsum_gather(table, arg, offsets, lo, hi), 50),
            "allreduce_ms": allreduce_ms, "allreduce_bytes": frame.numel() * 4,
            "plain_ms": time_ms(lambda: sg.segsum_gather_plain(table, arg, offsets), 5),
            "bound_ms": b, "bound_by": by, "bound_bytes": n_bytes,
            "library_ms": None if lib_ms is None else lib_ms + allreduce_ms, "library_refused": lib_refused,
        }
        rec["ok"] = rec["bitwise_whole"] and launches == 1
        check(rec["ok"], f"N K4 mesh form {case}: {rec}")
        out[case] = rec
        print(f"[path N] K4 mesh form {case}: {json.dumps(rec)}")
    return out


def mesh_path_n(report_dir: str) -> dict:
    """Path N, in one NCCL rank: E's and F's data and settings, two epochs,
    each with ``test_epoch``, on a 1x1 mesh (the steps captured with their
    collectives) against the same on a Coach without a mesh: losses,
    metrics, parameters, moments, edge buffers and generator bitwise (the
    one device's rebuild takes K2's tanh epilogue in the kernel, the mesh's
    the tanh after its partial product's sum: the same f32 add and
    ``tanhf``); the
    kernel counters set to 0 just before the mesh Coach's epoch and eval
    and read just after. K4's mesh form at F's shapes; ``recommend(mesh)``
    at model 1 bitwise the plain call; F's blocks of path O at world size 1;
    the gradient all-reduce's time a step."""
    import copy

    import torch
    import torch.distributed as dist

    from diffmm_tpu_torch.eval.serving import build_index, recommend
    from diffmm_tpu_torch.parallel import make_mesh
    from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.train.optim import tree_leaves

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(1, model_parallel=1)
    rec = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    for label, setup in (("E", _tiktok_shape), ("F", _yelp_shape)):
        cfg, host = setup()
        runs = {}
        for kind in ("plain", "mesh"):
            coach = Coach(copy.deepcopy(cfg), host, device=dev, mesh=None if kind == "plain" else mesh)
            torch.cuda.synchronize()
            _zero_counters()
            losses, metrics, walls = [], [], []
            for epoch in range(2):  # the first epoch captures; the second is steady
                coach.timer.reset()
                t0 = time.perf_counter()
                losses.append(coach.train_epoch(epoch, fence=True))
                walls.append(time.perf_counter() - t0)
                metrics.append(coach.test_epoch())
            torch.cuda.synchronize()
            launches = {k: v for counts in _counters() for k, v in counts.items()}
            runs[kind] = {"losses": losses, "metrics": metrics, "state": _state(coach), "epoch_s": walls,
                          "phases_s": dict(coach.timer.totals), "launches": launches, "coach": coach}
        p, m = runs["plain"], runs["mesh"]
        same = p["losses"] == m["losses"] and p["metrics"] == m["metrics"] and _bitwise(p["state"], m["state"])
        check(same, f"N {label}: the 1x1 mesh Coach differs from the plain one: {m['losses']} {p['losses']}")
        # path O's epoch is one from a fresh Coach: its losses and metrics
        # are set beside the first epoch's
        m["losses"], m["metrics"] = m["losses"][0], m["metrics"][0]
        coach = m["coach"]
        replays = {key[0]: g.replays for key, g in coach.graphs.graphs.items()}
        check(coach.capture_steps and replays.get("joint", 0) > 0, f"N {label}: steps not captured {replays}")
        want = ("spmm_dual",) if label == "E" else ("segsum",)
        check(all(m["launches"][k] > 0 for k in (*want, K2_MESH_ENTRY, "denoise_layer2")),
              f"N {label} launches {m['launches']}")
        n_grad = sum(t.numel() for t in tree_leaves(coach.gcn_params))
        buf = torch.zeros(n_grad, device=dev)
        rec[label] = {
            "bitwise_plain": same, "losses": m["losses"], "metrics": m["metrics"], "epoch_s": m["epoch_s"],
            "phases_s": m["phases_s"], "plain_epoch_s": p["epoch_s"], "plain_phases_s": p["phases_s"],
            "launches": m["launches"], "graph_replays": replays,
            "grad_all_reduce_ms": time_ms(lambda: all_reduce_sum_(buf, dist.group.WORLD), 50),
            "grad_all_reduce_bytes": 4 * n_grad,
        }
        if label == "E":
            index = build_index(coach)
            users = torch.arange(0, host.user_num, 97, device=dev)[:64]
            a, b = recommend(index, users, 20, True, mesh), recommend(index, users, 20, True)
            rec["recommend_model1_bitwise"] = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            check(rec["recommend_model1_bitwise"], "N: recommend(mesh) at model 1 differs from the plain call")
        else:
            rec["k4_mesh"] = _k4_mesh_cases(coach)
        del runs, coach
        gc.collect()
        fresh = Coach(copy.deepcopy(cfg), host, device=dev, mesh=mesh)
        rec[f"{label}_blocks"] = _blocks(fresh, fresh.split)
        del fresh
        print(f"[path N] {label}: {json.dumps({k: v for k, v in rec[label].items()})}")
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def _hub_cut_ids(gen, n: int, nnz: int, pads: int, hub: int, device):
    """F's rebuilt item layout with its hub (``hub`` edges) on the middle id,
    so that the hub's edges straddle the middle edge: two ranks cut it."""
    import torch

    hub_id = n // 2
    others = torch.randint(0, n - 1, (nnz - pads - hub,), generator=gen, device=device)
    others = others + (others >= hub_id).long()
    ids = torch.sort(torch.cat([others, torch.full((hub,), hub_id, device=device)]).to(torch.int32)).values
    return torch.cat([ids, torch.full((pads,), n, dtype=torch.int32, device=device)])


def _k4_mesh_checks(coach) -> dict:
    """Path O: K4's mesh form on two ranks at F's user, item, item-hub (the
    hub cut by the rank boundary) and stacked shapes, against the whole
    ``segsum_gather`` on the rank within K4's rule; and the backward of a
    ``Propagate`` on the mesh (this rank's rows of the loss, the input
    gradient summed over the ranks) against the whole one, within K4's
    rule on the backward's terms."""
    import torch
    import torch.distributed as dist

    from diffmm_tpu_torch.ops.graph import Propagate
    from diffmm_tpu_torch.ops.kernels import segsum as sg
    from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_
    from diffmm_tpu_torch.parallel.segsum import sharded_segsum_gather

    dev, world, shard = coach.device, dist.group.WORLD, coach.edge_shard
    adj, modal = coach.data.adj, coach.modal_adjs
    U, I, nnz = adj.user_num, adj.item_num, adj.ui_cols.numel()
    gen = torch.Generator(device=dev).manual_seed(7)
    rtol, atol = TOL["segsum"]
    hub_ids = _hub_cut_ids(gen, I, nnz, nnz - int(adj.ui_offsets[-1]), YELP["hub"], dev)
    hub_src = torch.randint(0, U, (nnz,), generator=gen, device=dev).to(torch.int32)
    hub_off = sg.segment_offsets(hub_ids, I)
    hub_src[int(hub_off[-1]):] = U
    lo, hi = shard.span(nnz)
    out = {"hub_cut": bool(hub_ids[lo - 1] == hub_ids[lo] == I // 2) if lo > 0 else
           bool(hub_ids[hi - 1] == hub_ids[hi] == I // 2)}
    for case, n_rows, src, offsets in (
            ("user", I, adj.ui_cols, adj.ui_offsets), ("item", U, adj.iu_cols, adj.iu_offsets),
            ("item_hub", U, hub_src, hub_off), ("stacked", I, [m.ui_cols for m in modal], modal[0].ui_offsets)):
        srcs = [src] if isinstance(src, torch.Tensor) else list(src)
        tables = torch.randn((len(srcs), n_rows, 64), generator=gen, device=dev)
        table, arg = (tables[0], srcs[0]) if len(srcs) == 1 else (tables, srcs)
        got = sharded_segsum_gather(table, arg, offsets, lo, hi, world)
        want = sg.segsum_gather(table, arg, offsets)
        scale = sg.segsum_gather(table.abs(), arg, offsets)
        out[case] = {"ok": bool(((got - want).abs() <= rtol * scale + atol).all()),
                     "max_abs_err": max_err(got, want)}
    # the backward: y = Propagate(z) over the user direction, the loss's rows
    # split over the ranks' data spans
    z = torch.randn((I, 64), generator=gen, device=dev)
    w = torch.randn((U, 64), generator=gen, device=dev)
    grads = []
    for sh in (shard, None):
        zz = z.clone().requires_grad_()
        y = Propagate.apply(zz, adj.ui_cols, adj.ui_offsets, adj.iu_cols, adj.iu_offsets, "f32", sh)
        r_lo, r_hi = coach.split.rows.span(U) if sh is not None else (0, U)
        (w[r_lo:r_hi] * y[r_lo:r_hi]).sum().backward()
        grads.append(zz.grad if sh is None else all_reduce_sum_(zz.grad.clone(), world))
    scale = sg.segsum_gather(w.abs(), adj.iu_cols, adj.iu_offsets)
    out["propagate_backward"] = {"ok": bool(((grads[0] - grads[1]).abs() <= rtol * scale + atol).all()),
                                 "max_abs_err": max_err(grads[0], grads[1])}
    check(all(v["ok"] for k, v in out.items() if k != "hub_cut") and out["hub_cut"], f"O K4 mesh form: {out}")
    return out


def _mesh_http(placed, whole, mesh) -> dict:
    """Path O: rank 0 serves ``placed`` over HTTP in two catalog shards
    (``eval/serve_http.py``) and sends 20 requests, each against a direct
    ``recommend`` on the whole index; rank 1 follows."""
    import threading

    import torch
    import torch.distributed as dist

    from diffmm_tpu_torch.eval.serve_http import ShardedRecommender, follow, make_server
    from diffmm_tpu_torch.eval.serving import recommend

    if dist.get_rank() != 0:
        return {"served": follow(placed, mesh)}
    recommender = ShardedRecommender(placed, mesh)
    server = make_server(placed, "127.0.0.1", 0, recommender=recommender)
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rec = {"ids_equal": True, "max_score_diff": 0.0, "latency_ms": []}
    try:
        for j in range(20):
            user, k, mask = (997 * j) % placed.u_final.shape[0], 1 + (j * 7) % 50, j % 4 != 0
            t0 = time.perf_counter()
            code, body = _http_get(f"{base}/recommend?user={user}&k={k}&mask_seen={int(mask)}")
            rec["latency_ms"].append((time.perf_counter() - t0) * 1e3)
            ids, scores = recommend(whole, torch.tensor([user], device=whole.u_final.device), k, mask)
            rec["ids_equal"] &= code == 200 and body["items"] == ids[0].tolist()
            rec["max_score_diff"] = max(rec["max_score_diff"],
                                        max(abs(a - b) for a, b in zip(body["scores"], scores[0].tolist())))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        recommender.stop()
    return rec


def mesh_path_o(report_dir: str) -> dict:
    """Path O, in each of two gloo ranks on the one card: E's settings, one
    epoch and ``test_epoch`` on a 2x1 mesh (eager steps), twice from fresh
    Coaches; ``recommend`` over E's index at model 2 against the replicated
    call and 20 requests to the two-shard HTTP server; E's and F's blocks
    (:func:`_blocks`) twice each; K4's mesh form and a Propagate's backward
    at F's shapes. Returns digests, losses, metrics, seconds and the rank's
    peak memory."""
    import copy

    import torch
    import torch.distributed as dist

    from diffmm_tpu_torch.eval.serving import build_index, place_index, recommend
    from diffmm_tpu_torch.parallel import make_mesh
    from diffmm_tpu_torch.train.coach import Coach

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(2, model_parallel=1)
    rec = {"rank": dist.get_rank(), "backend": dist.get_backend(), "E": [], "E_blocks": [], "F_blocks": []}
    torch.cuda.reset_peak_memory_stats(dev)
    t_start = time.perf_counter()
    cfg, host = _tiktok_shape()
    for _ in range(2):
        coach = Coach(copy.deepcopy(cfg), host, device=dev, mesh=mesh)
        check(not coach.capture_steps, "O: a gloo Coach must run its steps eagerly")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        losses = coach.train_epoch(0, fence=True)
        wall = time.perf_counter() - t0
        metrics = coach.test_epoch()
        rec["E"].append({"losses": losses, "metrics": metrics, "digest": _digest(_state(coach)),
                         "epoch_s": wall, "phases_s": dict(coach.timer.totals),
                         "epoch_peak_bytes": torch.cuda.max_memory_allocated(dev),
                         "held_at_start_bytes": held, "coach_state_bytes": coach_state_bytes(coach)})
    index = build_index(coach)
    mesh2 = make_mesh(2, model_parallel=2)
    placed = place_index(index, mesh2)
    users = torch.arange(0, host.user_num, 97, device=dev)[:64]
    (ids_a, sc_a), (ids_b, sc_b) = recommend(placed, users, 20, True, mesh2), recommend(index, users, 20, True)
    rec["recommend_model2"] = {"ids_equal": torch.equal(ids_a, ids_b),
                               "max_score_diff": float((sc_a - sc_b).abs().max()),
                               "placed_rows": placed.i_final.shape[0]}
    rec["http"] = _mesh_http(placed, index, mesh2)
    del coach, index, placed
    gc.collect()
    for _ in range(2):
        fresh = Coach(copy.deepcopy(cfg), host, device=dev, mesh=mesh)
        rec["E_blocks"].append(_blocks(fresh, fresh.split))
    del fresh
    gc.collect()
    cfg, host = _yelp_shape()
    for _ in range(2):
        fresh = Coach(copy.deepcopy(cfg), host, device=dev, mesh=mesh)
        rec["F_blocks"].append(_blocks(fresh, fresh.split))
    rec["k4"] = _k4_mesh_checks(fresh)
    rec["seconds"] = time.perf_counter() - t_start
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return rec


def _p_rebuild(coach, cfg, host) -> dict:
    """Path P: E's rebuild on the 1x2 mesh at sampling_step 0 (the scores
    of the clean rows decide the edges) against one device's from the same
    whole parameters: every user's reverse-diffusion scores, gathered over
    the model axis, within rtol 1e-4 / atol 1e-4, and the edge sets equal
    wherever the k-th and (k+1)-th one-device scores are more than 1e-4
    apart. Rank 0 holds the one-device Coach; every rank runs the mesh's
    collectives."""
    import copy

    import torch
    import torch.distributed as dist

    from diffmm_tpu_torch.data.membership import gather_rows
    from diffmm_tpu_torch.diffusion.gaussian import generate_view
    from diffmm_tpu_torch.parallel.collectives import placed_all_reduce
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.coach import Coach

    split, dev = coach.split, coach.device
    coach.config.hyper.sampling_step = 0
    whole = coach._whole(coach.gcn_params, coach.dn_params)
    bufs = [b.cpu() for b in coach.rebuild_graphs()]
    I, U = host.item_num, host.user_num
    denoisers, apply = steps.rebuild_forward(coach.dn_params, "f32", None, split)
    scores = []
    with torch.no_grad():
        for m, den in enumerate(denoisers):
            parts = []
            for a in range(0, U, 1024):
                x0 = gather_rows(coach.data.train_store, torch.arange(a, min(a + 1024, U), device=dev),
                                 I, (split.lo, split.hi))
                view = generate_view(coach.schedule, den, x0, 0, denoise_apply=apply, cols=(split.lo, split.hi))
                parts.append(placed_all_reduce(view, split.lo, I, split.cat.group, dim=1))
            scores.append(torch.cat(parts))
    rec = {"sampling_step": 0}
    if dist.get_rank() == 0:
        cfg = copy.deepcopy(cfg)
        cfg.hyper.sampling_step = 0
        one = Coach(cfg, host, device=dev)
        one.load_params(whole["gcn_params"], whole["dn_params"])
        want = [b.cpu() for b in one.rebuild_graphs()]
        den1, apply1 = steps.rebuild_forward(one.dn_params, "f32", None)
        x0 = gather_rows(one.data.train_store, torch.arange(U, device=dev), I)
        errs, ties, disagree = [], 0, 0
        with torch.no_grad():
            for m, (den, got_b, want_b) in enumerate(zip(den1, bufs, want)):
                ref = torch.cat([generate_view(one.schedule, den, x0[a:a + 1024], 0, denoise_apply=apply1)
                                 for a in range(0, U, 1024)])
                errs.append(max_err(scores[m], ref))
                ok_scores = torch.allclose(scores[m], ref, rtol=1e-4, atol=1e-4)
                check(ok_scores, f"P rebuild scores, modality {m}: max_abs_err {errs[-1]}")
                top = torch.sort(ref, dim=1, descending=True).values.cpu()
                for u in range(U):
                    lo, k = int(host.csr_offsets[u]), int(host.user_degrees[u])
                    if set(got_b[lo:lo + k].tolist()) == set(want_b[lo:lo + k].tolist()):
                        continue
                    disagree += 1
                    if k < I and float(top[u, k - 1] - top[u, k]) <= 1e-4:
                        ties += 1
        check(disagree == ties, f"P rebuild: {disagree} users' edge sets differ, {ties} of them at near-ties")
        rec.update({"scores_max_abs_err": errs, "users_differing": disagree, "users_at_near_ties": ties})
        del one
    coach.config.hyper.sampling_step = cfg.hyper.sampling_step
    return rec


def mesh_path_p(report_dir: str) -> dict:
    """Path P, in each of two gloo ranks on the one card (a 1x2 mesh, eager
    steps): E's blocks (:func:`_blocks`) from N's state and draws; E's
    epoch and ``test_epoch`` with the kernel counters set to 0 just before
    and read just after; a checkpoint written at 1x2 and restored (rank 0)
    into a Coach without a mesh; E's rebuild against one device's
    (:func:`_p_rebuild`); F's blocks. Returns digests, losses, metrics,
    launches, seconds, the rank's peaks and its Coach state."""
    import copy
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from diffmm_tpu_torch.parallel import make_mesh
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.checkpoint import CheckpointManager

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(2, model_parallel=2)
    rank = dist.get_rank()
    rec = {"rank": rank, "backend": dist.get_backend()}
    torch.cuda.reset_peak_memory_stats(dev)
    t_start = time.perf_counter()
    cfg, host = _tiktok_shape()
    fresh = Coach(copy.deepcopy(cfg), host, device=dev, mesh=mesh)
    check(not fresh.capture_steps, "P: a gloo Coach must run its steps eagerly")
    dn = fresh.dn_params[0]
    rec["holds"] = {"catalog": [fresh.split.lo, fresh.split.hi],
                    "i_embs": list(fresh.gcn_params["i_embs"].shape),
                    "w1": list(dn["in_layers"][0]["w"].shape), "w2": list(dn["out_layers"][-1]["w"].shape),
                    "b2": list(dn["out_layers"][-1]["b"].shape), "dense_block": list(fresh.data.adj.mat.shape)}
    check(rec["holds"]["i_embs"][0] == host.item_num // 2 and rec["holds"]["dense_block"][1] == host.item_num // 2,
          f"P: rank {rank} does not hold half the catalog: {rec['holds']}")
    rec["E_blocks"] = _blocks(fresh, fresh.split)
    del fresh
    gc.collect()
    coach = Coach(copy.deepcopy(cfg), host, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    t0 = time.perf_counter()
    losses = coach.train_epoch(0, fence=True)
    wall = time.perf_counter() - t0
    metrics = coach.test_epoch()
    torch.cuda.synchronize()
    launches = {k: v for counts in _counters() for k, v in counts.items()}
    check(all(launches[k] > 0 for k in ("spmm_dual", K2_MESH_ENTRY, "denoise_layer2", "segsum"))
          and launches["segsum_unfused"] == 0 and launches[K2_ENTRY] == 0, f"P E launches {launches}")
    rec["E"] = {"losses": losses, "metrics": metrics, "digest": _digest(_state(coach)), "epoch_s": wall,
                "phases_s": dict(coach.timer.totals), "launches": launches,
                "epoch_peak_bytes": torch.cuda.max_memory_allocated(dev), "held_at_start_bytes": held,
                "coach_state_bytes": coach_state_bytes(coach),
                # the dense train store's columns on the model axis (JAX _place_train_store)
                "train_store_shape": list(coach.data.train_store.block.shape),
                "train_store_cols": [coach.data.train_store.lo, coach.data.train_store.hi],
                "train_store_bytes": coach.data.train_store.block.nbytes}
    check(rec["E"]["train_store_shape"] == [host.user_num, coach.split.hi - coach.split.lo]
          and rec["E"]["train_store_cols"] == [coach.split.lo, coach.split.hi]
          and 2 * (coach.split.hi - coach.split.lo) == host.item_num,
          f"P: a rank's train store {rec['E']['train_store_shape']}, not its catalog columns")
    directory = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(directory, src=0)
    coach.ckpt = CheckpointManager(directory[0])
    coach.save_checkpoint(0, {"Recall": metrics["Recall"]})
    if rank == 0:
        one = Coach(copy.deepcopy(cfg), host, device=dev)
        one.ckpt = coach.ckpt
        one.restore_checkpoint()
        got = one.test_epoch()
        rec["restored_one_device"] = {"eval": got, "equal": got == metrics,
                                      "i_embs_rows": one.gcn_params["i_embs"].shape[0]}
        check(all(_close(got[k], metrics[k]) for k in metrics), f"P restored eval {got} vs the mesh's {metrics}")
        del one
        shutil.rmtree(directory[0])
    dist.barrier()
    rec["rebuild"] = _p_rebuild(coach, cfg, host)
    del coach
    gc.collect()
    cfg, host = _yelp_shape()
    fresh = Coach(copy.deepcopy(cfg), host, device=dev, mesh=mesh)
    rec["F_blocks"] = _blocks(fresh, fresh.split)
    del fresh
    rec["seconds"] = time.perf_counter() - t_start
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return rec


def phase_mesh(report_dir: str) -> tuple[dict, dict, dict]:
    """Paths N and O in their ranks, and the checks across them: O's ranks
    bitwise equal to each other after every step and from run to run, O
    within rel 2e-3 / abs 1e-5 of N (the JAX mesh test's tolerance)."""
    from diffmm_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    (n,) = run_ranks(mesh_path_n, 1, (report_dir,), backend="nccl", timeout=900)
    n["seconds"] = time.perf_counter() - t0
    print(f"[path N] {n['seconds']:.1f} s")
    t0 = time.perf_counter()
    o = run_ranks(mesh_path_o, 2, (report_dir,), backend="gloo", timeout=1200)
    seconds = time.perf_counter() - t0
    r0, r1 = o
    for run in range(2):
        check(r0["E"][run]["digest"] == r1["E"][run]["digest"], f"O: ranks' E state differs (run {run})")
        for label in ("E", "F"):
            check(r0[f"{label}_blocks"][run]["digests"] == r1[f"{label}_blocks"][run]["digests"],
                  f"O: ranks' {label} state differs after a step (run {run})")
    check(r0["E"][0]["digest"] == r0["E"][1]["digest"] and r0["E"][0]["losses"] == r0["E"][1]["losses"]
          and r0["E"][0]["metrics"] == r0["E"][1]["metrics"], "O: two runs of E differ")
    for label in ("E", "F"):
        check(r0[f"{label}_blocks"][0]["digests"] == r0[f"{label}_blocks"][1]["digests"],
              f"O: two runs of {label}'s blocks differ")
    for kind in ("losses", "metrics"):
        for k, v in r0["E"][0][kind].items():
            check(math.isfinite(v), f"O E {kind} {k}={v}")
    agree = {}
    for label in ("E", "F"):
        want, got = n[f"{label}_blocks"], r0[f"{label}_blocks"][0]
        agree[f"{label}_diffusion_losses"] = all(_close(a, b) for a, b in zip(got["diffusion_losses"],
                                                                              want["diffusion_losses"]))
        agree[f"{label}_joint_metrics"] = all(_close(a, b) for ga, wa in zip(got["joint_metrics"],
                                                                              want["joint_metrics"])
                                              for a, b in zip(ga, wa))
    check(all(agree.values()), f"O against N: {agree}")
    # the first moments beside N's, recorded (O's rows of 512 round otherwise
    # than N's 1,024; P_TOL gates P, the model axis)
    moments = {f"{label}_{kind}": _moments_vs(r0[f"{label}_blocks"][0][kind], n[f"{label}_blocks"][kind])
               for label in ("E", "F") for kind in ("dn_moments", "gcn_moments")}
    # E's whole epoch from a fresh state, recorded beside N's (see the note
    # above path N): relative differences of its losses and metrics
    epoch_vs_n = {kind: {k: abs(r0["E"][0][kind][k] - v) / max(abs(v), 1e-12) for k, v in n["E"][kind].items()}
                  for kind in ("losses", "metrics")}
    check(r0["recommend_model2"]["ids_equal"] and r0["recommend_model2"]["max_score_diff"] <= 1e-5,
          f"O recommend at model 2: {r0['recommend_model2']}")
    check(r0["http"]["ids_equal"] and r0["http"]["max_score_diff"] <= 1e-5 and r1["http"] == {"served": 20},
          f"O HTTP: {r0['http']} {r1['http']}")
    rec = {"ranks": o, "agree_with_N": agree, "moments_vs_N": moments, "E_epoch_rel_diff_vs_N": epoch_vs_n,
           "seconds": seconds,
           "peak_mem_bytes": [r["peak_mem_bytes"] for r in o]}
    print(f"[path O] {json.dumps({k: v for k, v in rec.items() if k != 'ranks'})}")
    t0 = time.perf_counter()
    p = run_ranks(mesh_path_p, 2, (report_dir,), backend="gloo", timeout=1200)
    p_rec = _check_path_p(p, n, o, time.perf_counter() - t0)
    for blocks in [n[f"{x}_blocks"] for x in "EF"] + [r[f"{x}_blocks"][i] for r in o for x in "EF"
                                                       for i in range(2)] + [r[f"{x}_blocks"] for r in p for x in "EF"]:
        for kind in ("dn_moments", "gcn_moments"):  # the samples stay out of the report
            blocks[kind] = {"l1": blocks[kind]["l1"]}
    with open(os.path.join(report_dir, "mesh_paths.json"), "w") as fh:
        json.dump({"N": n, "O": o, "P": p}, fh, indent=1)
    return n, rec, p_rec


def _check_path_p(p, n, o, seconds: float) -> dict:
    """Path P's checks across its ranks and against N: the ranks' whole
    states bitwise equal after every step and after E's epoch; E's and F's
    blocks within P_TOL of N's, their losses, metrics and first Adam
    moments; its memory beside O's."""
    r0, r1 = p
    check(r0["E"]["digest"] == r1["E"]["digest"] and r0["E"]["losses"] == r1["E"]["losses"]
          and r0["E"]["metrics"] == r1["E"]["metrics"], "P: ranks' E epoch differs")
    for label in ("E", "F"):
        check(r0[f"{label}_blocks"]["digests"] == r1[f"{label}_blocks"]["digests"],
              f"P: ranks' {label} state differs after a step")
    for kind in ("losses", "metrics"):
        for k, v in r0["E"][kind].items():
            check(math.isfinite(v), f"P E {kind} {k}={v}")
    agree, moments = {}, {}
    for label in ("E", "F"):
        want, got = n[f"{label}_blocks"], r0[f"{label}_blocks"]
        agree[f"{label}_diffusion_losses"] = all(_close(a, b, P_TOL) for a, b in zip(got["diffusion_losses"],
                                                                                     want["diffusion_losses"]))
        agree[f"{label}_joint_metrics"] = all(_close(a, b, P_TOL) for ga, wa in zip(got["joint_metrics"],
                                                                                     want["joint_metrics"])
                                              for a, b in zip(ga, wa))
        for kind in ("dn_moments", "gcn_moments"):
            moments[f"{label}_{kind}"] = _moments_vs(got[kind], want[kind])
            agree[f"{label}_{kind}"] = moments[f"{label}_{kind}"]["ok"]
    check(all(agree.values()), f"P against N: {agree} {moments}")
    epoch_vs_n = {kind: {k: abs(r0["E"][kind][k] - v) / max(abs(v), 1e-12) for k, v in n["E"][kind].items()}
                  for kind in ("losses", "metrics")}
    o_e = [r["E"][0] for r in o]
    memory = {
        "P_epoch_peak_bytes": [r["E"]["epoch_peak_bytes"] for r in p],
        "O_epoch_peak_bytes": [e["epoch_peak_bytes"] for e in o_e],
        "P_coach_state_bytes": [r["E"]["coach_state_bytes"] for r in p],
        "P_train_store_bytes": [r["E"]["train_store_bytes"] for r in p],
        "O_coach_state_bytes": [e["coach_state_bytes"] for e in o_e],
        "P_path_peak_bytes": [r["peak_mem_bytes"] for r in p],
        "O_path_peak_bytes": [r["peak_mem_bytes"] for r in o],
    }
    memory["saved_coach_state_bytes"] = [oe["all"] - pe["all"] for oe, pe in
                                         zip(memory["O_coach_state_bytes"], memory["P_coach_state_bytes"])]
    rec = {"agree_with_N": agree, "moments_vs_N": moments, "E_epoch_rel_diff_vs_N": epoch_vs_n,
           "seconds": seconds,
           "launches": r0["E"]["launches"], "holds": [r["holds"] for r in p], "memory": memory,
           "rebuild": r0["rebuild"], "restored_one_device": r0["restored_one_device"],
           "E_epoch_s": [r["E"]["epoch_s"] for r in p]}
    print(f"[path P] {json.dumps(rec)}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report-dir", default=os.path.join(REPO, "smoke_report"),
                    help="where the JSON report and the profile table are written")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    os.makedirs(args.report_dir, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {smi}")
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    report["build"] = phase_build()
    report["kernels"] = phase_kernels(dev)
    report["reference"] = phase_reference(dev)
    # every path's host-clock times come before any profiler session: a
    # session raises the host's launch cost for the rest of the process
    report["path_A"], coach_a, host_a = phase_path_a(dev)
    report["path_I"] = phase_path_i(dev, host_a, coach_a, report["path_A"])
    report["path_B"] = phase_path_b(dev)
    report["path_C"], coach_c, host_c = phase_path_c(dev)
    report["path_D"] = phase_path_d(dev)
    report["path_E"], coach_e = phase_path_e(dev, host_a)
    report["path_J"] = phase_path_j(dev, host_a, report["path_E"], coach_e)
    report["path_F"], coach_f = phase_path_f(dev, host_c)
    report["path_G"] = phase_path_g(dev)
    report["path_K"] = phase_path_k(dev, host_a)
    report["path_L"] = phase_path_l(dev, host_a)
    report["C1"] = phase_c1(dev, coach_e, coach_f, host_a,
                            [e["losses"] for e in report["path_E"]["epochs"]])
    report["graphs"] = phase_graphs(coach_e, coach_f)
    report["path_H"], twin = phase_path_h(dev, host_a)
    report["resume"] = phase_resume(dev, host_a, twin, report["path_H"]["single_losses"][1],
                                    args.report_dir)
    del twin
    report["path_R"] = phase_path_r(dev, host_a, args.report_dir)
    report["path_M"] = phase_path_m(dev, coach_e, args.report_dir)
    report["path_Q"] = phase_path_q(dev, args.report_dir)
    report["path_S"] = phase_path_s(dev, args.report_dir)
    report["profile_A"] = phase_profile(_rebuild_and_eval(coach_a), "A", args.report_dir)
    report["profile_C"] = phase_profile(_rebuild_and_eval(coach_c), "C", args.report_dir)
    report["profile_E_joint"] = phase_profile(_joint_phase_work(coach_e, 1), "E_joint", args.report_dir)
    report["profile_E_joint_eager"] = phase_profile(_joint_phase_work(coach_e, 1, graphed=False),
                                                    "E_joint_eager", args.report_dir)
    report["profile_F_joint"] = phase_profile(_joint_phase_work(coach_f, 0), "F_joint", args.report_dir)
    del coach_f
    gc.collect()
    report["path_N"], report["path_O"], report["path_P"] = phase_mesh(args.report_dir)

    # each kernel's launches come from this slice's path that runs it: K1-K3
    # from E (dense-form training), K4 from F (sparse-form training); the
    # other paths' beside them, path P's (model-axis training, E's settings
    # on a 1x2 mesh) and path S's (the web-scale configuration). K2's launches are those of both its entries:
    # the tanh epilogue one device runs (K2_ENTRY) and the partial product a
    # mesh runs (K2_MESH_ENTRY)
    k2_entries = (K2_ENTRY, K2_MESH_ENTRY)
    kernels = report["kernels"]
    p_launches = report["path_P"]["launches"]
    rows = []
    for name, meta in KERNELS.items():
        main_path, others = ("F", "ABCDEH") if name == "segsum" else ("E", "ABCDFH")
        entries = k2_entries if name == "denoise_layer1" else (name,)
        count = lambda launches: sum(launches[e] for e in entries)  # noqa: E731
        k = kernels["segsum_user" if name == "segsum" else name]
        launches = count(report[f"path_{main_path}"]["launches"])
        row = {"name": name, "route": "cuda", "source": meta["source"],
               "replaces": meta["replaces"], "launches": launches,
               **{f"launches_{p}": count(report[f"path_{p}"]["launches"]) for p in others},
               "launches_N": count(report["path_N"]["F" if name == "segsum" else "E"]["launches"]),
               "launches_P": count(p_launches),
               # path R: the bench's dense and sparse rows together
               "launches_R": count(report["path_R"]["bench"]["launches"]),
               # path S: the one-card web-scale epoch and both demos' ranks
               "launches_S": count(report["path_S"]["one_card"]["launches"]) + sum(
                   count(d["launches"]) for d in report["path_S"]["demo"].values()),
               **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}}
        if name == "denoise_layer1":
            row["launches_by_entry"] = {p: {e: launches_p[e] for e in k2_entries} for p, launches_p in
                                        (("E", report["path_E"]["launches"]), ("P", p_launches))}
        if name == "spmm_dual":
            extra = {"bf16_store": kernels["spmm_dual_bf16"], "backward": kernels["spmm_dual_backward"],
                     "int4_store": kernels["spmm_dual_int4"],
                     "int4_backward": kernels["spmm_dual_int4_backward"],
                     "model_axis_shard_int8": kernels["spmm_dual_shard_int8"],
                     "model_axis_shard_int4": kernels["spmm_dual_shard_int4"],
                     "S_dense_demo_shard": kernels["spmm_dual_s_shard"]}
        elif name == "segsum":
            # the fused entry on every path; its other cases in brief (in full in the report)
            row["unfused_ms"] = k["unfused_ms"]
            row["launches_unfused"] = {p: report[f"path_{p}"]["launches"]["segsum_unfused"]
                                       for p in "ABCDEFHJK"}
            extra = {"cases": {key: {f: rec[f] for f in K4_CASE_FIELDS if f in rec}
                               for key, rec in kernels.items()
                               if key.startswith("segsum_") and key != "segsum_user"}}
            # path S (a)'s own graphs and a hub at its shape
            extra["cases"].update({f"S_{key}": {f: rec[f] for f in K4_CASE_FIELDS if f in rec}
                                   for key, rec in report["path_S"]["one_card"]["k4"].items()})
            # the mesh forms (sharded_sorted_segment_sum, sharded_ranked_segment_sum):
            # one launch over a rank's edge slice and an all-reduce
            row["mesh_form"] = {"replaces": ["diffmm_tpu/ops/pallas/segsum.py:455",
                                             "diffmm_tpu/ops/pallas/segsum.py:708"],
                                "source": "diffmm_tpu_torch/parallel/segsum.py",
                                "launches_N": row["launches_N"],
                                "world_1_nccl": report["path_N"]["k4_mesh"],
                                "world_2_gloo_checks": report["path_O"]["ranks"][0]["k4"]}
        elif name == "denoise_layer1":
            extra = {"yelp_shape": kernels[K2_ENTRY + "_yelp"],
                     "partial": kernels[K2_MESH_ENTRY],
                     "partial_yelp_shape": kernels[K2_MESH_ENTRY + "_yelp"],
                     "model_axis_shard": kernels[K2_MESH_ENTRY + "_shard"],
                     "model_axis_yelp_shard": kernels[K2_MESH_ENTRY + "_yelp_shard"],
                     "S_shape": kernels[K2_ENTRY + "_s"],
                     "partial_S_shape": kernels[K2_MESH_ENTRY + "_s"],
                     "partial_S_sparse_demo_shard": kernels[K2_MESH_ENTRY + "_s_shard"]}
        else:
            extra = {"yelp_shape": kernels[name + "_yelp"],
                     "model_axis_shard": kernels[name + "_shard"],
                     "model_axis_yelp_shard": kernels[name + "_yelp_shard"],
                     "S_shape": kernels[name + "_s"],
                     "S_sparse_demo_shard": kernels[name + "_s_shard"]}
        if name.startswith("denoise"):
            row.update({key: k[key] for key in ("bound_design_ms", "bound_design", "bound_f32_fma_ms",
                                                "max_err_vs_f64", "plain_max_err_vs_f64",
                                                "prepare_ms")})
        cases = [k, *(extra["cases"].values() if name == "segsum" else extra.values())]
        row.update(extra)
        row["ok"] = all(bool(c["ok"]) for c in cases) and launches > 0 and row["launches_P"] > 0 and (
            row["launches_R"] > 0) and row["launches_S"] > 0 and not any(row.get("launches_unfused", {}).values())
        rows.append(row)
    ok = all(row["ok"] for row in rows)
    report["ok"] = ok
    with open(os.path.join(args.report_dir, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    check(ok, f"kernel rows not ok: {[r['name'] for r in rows if not r['ok']]}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": ok, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
