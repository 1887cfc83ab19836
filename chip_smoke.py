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
   its backward through autograd (``SpmmDual``); K2/K3 ``denoise_mlp`` at
   B 1,024, H 1,024 and I 6,710 and 20,000, on weights prepared once (also
   bitwise across two launches and within twice the plain f32 product's
   error against float64); K4 ``segsum`` at the yelp shape: the user
   direction, n 38,403, nnz 307,200, d 64; the item direction, n 20,000,
   ids with gaps; the stacked width d 128; the item direction of a rebuilt
   graph, one hub of 38,389 edges; f32 and bf16 messages; and the backward
   of the sparse form's three autograd Functions, user and item
   directions, stacked user and multi-item) against its plain PyTorch
   version within the stated tolerance (K1's and K4's also bitwise across
   two launches); times (CUDA events, warm, many launches) of the kernel,
   the plain version and one PyTorch library call computing the same
   function, beside the bound.
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
    tests/test_regression_mini.py; Recall@20 in that test's band.
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
15. path I (after A): path A with ``train.dense_store="int4"`` (packed
    blocks, K1's int4 read): edge buffers, embeddings and metrics bitwise
    A's.
16. path J (after E): path E with ``train.dense_store="int4"``: its epoch-1
    loss bitwise E's (K1's int4 plan is its int8 plan), its memory beside
    E's and the blocks' expected saving, a third epoch, the in-place block
    rebuild timed beside E's.
17. path K (after G): path E's data with the KNN ablation (``hyper.
    use_knn_adj``, knn_topk 10), one epoch: no rebuild, ``rebuild_graphs``
    refuses, K1 and K4 launches a joint step as counted, the KNN graphs
    against their plain version (K4 prototypes, top-k outside ties).
18. path L: path E's data, one epoch each with bf16 denoisers (K2/K3 as in
    E) and with the bf16 rebuild of a [1024, 1024] denoiser (no K2/K3), on
    captured graphs, one more epoch of each with no host sync; path G's run
    at seed 1818 under each of G_KNOBS, Recall@20 recorded.
19. path M (after resume): path E's index exported, loaded onto the card
    and served over HTTP (``eval/serve_http.py``) on 127.0.0.1: health,
    error paths, 200 requests each equal to a direct ``recommend``; their
    latencies beside the direct calls'.
20. profiles (torch.profiler, after every path's host-clock times): A's
    and C's rebuild + eval, one more joint phase of E at epoch 1's
    learning rate, replayed from its graph and run eagerly, and one more
    joint phase of F replayed.

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
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

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
# Path A's shape: tiktok's catalog at its density, its feature widths
# (conf/test.toml's dataset; the full data is not in the repository)
TIKTOK = {"user_num": 9308, "item_num": 6710, "density": 0.000953, "feat_dims": [128, 768, 128]}
# Path C's shape: yelp's catalog and feature widths (conf/yelp.toml), its
# padded train edge count (307,180 edges + 20 sentinel pads), and the hub of
# its rebuilt item directions (38,389 of 38,403 users on one item)
YELP = {"user_num": 38403, "item_num": 20000, "density": 0.0004, "feat_dims": [4096, 1024],
        "edges": 307200, "hub": 38389}


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

    out.update(_denoise_cases(dev, gen))
    out.update(_segsum_cases(dev, gen))
    out.update(_segsum_backward_cases(dev, gen))
    out.update(_gather_backward_cases(dev, gen))
    return out


def _gather_backward_cases(dev, gen) -> dict:
    """K4 in the backward of the loss gathers (``ops/gather.py``) at path E's
    shapes: a joint block's 1,024 users gathered from u_final (9,308 x 64)
    and its 1,024 items from i_final (6,710 x 64), indices drawn from the
    train edges as the joint phase draws them. One launch a backward call,
    against segsum_plain on the same sorted cotangent within TOL["segsum"]
    (scaled by the sum of each row's |terms|), bitwise across two calls; the
    launch alone timed beside the plain version and the library's scatter
    (``index_add_``, atomic adds), and the whole autograd call."""
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

        before = sg.LAUNCHES["segsum"]
        got, again = backward(), backward()
        per_call = (sg.LAUNCHES["segsum"] - before) / 2
        msgs = g.index_select(0, plan.perm)
        want = sg.segsum_plain(msgs, plan.offsets)
        scale = sg.segsum_plain(msgs.abs(), plan.offsets)
        torch.cuda.synchronize()
        err = max_err(got, want)
        bitwise = torch.equal(got, again)
        ok = bool(((got - want).abs() <= rtol * scale + atol).all()) and bitwise and per_call == 1
        check(ok, f"gather backward[{name}] vs plain: max_abs_err {err}, bitwise {bitwise}, "
                  f"launches {per_call}")
        # the sorted cotangent and the offsets read once, the (n, d) output
        # written once; one add per cotangent element
        b, by = bound_ms(B * d * 4 + plan.offsets.numel() * 8 + n * d * 4, B * d, F32_FLOPS)
        idx_l = idx.long()
        rec = {"ok": ok, "shape": [n, B, d], "max_segment": int(plan.offsets.diff().max()),
               "max_abs_err": err, "bitwise_across_launches": bitwise, "launches_per_backward": per_call,
               "backward_ms": time_ms(backward, 50),
               "ms": time_ms(lambda: sg.segsum(msgs, plan.offsets), 50),
               "plain_ms": time_ms(lambda: sg.segsum_plain(msgs, plan.offsets), 20),
               "bound_ms": b, "bound_by": by,
               "library_ms": time_ms(lambda: torch.zeros((n, d), device=dev).index_add_(0, idx_l, g), 50)}
        out[f"segsum_gather_backward_{name}"] = rec
        print(f"[kernels] segsum_gather_backward_{name}: {json.dumps(rec)}")
    return out


def _spmm_dual_backward(dev, gen, mat, I: int) -> dict:
    """K1's backward through autograd (``SpmmDual``) at the path's shape:
    the cotangents' gradients against the plain version's (the same call
    with the cotangents in place of z), within TOL, bitwise across two
    backward calls, one launch a call; timed as a whole autograd call and as
    its launch alone."""
    import torch

    from diffmm_tpu_torch.ops.kernels import spmm_dual as sd

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
           "bound_by": by, "library_ms": time_ms(lambda: (m16 @ g16[1], m16.T @ g16[0]), 50)}
    print(f"[kernels] spmm_dual_backward[{kind}]: {json.dumps(rec)}")
    return rec


def _denoise_cases(dev, gen) -> dict:
    """K2/K3 at the rebuild's shapes, tiktok's catalog (path A) and yelp's
    (path C), on weights prepared once as the rebuild prepares them (the
    preparation timed beside them): each against its plain version within
    TOL, bitwise across two launches, and within twice the plain f32
    product's max error against float64. Three bounds: the function's
    (``bound_ms``: its products at the TF32 rate), the design's (3xTF32,
    three TF32 products per f32 one) and the f32 FMA rate's."""
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
        full = dm.fused_denoise_mlp(x, w1x, tp, w2, b2)
        want_full = dm.layer2_plain(h, w2, b2)
        for name, kern, plain, exact, lib_call, n_bytes, prep in (
            ("denoise_layer1", lambda: dm.denoise_layer1(x, w1p, tp),
             lambda: dm.layer1_plain(x, w1x, tp),
             lambda: torch.tanh(x.double() @ w1x.double() + tp.double()),
             lambda: torch.tanh(torch.addmm(tp, x, w1x)),
             (B * K + K * H + 2 * B * H) * 4, prep_ms["w1x"]),
            ("denoise_layer2", lambda: dm.denoise_layer2(h, w2p, b2),
             lambda: dm.layer2_plain(h, w2, b2),
             lambda: h.double() @ w2.double() + b2.double(),
             lambda: torch.addmm(b2, h, w2),
             (B * H + H * K + K + B * K) * 4, prep_ms["w2"]),
        ):
            got, again, want = kern(), kern(), plain()
            ref = exact()
            torch.cuda.synchronize()
            rtol, atol = TOL[name]
            err = max_err(got, want)
            err_f64, plain_f64 = max_err(got.double(), ref), max_err(want.double(), ref)
            del ref
            bitwise = torch.equal(got, again)
            ok = torch.allclose(got, want, rtol=rtol, atol=atol) and bitwise and err_f64 <= 2 * plain_f64
            check(ok, f"{name}{suffix}: max_abs_err {err} vs plain, {err_f64} vs f64 (plain "
                      f"{plain_f64}), bitwise across launches: {bitwise}")
            # the function's bound: its 2·B·K·H f32 products at the card's
            # fastest rate for f32 operands (TF32 tensor cores)
            flops = 2 * B * K * H
            b, by = bound_ms(n_bytes, flops, TF32_FLOPS)
            rec = {
                "ok": ok,
                "shape": [B, K, H],
                "max_abs_err": err,
                "max_err_vs_f64": err_f64,
                "plain_max_err_vs_f64": plain_f64,
                "bitwise_across_launches": bitwise,
                "ms": time_ms(kern, 20),
                "plain_ms": time_ms(plain, 20),
                "bound_ms": b,
                "bound_by": by,
                "bound_design_ms": bound_ms(n_bytes, 3 * flops, TF32_FLOPS)[0],
                "bound_design": "3xTF32: 3 TF32 products per f32 one at 495 TFLOP/s",
                "bound_f32_fma_ms": bound_ms(n_bytes, flops, F32_FLOPS)[0],
                "library_ms": time_ms(lib_call, 20),
                "prepare_ms": prep,
            }
            out[name + suffix] = rec
            print(f"[kernels] {name}{suffix}: {json.dumps(rec)}")
        err = max_err(full, want_full)
        check(torch.allclose(full, want_full, rtol=1e-5, atol=1e-4), f"fused_denoise_mlp{suffix}: {err}")
        print(f"[kernels] fused_denoise_mlp{suffix} wrapper (weights prepared per call) vs plain: "
              f"max_abs_err {err}")
        del x, w1x, tp, w2, b2, w1p, w2p, h, full, want_full
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


def _segsum_cases(dev, gen) -> dict:
    """K4 at path C's shapes: the user direction (38,403 segments of about
    8 edges, the train rows), the item direction (20,000 segments, skewed
    ids with gaps: :func:`sorted_segment_ids`), the stacked user direction
    at d 128, and the item direction of a rebuilt graph (one hub segment of
    38,389 edges: :func:`hub_segment_ids`); f32 and bf16 messages; 307,180
    real edges plus 20 sentinel pads whose messages (NaN here) are never
    read."""
    import torch

    from diffmm_tpu_torch.ops.kernels import segsum as sg

    U, I, nnz = YELP["user_num"], YELP["item_num"], YELP["edges"]
    out = {}
    # path C's rebuilt modality graphs put 38,389 of 38,403 users on one item
    for case, n, d, skew in (("user", U, 64, 1.0), ("item", I, 64, 2.0), ("stacked", U, 128, 1.0),
                             ("item_hub", I, 64, None)):
        ids = (hub_segment_ids(gen, n, nnz, 20, YELP["hub"], dev) if skew is None
               else sorted_segment_ids(gen, n, nnz, 20, skew, dev))
        offsets = sg.segment_offsets(ids, n)
        real = int(offsets[-1])
        for dtype in (torch.float32, torch.bfloat16):
            msgs = torch.randn((nnz, d), generator=gen, device=dev).to(dtype)
            msgs[real:] = float("nan")
            got = sg.segsum(msgs, offsets)
            again = sg.segsum(msgs, offsets)
            want = sg.segsum_plain(msgs, offsets)
            torch.cuda.synchronize()
            rtol, atol = TOL["segsum"]
            err = max_err(got, want)
            scale = sg.segsum_plain(msgs.abs(), offsets)
            ok = bool(((got - want).abs() <= rtol * scale + atol).all()) and torch.equal(got, again)
            check(ok, f"segsum[{case}, {dtype}] vs plain: max_abs_err {err}, "
                      f"bitwise across launches: {torch.equal(got, again)}")
            # each input the kernel takes (messages, offsets) read once, the
            # output written once; one add per message element of the real edges
            n_bytes = msgs.numel() * msgs.element_size() + offsets.numel() * 8 + n * d * 4
            b, by = bound_ms(n_bytes, real * d, F32_FLOPS)
            rec = {
                "ok": ok,
                "shape": [n, nnz, d],
                "msgs": str(dtype).removeprefix("torch."),
                "empty_segments": int((offsets.diff() == 0).sum()),
                "max_segment": int(offsets.diff().max()),
                "max_abs_err": err,
                "max_err_over_abs_sum": float(((got - want).abs() / (scale + 1e-30)).max()),
                "ms": time_ms(lambda: sg.segsum(msgs, offsets), 50),
                "plain_ms": time_ms(lambda: sg.segsum_plain(msgs, offsets), 20),
                "bound_ms": b,
                "bound_by": by,
                # torch.segment_reduce sums bf16 input in bf16 (measured
                # 5.7 off on 980 terms): the same function only for f32
                "library_ms": time_ms(
                    lambda: torch.segment_reduce(msgs, "sum", offsets=offsets, axis=0), 20)
                if dtype == torch.float32 else None,
            }
            key = f"segsum_{case}" + ("" if dtype == torch.float32 else "_bf16")
            out[key] = rec
            print(f"[kernels] {key}: {json.dumps(rec)}")
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
    first over a hub) and ``MultiItemPropagate`` (one wide launch at M·d).
    Each backward call's gradient against its plain twin (the same
    cotangent messages through ``segsum_plain``) within TOL["segsum"]
    scaled by the sum of each output's |terms|, bitwise across two calls,
    its K4 launches a call, the call's time, and its K4 launches alone
    (kernel, plain, library, bound) on the call's messages."""
    import torch

    from diffmm_tpu_torch.ops import graph as og
    from diffmm_tpu_torch.ops.kernels import segsum as sg

    main, modal = _yelp_graphs(gen, dev)
    U, I, d = main.user_num, main.item_num, 64
    M = len(modal)
    cases = {
        # name: (function of z, z shape, output shape, [(bwd_src, bwd_offsets)] per launch, widths)
        "user_direction": (lambda z: og.Propagate.apply(z, main.ui_cols, main.ui_offsets, main.iu_cols,
                                                        main.iu_offsets, "f32"),
                           (I, d), (U, d), [("g", main.iu_cols, main.iu_offsets)]),
        "item_direction": (lambda z: og.Propagate.apply(z, main.iu_cols, main.iu_offsets, main.ui_cols,
                                                        main.ui_offsets, "f32"),
                           (U, d), (I, d), [("g", main.ui_cols, main.ui_offsets)]),
        "stacked_user": (lambda z: og.StackedUserPropagate.apply(z, tuple(modal), "f32"),
                         (M, I, d), (M, U, d), [(m, a.iu_cols, a.iu_offsets) for m, a in enumerate(modal)]),
        "multi_item": (lambda z: og.MultiItemPropagate.apply(z, tuple(modal), "f32"),
                       (M, U, d), (M, I, d), [("wide", [a.ui_cols for a in modal], modal[0].ui_offsets)]),
    }
    out = {}
    rtol, atol = TOL["segsum"]
    for name, (fn, z_shape, y_shape, launches) in cases.items():
        z = torch.randn(z_shape, generator=gen, device=dev).requires_grad_()
        g = torch.randn(y_shape, generator=gen, device=dev)
        y = fn(z)

        def backward():
            return torch.autograd.grad(y, z, g, retain_graph=True)[0]

        before = sg.LAUNCHES["segsum"]
        got, again = backward(), backward()
        per_call = (sg.LAUNCHES["segsum"] - before) / 2
        # the backward's messages and offsets, launch by launch
        msgs_offsets = []
        for part, src, offsets in launches:
            if part == "g":
                msgs = og._gather_cotangent(g, src, "f32")
            elif part == "wide":
                msgs = torch.cat([og._gather_cotangent(g[m], s, "f32") for m, s in enumerate(src)], dim=1)
            else:
                msgs = og._gather_cotangent(g[part], src, "f32")
            msgs_offsets.append((msgs, offsets))
        want = [sg.segsum_plain(m, o) for m, o in msgs_offsets]
        scale = [sg.segsum_plain(m.abs(), o) for m, o in msgs_offsets]
        if name == "multi_item":
            want = [w.view(U, M, d).permute(1, 0, 2) for w in want]
            scale = [s_.view(U, M, d).permute(1, 0, 2) for s_ in scale]
            got_parts = [got]
        elif name == "stacked_user":
            got_parts = list(got)
        else:
            got_parts = [got]
        torch.cuda.synchronize()
        err = max(max_err(a, b) for a, b in zip(got_parts, want))
        close = all(bool(((a - b).abs() <= rtol * s_ + atol).all()) for a, b, s_ in zip(got_parts, want, scale))
        bitwise = torch.equal(got, again)
        ok = close and bitwise and per_call == len(launches)
        check(ok, f"segsum backward[{name}] vs plain: max_abs_err {err}, bitwise {bitwise}, "
                  f"launches {per_call} (want {len(launches)})")
        bound = [bound_ms(m.numel() * 4 + o.numel() * 8 + (o.numel() - 1) * m.shape[1] * 4,
                          int(o[-1]) * m.shape[1], F32_FLOPS) for m, o in msgs_offsets]
        rec = {
            "ok": ok, "z_shape": list(z_shape), "launches_per_backward": per_call,
            "segments": [int(o.numel() - 1) for _, o in msgs_offsets],
            "widths": [int(m.shape[1]) for m, _ in msgs_offsets],
            "max_segment": max(int(o.diff().max()) for _, o in msgs_offsets),
            "max_abs_err": err,
            "max_err_over_abs_sum": max(float(((a - b).abs() / (s_ + 1e-30)).max())
                                        for a, b, s_ in zip(got_parts, want, scale)),
            "bitwise_across_launches": bitwise,
            "backward_ms": time_ms(backward, 20),
            "ms": sum(time_ms(lambda m=m, o=o: sg.segsum(m, o), 50) for m, o in msgs_offsets),
            "plain_ms": sum(time_ms(lambda m=m, o=o: sg.segsum_plain(m, o), 10) for m, o in msgs_offsets),
            "bound_ms": sum(b for b, _ in bound),
            "bound_by": bound[0][1],
            "library_ms": sum(time_ms(lambda m=m, o=o: torch.segment_reduce(m, "sum", offsets=o, axis=0), 20)
                              for m, o in msgs_offsets),
        }
        out[f"segsum_backward_{name}"] = rec
        print(f"[kernels] segsum_backward_{name}: {json.dumps(rec)}")
        del z, g, y, got, again, msgs_offsets, want, scale
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


def _train_step_reference(dev, cfg, form: str) -> dict:
    """One diffusion_block and one joint_block on the card and on the CPU
    from the same parameters, Adam states (after one CPU epoch, so the
    updates are smooth functions of the gradients) and injected draws:
    losses and updated parameters. Diffusion: f32 on both sides (cuBLAS
    without TF32), rtol 1e-4 / atol 1e-5; joint: the sparse form f32, rtol
    1e-4 / atol 1e-5, the dense form at its bf16 tolerance, rtol 1e-2 /
    atol 1e-3. The card's joint step must launch K1 (dense) or K4 (sparse)
    as often backward as forward, and K4 once for each loss gather's
    backward (:func:`joint_step_launches`)."""
    import torch

    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.models.gcn import project_features
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.train.optim import tree_leaves

    cfg.train.graph_form = form
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
        for counts in _counters():
            for k in counts:
                counts[k] = 0
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
    rec = {"launches": launches}
    rec["diffusion_loss_max_abs_err"] = _check_close([d_g], [d_c], 1e-4, 1e-5, f"{form} diffusion losses")
    rec["denoiser_max_abs_err"] = _check_close(
        [p for dn in gpu.dn_params for p in tree_leaves(dn)],
        [p for dn in cpu.dn_params for p in tree_leaves(dn)], 1e-4, 1e-5, f"{form} denoisers after a step")
    tol = (1e-2, 1e-3) if form == "dense" else (1e-4, 1e-5)
    rec["joint_metrics_max_abs_err"] = _check_close([j_g], [j_c], *tol, f"{form} joint metrics")
    rec["gcn_max_abs_err"] = _check_close(tree_leaves(gpu.gcn_params), tree_leaves(cpu.gcn_params), *tol,
                                          f"{form} GCN after a joint step")
    want = joint_step_launches(form == "dense", M, cfg.base.cl_method)
    check(all(launches[k] == v for k, v in want.items()),
          f"{form} joint step launches {launches}, want {want} (forward and backward, loss gathers)")
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
    a modality, K1 (dense) or K4 (sparse) for the 4 main-graph propagations."""
    pairs = n_modal * (n_modal - 1) // 2 if cl_method == 1 else n_modal
    gathers = 3 + 4 + 4 * pairs
    if knn:
        modal = 2 * 2 * n_modal
        if dense:
            return {"spmm_dual": 2 * 4, "segsum": modal + gathers}
        return {"spmm_dual": 0, "segsum": modal + 2 * 2 * 4 + gathers}
    if dense:
        return {"spmm_dual": 2 * (n_modal + 4), "segsum": gathers}
    return {"spmm_dual": 0, "segsum": 2 * (n_modal + 9) + gathers}


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
    from diffmm_tpu_torch.ops.kernels import denoise_mlp, segsum, spmm_dual

    return (spmm_dual.LAUNCHES, denoise_mlp.LAUNCHES, segsum.LAUNCHES)


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
    for counts in _counters():
        for k in counts:
            counts[k] = 0
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
    check(launches["denoise_layer1"] == want_dn and launches["denoise_layer2"] == want_dn,
          f"{label} denoise launches {launches}, want {want_dn} each")
    if coach.dense_graphs:
        # one per modality graph, two over the main graph
        per_fwd, kernel, other = coach.n_modal + 2, "spmm_dual", "segsum"
    else:
        # two per main-graph propagation, one stacked user direction, one
        # item direction per modality
        per_fwd, kernel, other = 2 * 2 + 1 + coach.n_modal, "segsum", "spmm_dual"
    check(launches[kernel] >= per_fwd * n_fwd and launches[other] == 0,
          f"{label} launches {launches}, want {kernel} >= {per_fwd * n_fwd} and no {other}")
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
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data

    cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
    t0 = time.perf_counter()
    host = make_synthetic_host_data(
        cfg, user_num=TIKTOK["user_num"], item_num=TIKTOK["item_num"], density=TIKTOK["density"],
        feat_dims=TIKTOK["feat_dims"], seed=cfg.base.seed,
    )
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
    own = ("dual_kernel", "gemm_3xtf32", "splitk_sum", "segsum_kernel")
    rec = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
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


def phase_path_c(dev) -> tuple[dict, object, object]:
    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data

    cfg = load_config(os.path.join(REPO, "conf", "yelp.toml"))
    cfg.train.graph_form = "sparse"  # the train store stays "auto"
    t0 = time.perf_counter()
    host = make_synthetic_host_data(
        cfg, user_num=YELP["user_num"], item_num=YELP["item_num"], density=YELP["density"],
        modalities=["image", "text"], feat_dims=YELP["feat_dims"], seed=cfg.base.seed,
    )
    print(f"[path C] synthetic data in {time.perf_counter() - t0:.1f} s")
    rec, coach = drive_path(dev, cfg, host, "C")
    check(rec["graph_form"] == "sparse" and rec["train_store"] == "csr", f"C form {rec}")
    blocks = -(-host.user_num // cfg.train.batch)  # 38 at 1,024 users a block
    check(rec["launches"]["denoise_layer1"] == 2 * cfg.hyper.steps * blocks,
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


def drive_training(dev, cfg, host, label: str, epochs: int):
    """``train_epoch(e, fence=True)`` for ``epochs`` epochs, then
    ``test_epoch``, with every kernel counter set to 0 just before and read
    just after; each epoch's joint phase counts its own launches (its
    K1/K4 forward and backward). Returns the record and the warm Coach."""
    import torch

    from diffmm_tpu_torch.train.coach import Coach

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
    for counts in _counters():
        for k in counts:
            counts[k] = 0
    epochs_rec = []
    for epoch in range(epochs):
        coach.timer.reset()
        t0 = time.perf_counter()
        losses = coach.train_epoch(epoch, fence=True)
        wall = time.perf_counter() - t0
        check(all(math.isfinite(v) for v in losses.values()), f"{label} epoch {epoch} losses {losses}")
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
    check(launches["denoise_layer1"] == want_dn and launches["denoise_layer2"] == want_dn,
          f"{label} denoise launches {launches}, want {want_dn} each (the rebuilds)")
    # every joint step's launches, replayed steps included (a graph's count
    # a replay times its replays)
    want = {k: v * n_joint for k, v in joint_step_launches(
        coach.dense_graphs, coach.n_modal, cfg.base.cl_method, coach.knn).items()}
    for e in epochs_rec:
        got = e["joint_launches"]
        check(all(got[k] == v for k, v in want.items()),
              f"{label} joint launches {got}, want {want}")
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


def phase_path_g(dev) -> dict:
    """Two epochs on data/tiktok_mini with the configuration of
    tests/test_regression_mini.py on the card: Recall@20 at seed 1818 in
    RECALL_BAND; the other seeds' recorded."""
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
    print(f"[path G] {json.dumps(rec)}")
    check(RECALL_BAND[0] <= metrics["Recall"] <= RECALL_BAND[1],
          f"G Recall@20 {metrics['Recall']} outside {RECALL_BAND}")
    return rec


def _joint_phase_work(coach, epoch: int, graphed: bool = True):
    """One more joint phase of a trained Coach at ``epoch``'s learning
    rate, on fresh negatives and a fresh permutation (the profiled part of
    a training path): replayed from the Coach's captured graph, or run
    eagerly (``graphed=False``)."""
    from diffmm_tpu_torch.data.sampling import negative_sampling
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.optim import cosine_lr

    cfg, data = coach.config, coach.data
    negs = negative_sampling(data.train_rows, data.train_store, coach.host.item_num,
                             generator=coach.generator)
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
    KNN graphs against the plain version on the card: K4's prototypes within
    its rule, each user's top-k set equal outside similarity ties (1e-6)."""
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
        gathered = feats.index_select(0, cols.long().clamp_max(feats.shape[0] - 1))
        got = sg.segsum(gathered, offsets)
        want = sg.segsum_plain(gathered, offsets)
        scale = sg.segsum_plain(gathered.abs(), offsets)
        proto_ok = bool(((got - want).abs() <= rtol * scale + atol).all())
        proto = want / torch.clamp_min(offsets.diff().to(torch.float32), 1.0)[:, None]
        sim = l2_normalize(proto, dim=1) @ l2_normalize(feats, dim=1).T
        plain_cols = torch.topk(sim, topk, dim=1).indices
        _, got_cols = knn.knn_edges(rows, cols, feats, U, topk)
        got_cols = got_cols.view(U, topk).long()
        check(torch.equal(adj.ui_cols.view(U, topk).long(), got_cols), f"K modality {m}: graph != knn_edges")
        kth = sim.gather(1, plain_cols[:, -1:])
        got_in = torch.zeros_like(sim, dtype=torch.bool).scatter_(1, got_cols, True)
        want_in = torch.zeros_like(sim, dtype=torch.bool).scatter_(1, plain_cols, True)
        differ = got_in ^ want_in
        ties_only = bool(((sim - kth).abs()[differ] <= 1e-6).all())
        checks.append({"modality": m, "width": int(feats.shape[1]), "prototypes_ok": proto_ok,
                       "prototype_max_abs_err": max_err(got, want), "edges_differing": int(differ.sum()),
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


def phase_path_m(dev, coach_e, report_dir: str) -> dict:
    """Path M: path E's index exported, loaded onto the card and served over
    HTTP on 127.0.0.1 (``eval/serve_http.py``, warmup k=20) in a thread:
    /health, the error paths, and 200 single-user ``/recommend?k=20``
    requests, each equal to a direct ``recommend`` (ids, scores bitwise);
    host-clock latencies of the requests (the first one, on a fresh server
    thread, apart) and of the direct calls (each ending in its host read)."""
    import threading

    import numpy as np
    import torch

    from diffmm_tpu_torch.eval import serve_http, serving

    path = os.path.join(report_dir, "index_E.npz")
    serving.save_index(serving.build_index(coach_e), path)
    index = serving.load_index(path)  # onto the card
    os.remove(path)
    check(index.u_final.device.type == "cuda", "M: the index is not on the card")
    U, I = index.u_final.shape[0], index.i_final.shape[0]
    srv = serve_http.make_server(index, "127.0.0.1", 0, warmup_ks=[20])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    health = _http_get(base + "/health")
    errors = [_http_get(base + q)[0] for q in
              ("/recommend", f"/recommend?user={U}&k=20", "/recommend?user=1&k=0", "/nope")]
    gen = torch.Generator().manual_seed(20)
    users = torch.randint(0, U, (200,), generator=gen).tolist()
    http_s, direct_s, same = [], [], []
    for u in users:
        t0 = time.perf_counter()
        code, body = _http_get(base + f"/recommend?user={u}&k=20")
        http_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ids, scores = serving.recommend(index, torch.tensor([u], dtype=torch.int32, device=dev), 20)
        ids, scores = ids[0].tolist(), scores[0].tolist()
        direct_s.append(time.perf_counter() - t0)
        same.append(code == 200 and body["items"] == ids and body["scores"] == scores)
    srv.shutdown()
    srv.server_close()
    thread.join()
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
    print(f"[path M] {json.dumps(rec)}")
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
    """Copies of a Coach's parameters, Adam moments, edge buffers and
    generator state."""
    from diffmm_tpu_torch.train.optim import tree_leaves

    out = tree_leaves(coach.gcn_params) + tree_leaves(coach.dn_params) + list(coach.edge_buffers)
    for s in (coach.gcn_opt_state, *coach.dn_opt_states):
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
    for counts in _counters():
        for k in counts:
            counts[k] = 0
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
    check(all(launches[k] >= v for k, v in want.items()), f"H launches {launches}, want at least {want}")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report-dir", default=os.path.join(REPO, "smoke_report"),
                    help="where the JSON report and the profile table are written")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import diffmm_tpu_torch  # noqa: F401  (fails here outside a checkout)

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
    report["path_M"] = phase_path_m(dev, coach_e, args.report_dir)
    report["profile_A"] = phase_profile(_rebuild_and_eval(coach_a), "A", args.report_dir)
    report["profile_C"] = phase_profile(_rebuild_and_eval(coach_c), "C", args.report_dir)
    report["profile_E_joint"] = phase_profile(_joint_phase_work(coach_e, 1), "E_joint", args.report_dir)
    report["profile_E_joint_eager"] = phase_profile(_joint_phase_work(coach_e, 1, graphed=False),
                                                    "E_joint_eager", args.report_dir)
    report["profile_F_joint"] = phase_profile(_joint_phase_work(coach_f, 0), "F_joint", args.report_dir)
    del coach_f

    # each kernel's launches come from this slice's path that runs it: K1-K3
    # from E (dense-form training), K4 from F (sparse-form training); the
    # other paths' beside them
    kernels = report["kernels"]
    rows = []
    for name, meta in KERNELS.items():
        main_path, others = ("F", "ABCDEH") if name == "segsum" else ("E", "ABCDFH")
        k = kernels["segsum_user" if name == "segsum" else name]
        launches = report[f"path_{main_path}"]["launches"][name]
        row = {"name": name, "route": "cuda", "source": meta["source"],
               "replaces": meta["replaces"], "launches": launches,
               **{f"launches_{p}": report[f"path_{p}"]["launches"][name] for p in others},
               **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}}
        if name == "spmm_dual":
            extra = {"bf16_store": kernels["spmm_dual_bf16"], "backward": kernels["spmm_dual_backward"],
                     "int4_store": kernels["spmm_dual_int4"],
                     "int4_backward": kernels["spmm_dual_int4_backward"]}
        elif name == "segsum":
            extra = {"cases": {key: rec for key, rec in kernels.items()
                               if key.startswith("segsum_") and key != "segsum_user"}}
        else:
            extra = {"yelp_shape": kernels[name + "_yelp"]}
            row.update({key: k[key] for key in ("bound_design_ms", "bound_design", "bound_f32_fma_ms",
                                                "max_err_vs_f64", "plain_max_err_vs_f64",
                                                "prepare_ms")})
        cases = [k, *(extra["cases"].values() if name == "segsum" else extra.values())]
        row.update(extra)
        row["ok"] = all(bool(c["ok"]) for c in cases) and launches > 0
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
