#!/usr/bin/env python3
"""Smoke run of diffmm_tpu_torch on one NVIDIA card (the port's quickest
proof that it still starts on the GPU).

    python3 chip_smoke.py                 # one card

It runs every phase below, in order; any error fails the run (non-zero
exit, no result line):

1. build: every kernel source (``diffmm_tpu_torch/csrc/*.cu``) with one
   ``nvcc`` each, all at once; prints ptxas's register/shared-memory lines.
2. kernels: each kernel's wrapper on card tensors at the main path's shapes
   (K1 ``spmm_dual`` at U 9,308 x I 6,710 x d 64, int8 and bf16 storage;
   K2/K3 ``denoise_mlp`` at B 1,024, I 6,710, H 1,024) against its plain
   PyTorch version within the stated tolerance; times (CUDA events, warm,
   many launches) of the kernel, the plain version and one PyTorch library
   call computing the same function, beside the bound.
3. reference: a tiny synthetic Coach on the card against the same Coach on
   the CPU (plain versions) with the same parameters.
4. path A (tiktok shape): synthetic 9,308 x 6,710 at density 0.000953,
   feature widths 128/768/128, conf/test.toml hypers, seed 1818: rebuild ->
   test_epoch -> build_index -> 8 recommend requests (k=20).
5. path B: the same on data/tiktok_mini at full model width (latdim 64,
   hidden 1,024) with batch 256, so its real degree skew gives the
   two-bucket rebuild plan.

It then prints a ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. A full report
(``chip_smoke.json``) and the profile table go to ``--report-dir``
(``smoke_report/`` by default, listed in ``.gitignore``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense): HBM bytes/s, bf16 and f32 FLOP/s.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# Tolerances of kernel vs plain version (elementwise, torch.allclose):
# K1 sums exact products (0/1 x bf16) in f32 in another order than the
# plain f32 matmul: rtol 1e-5, atol 1e-5. K2/K3 sum 6,710 (K2) or 1,024
# (K3) f32 products in another order than cuBLAS (no TF32 on either side):
# rtol 1e-5, atol 5e-5.
TOL = {"spmm_dual": (1e-5, 1e-5), "denoise_layer1": (1e-5, 5e-5), "denoise_layer2": (1e-5, 5e-5)}

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
}


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
            if "registers" in line or "spill" in line or "error" in line.lower():
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

    # K1 at tiktok shape: realistic density (the kernel's work is dense)
    U, I, d = 9308, 6710, 64
    mask = torch.rand((U, I), generator=gen, device=dev) < 0.000953
    z_u = torch.randn((U, d), generator=gen, device=dev)
    z_i = torch.randn((I, d), generator=gen, device=dev)
    zu16, zi16 = z_u.to(torch.bfloat16), z_i.to(torch.bfloat16)
    rtol, atol = TOL["spmm_dual"]
    for store in (torch.int8, torch.bfloat16):
        # the dense adjacency's layout: rows on 16-byte boundaries
        mat = sd.dense_storage(U, I, store, dev)
        mat.copy_(mask)
        yu, yi = sd.spmm_dual(mat, z_u, z_i)
        pu, pi = sd.spmm_dual_plain(mat, z_u, z_i)
        torch.cuda.synchronize()
        err = max(max_err(yu, pu), max_err(yi, pi))
        ok = torch.allclose(yu, pu, rtol=rtol, atol=atol) and torch.allclose(yi, pi, rtol=rtol, atol=atol)
        check(ok, f"spmm_dual[{store}] vs plain: max_abs_err {err}")
        m16 = mask.to(torch.bfloat16)
        n_bytes = mat.numel() * mat.element_size() + (U + I) * d * 2 + (U + I) * d * 4
        b, by = bound_ms(n_bytes, 2 * 2 * U * I * d, BF16_FLOPS)
        rec = {
            "ok": ok,
            "max_abs_err": err,
            "ms": time_ms(lambda: sd.spmm_dual(mat, z_u, z_i), 50),
            "plain_ms": time_ms(lambda: sd.spmm_dual_plain(mat, z_u, z_i), 10),
            "bound_ms": b,
            "bound_by": by,
            "library_ms": time_ms(lambda: (m16 @ zi16, m16.T @ zu16), 50),
        }
        del m16
        key = "spmm_dual" if store == torch.int8 else "spmm_dual_bf16"
        out[key] = rec
        print(f"[kernels] {key}: {json.dumps(rec)}")

    # K2/K3 at the rebuild's shape
    B, K, H = 1024, 6710, 1024
    x = torch.randn((B, K), generator=gen, device=dev)
    w1x = torch.randn((K, H), generator=gen, device=dev) * math.sqrt(2.0 / (K + 10 + H))
    tp = torch.randn((B, H), generator=gen, device=dev) * 0.1
    w2 = torch.randn((H, K), generator=gen, device=dev) * math.sqrt(2.0 / (H + K))
    b2 = torch.randn((K,), generator=gen, device=dev) * 0.001
    h = dm.layer1_plain(x, w1x, tp)
    full = dm.fused_denoise_mlp(x, w1x, tp, w2, b2)
    want_full = dm.layer2_plain(h, w2, b2)
    for name, kern, plain, lib_call, n_bytes, flops in (
        ("denoise_layer1", lambda: dm.denoise_layer1(x, w1x, tp),
         lambda: dm.layer1_plain(x, w1x, tp),
         lambda: torch.tanh(torch.addmm(tp, x, w1x)),
         (B * K + K * H + 2 * B * H) * 4, 2 * B * K * H),
        ("denoise_layer2", lambda: dm.denoise_layer2(h, w2, b2),
         lambda: dm.layer2_plain(h, w2, b2),
         lambda: torch.addmm(b2, h, w2),
         (B * H + H * K + K + B * K) * 4, 2 * B * H * K),
    ):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        rtol, atol = TOL[name]
        err = max_err(got, want)
        ok = torch.allclose(got, want, rtol=rtol, atol=atol)
        check(ok, f"{name} vs plain: max_abs_err {err}")
        b, by = bound_ms(n_bytes, flops, F32_FLOPS)
        rec = {
            "ok": ok,
            "max_abs_err": err,
            "ms": time_ms(kern, 20),
            "plain_ms": time_ms(plain, 20),
            "bound_ms": b,
            "bound_by": by,
            "library_ms": time_ms(lib_call, 20),
        }
        out[name] = rec
        print(f"[kernels] {name}: {json.dumps(rec)}")
    err = max_err(full, want_full)
    check(torch.allclose(full, want_full, rtol=1e-5, atol=1e-4), f"fused_denoise_mlp: {err}")
    print(f"[kernels] fused_denoise_mlp wrapper vs plain: max_abs_err {err}")
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


def phase_reference(dev) -> dict:
    """A tiny Coach on the card (kernels) against the same Coach on the CPU
    (plain versions), same data and parameters."""
    import torch

    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.train.coach import Coach

    cfg = _small_config()
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
    # same graphs on both sides, then forward + eval
    gpu.edge_buffers = [b.to(dev) for b in bufs_c]
    gpu.modal_adjs = [gpu._make_adj(gpu.data.train_rows, b) for b in gpu.edge_buffers]
    u_c, i_c = cpu.forward()
    u_g, i_g = gpu.forward()
    err = max(max_err(u_g.cpu(), u_c), max_err(i_g.cpu(), i_c))
    check(torch.allclose(u_g.cpu(), u_c, rtol=1e-2, atol=1e-3)
          and torch.allclose(i_g.cpu(), i_c, rtol=1e-2, atol=1e-3), f"embeddings: {err}")
    m_c = cpu.test_epoch(embeddings=(u_c, i_c))
    m_g = gpu.test_epoch(embeddings=(u_c.to(dev), i_c.to(dev)))
    check(all(abs(m_c[k] - m_g[k]) < 1e-6 for k in m_c), f"metrics {m_c} vs {m_g}")
    rec = {"edge_agreement": same, "embedding_max_abs_err": err, "metrics": m_g}
    print(f"[reference] {json.dumps(rec)}")
    return rec


def drive_path(dev, cfg, host, label: str) -> dict:
    """Rebuild -> test_epoch -> build_index -> 8 recommend requests, with
    every kernel counter set to 0 just before and read just after."""
    import torch

    from diffmm_tpu_torch.eval.serving import build_index, recommend
    from diffmm_tpu_torch.ops.kernels import denoise_mlp as dm
    from diffmm_tpu_torch.ops.kernels import spmm_dual as sd
    from diffmm_tpu_torch.train.coach import Coach

    times = {}

    def fence(name, t0):
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    coach = Coach(cfg, host, device=dev)
    fence("setup_s", t0)
    torch.cuda.reset_peak_memory_stats(dev)
    for counts in (sd.LAUNCHES, dm.LAUNCHES):
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
    launches = {**sd.LAUNCHES, **dm.LAUNCHES}
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
    per_fwd = coach.n_modal + 2  # one per modality graph, two over the main graph
    blocks = sum(int(b.shape[0]) for b in coach.rebuild_blocks)
    want_dn = coach.n_modal * cfg.hyper.steps * blocks
    check(launches["spmm_dual"] >= per_fwd * n_fwd, f"{label} spmm_dual launches {launches}")
    check(launches["denoise_layer1"] == want_dn and launches["denoise_layer2"] == want_dn,
          f"{label} denoise launches {launches}, want {want_dn} each")
    rec = {
        "shape": [host.user_num, host.item_num, host.nnz],
        "metrics": metrics,
        "times": times,
        "peak_mem_bytes": peak,
        "launches": launches,
        "rebuild_widths": list(coach.rebuild_widths),
        "gcn_forwards": n_fwd,
    }
    print(f"[path {label}] {json.dumps(rec)}")
    return rec


def _tiktok_shape():
    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data

    cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
    t0 = time.perf_counter()
    host = make_synthetic_host_data(
        cfg, user_num=9308, item_num=6710, density=0.000953,
        feat_dims=[128, 768, 128], seed=cfg.base.seed,
    )
    print(f"[path A] synthetic data in {time.perf_counter() - t0:.1f} s")
    return cfg, host


def phase_path_a(dev) -> dict:
    return drive_path(dev, *_tiktok_shape(), "A")


def phase_profile(dev, report_dir: str) -> dict:
    """torch.profiler over one warm rebuild + eval at tiktok shape: device
    time by kernel name and the device's busy share of the wall time. The
    table goes to ``<report_dir>/profile_path_A.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffmm_tpu_torch.train.coach import Coach

    cfg, host = _tiktok_shape()
    coach = Coach(cfg, host, device=dev)
    coach.rebuild_graphs()
    coach.test_epoch()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        coach.rebuild_graphs()
        coach.test_epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # kernel rows only (the operator rows carry their kernels' time too)
    kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    busy = sum(dev_us.values()) / 1e6
    top = sorted(((v, k) for k, v in dev_us.items() if v > 0), reverse=True)[:14]
    with open(os.path.join(report_dir, "profile_path_A.txt"), "w") as fh:
        fh.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    counts = {e.key: e.count for e in kernels}
    rec = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
           "top_device_ms": [[k[:60], v / 1e3, counts[k]] for v, k in top]}
    print(f"[profile A] {json.dumps(rec)}")
    return rec


def phase_path_b(dev) -> dict:
    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.data.loader import load_host_data

    cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
    cfg.data.name = "tiktok_mini"
    # 600 users make one block at batch 1024; at 256 the real degree skew
    # (max 576, median 2) gives the two-bucket rebuild plan
    cfg.train.batch = 256
    host = load_host_data(cfg, data_root=os.path.join(REPO, "data"))
    rec = drive_path(dev, cfg, host, "B")
    check(len(rec["rebuild_widths"]) == 2, f"B rebuild plan {rec['rebuild_widths']}")
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
    report["path_A"] = phase_path_a(dev)
    report["path_B"] = phase_path_b(dev)
    report["profile_A"] = phase_profile(dev, args.report_dir)

    rows = []
    for name, meta in KERNELS.items():
        k = report["kernels"][name]
        launches = report["path_A"]["launches"][name]
        row = {"name": name, "route": "cuda", "source": meta["source"],
               "replaces": meta["replaces"], "launches": launches,
               "launches_B": report["path_B"]["launches"][name],
               **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
               "ok": bool(k["ok"]) and launches > 0}
        if name == "spmm_dual":
            row["bf16_store"] = report["kernels"]["spmm_dual_bf16"]
            row["ok"] = row["ok"] and bool(row["bf16_store"]["ok"])
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
