"""Benchmark: training epoch throughput on the card, the port of ``bench.py``.

    python -m diffmm_tpu_torch.bench --synthetic tiktok      # on the card
    BENCH_SET=data.name=synthetic:64x48 python -m diffmm_tpu_torch.bench --device cpu

Prints ONE JSON line with the keys of the JAX bench's (``bench.py:221-256``),
``detail`` included; progress goes to stderr. Its parts, in the JAX bench's
order:

* ``BENCH_EPOCHS`` (6) single epochs of ``conf/test.toml``; the headline
  single-epoch time is the median of the steady ones (the second and
  later: the first captures each phase's CUDA graph);
* three fenced epochs (``train_epoch(fence=True)``: the card drained at
  every phase boundary) for the per-phase attribution;
* ``BENCH_FUSED`` (10) epochs a fused chunk (``train_epochs_fused``), one
  warm chunk, then three timed, the median per epoch;
* eval (``test_epoch``), the median of the calls after the first;
* the sparse form with its O(nnz) CSR train store and ``BENCH_SPARSE_COMPUTE``
  (bf16 by default) messages: ``max(3, BENCH_EPOCHS // 2)`` single epochs
  and ``BENCH_SPARSE_FUSED`` epochs a fused chunk, as above
  (``BENCH_SPARSE=0`` skips it);
* the headline: epochs/hr of the faster of the single and the fused epoch;
* each phase's median over the steady epochs, and over the fenced ones.

``BENCH_SET="train.dense_store=int4,base.denoise_param_dtype=bf16"`` sets
config overrides, spelled as the CLI's ``--set``. Every median is the JAX
bench's ``sorted(v)[len(v) // 2]``.

Where it differs from the JAX bench:

* ``jax.block_until_ready`` is ``torch.cuda.synchronize``.
* It runs on the card; ``--device cpu`` runs the kernels' plain versions on
  the CPU instead, and without a card and without that flag it stops with
  an error. ``--synthetic tiktok|yelp|sports`` synthesises the data at that
  dataset's shape from the config's seed (``data/synthetic.py::SHAPES``);
  without it the config's dataset is loaded, and a missing one is an error
  that names the option.
* ``joint_hbm_roofline_fraction`` (dense form, on the card only; null on the
  CPU): the least time one joint step could take, the K1 launches of a
  steady fenced epoch's joint phase a block (its graph replays counted,
  ``ops/kernels`` ``launch_counts``; no other phase launches K1), each
  reading one block's storage (int8, bf16 or packed int4) at 3.35 TB/s,
  over the fenced joint phase's median time a block. K1 reads M once for
  both directions, so the JAX bench's 26 passes at its TPU's rate do not
  hold here.
* ``vs_baseline``: ``bench_baseline.json`` holds the PyTorch reference's
  epoch on another machine's CPU on the real tiktok data; the ratio is
  given only on that dataset (null on any synthetic data), and
  ``baseline_epoch_seconds`` is printed beside it either way.
* ``device``: the card's name and power limit as ``nvidia-smi`` gives them
  (``cpu`` on the CPU).
* Nothing compiles a run's programs, so the JAX bench's skip of the fused
  rows after a slow first compile has no counterpart.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import torch

from diffmm_tpu_torch.config import apply_overrides, load_config
from diffmm_tpu_torch.data.synthetic import SHAPES, host_data
from diffmm_tpu_torch.utils.device import HBM_BYTES_S, describe, resolve_device, synchronize
from diffmm_tpu_torch.utils.logging import NullLog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _median(values: list[float]) -> float:
    return sorted(values)[len(values) // 2]


def _median_steady(values: list[float]) -> float:
    """The median of the values after the first (all of them if one)."""
    return _median(values[1:] if len(values) > 1 else values)


def _progress(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def _memory(dev: torch.device, section: dict) -> None:
    """The card's peak memory since the section's Coach was made."""
    if dev.type == "cuda":
        section["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        _progress(f"peak memory: {section['peak_mem_bytes'] / 2**30:.3f} GiB")


def _fused_chunks(coach, ep0: int, scan: int, dev, label: str) -> float:
    """One warm chunk of ``scan`` epochs from ``ep0``, then three timed:
    the median seconds an epoch."""
    coach.train_epochs_fused(ep0, scan)
    synchronize(dev)
    times = []
    for i in range(1, 4):
        t0 = time.perf_counter()
        coach.train_epochs_fused(ep0 + i * scan, scan)
        synchronize(dev)
        times.append((time.perf_counter() - t0) / scan)
        _progress(f"{label}fused chunk {i}: {times[-1]:.3f}s/epoch (scan={scan})")
    return _median(times)


def main(argv: list[str] | None = None, sections: dict | None = None) -> int:
    """Run the bench and print its line. ``sections``, when given, is filled
    with each Coach's kernel launches (``ops/kernels`` ``launch_counts``
    over its part) and, on the card, its peak memory: ``{"dense": {...},
    "sparse": {...}}``."""
    ap = argparse.ArgumentParser(description="training epoch throughput of the port")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu (plain PyTorch versions)")
    ap.add_argument("--synthetic", default=None, choices=sorted(SHAPES),
                    help="synthesise the data at this dataset's shape (the real files are not here)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sections = {} if sections is None else sections
    epochs = int(os.environ.get("BENCH_EPOCHS", "6"))

    from diffmm_tpu_torch.ops.kernels import launch_counts
    from diffmm_tpu_torch.train.coach import Coach

    def launches_since(before: dict) -> dict:
        after = launch_counts()
        return {k: after[k] - before.get(k, 0) for k in after}

    config = load_config(os.path.join(REPO, "conf", "test.toml"))
    overrides = [o for o in os.environ.get("BENCH_SET", "").split(",") if o]
    if overrides:
        apply_overrides(config, overrides)
        for override in overrides:
            _progress(f"override: {override}")
    host = host_data(config, args.synthetic)
    log = NullLog()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    coach = Coach(config, host, device=dev, log=log)

    times = []
    phase_times: dict[str, list[float]] = {}
    for ep in range(epochs):
        coach.timer.reset()
        t0 = time.perf_counter()
        coach.train_epoch(ep)
        synchronize(dev)
        times.append(time.perf_counter() - t0)
        for name, total in coach.timer.totals.items():
            phase_times.setdefault(name, []).append(total)
        _progress(f"epoch {ep}: {times[-1]:.2f}s")

    # Fenced attribution: the card drained at every phase boundary, so each
    # phase's time is its own (an unfenced phase that ends in queued work
    # bills it to the next phase that waits). The unfenced totals stay the
    # headline, as in the JAX bench; these attribute it.
    fenced_phase_times: dict[str, list[float]] = {}
    k1_joint = None
    for ep in range(3):
        coach.timer.reset()
        k1_before = launch_counts()["spmm_dual"]
        coach.train_epoch(epochs + ep, fence=True)
        k1_joint = launch_counts()["spmm_dual"] - k1_before
        for name, total in coach.timer.totals.items():
            fenced_phase_times.setdefault(name, []).append(total)

    fused_epoch_s = None
    fused_scan = int(os.environ.get("BENCH_FUSED", "10"))
    if fused_scan > 1:
        fused_epoch_s = _fused_chunks(coach, epochs + 3, fused_scan, dev, "")

    # Eval: full-catalog ranking over all test users; the first call apart
    eval_times = []
    for _ in range(4):
        t0 = time.perf_counter()
        coach.test_epoch()
        synchronize(dev)
        eval_times.append(time.perf_counter() - t0)
    eval_s = _median(eval_times[1:])
    _progress(f"eval: {eval_s:.3f}s")
    sections["dense"] = {"launches": launches_since(before)}
    _memory(dev, sections["dense"])
    dense_graphs = coach.dense_graphs
    block_bytes = coach.data.adj.mat.numel() * coach.data.adj.mat.element_size() if dense_graphs else 0
    del coach

    # The sparse form (the JAX package's form for catalogs whose (U, I)
    # blocks do not fit; BENCH_SPARSE=0 skips it), with its CSR train store
    # and bf16 messages (BENCH_SPARSE_COMPUTE=f32 reverts)
    sparse_epoch_s = sparse_fused_epoch_s = sparse_train_store = None
    if os.environ.get("BENCH_SPARSE", "1") != "0":
        s_config = copy.deepcopy(config)
        s_config.train.graph_form = "sparse"
        s_config.train.segsum_compute = os.environ.get("BENCH_SPARSE_COMPUTE", "bf16")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        before = launch_counts()
        s_coach = Coach(s_config, host, device=dev, log=log)
        sparse_train_store = s_coach.train_store_form
        n_sparse = max(3, epochs // 2)
        s_times = []
        for ep in range(n_sparse):
            t0 = time.perf_counter()
            s_coach.train_epoch(ep)
            synchronize(dev)
            s_times.append(time.perf_counter() - t0)
            _progress(f"sparse epoch {ep}: {s_times[-1]:.2f}s")
        sparse_epoch_s = _median_steady(s_times)
        sf_scan = int(os.environ.get("BENCH_SPARSE_FUSED", str(fused_scan or 10)))
        if sf_scan > 1:
            sparse_fused_epoch_s = _fused_chunks(s_coach, n_sparse, sf_scan, dev, "sparse ")
        sections["sparse"] = {"launches": launches_since(before)}
        _memory(dev, sections["sparse"])
        del s_coach

    epoch_s = _median_steady(times)
    # Headline: the faster sustained-training path; the single-epoch median
    # stays in detail
    headline_s, headline_path = epoch_s, "single_epoch"
    if fused_epoch_s is not None and fused_epoch_s < epoch_s:
        headline_s, headline_path = fused_epoch_s, f"fused_epoch_scan{fused_scan}"

    phase_medians = {k: round(_median_steady(v), 4) for k, v in phase_times.items()}
    fenced_medians = {k: round(_median(v), 4) for k, v in fenced_phase_times.items()}

    roofline_fraction = None
    joint_s = fenced_medians.get("joint") or phase_medians.get("joint")
    if dev.type == "cuda" and dense_graphs and joint_s:
        n_joint_blocks = max(1, -(-host.nnz // config.train.batch))
        bound_s = k1_joint / n_joint_blocks * block_bytes / HBM_BYTES_S
        roofline_fraction = round(bound_s / (joint_s / n_joint_blocks), 3)

    with open(os.path.join(REPO, "bench_baseline.json")) as fh:
        baseline = json.load(fh)
    ref_epoch_s = baseline["epoch_seconds_median"]
    vs_baseline = round(ref_epoch_s / headline_s, 2) if host.name == baseline["dataset"] else None

    print(json.dumps({
        "metric": "tiktok_train_epoch_throughput",
        "value": round(3600.0 / headline_s, 1),
        "unit": "epochs/hr",
        "vs_baseline": vs_baseline,
        "detail": {
            "headline_epoch_seconds": round(headline_s, 3),
            "headline_path": headline_path,
            "epoch_seconds_median_steady": round(epoch_s, 3),
            "fused_epoch_seconds_median": round(fused_epoch_s, 3) if fused_epoch_s else None,
            "epoch_seconds_all": [round(t, 2) for t in times],
            "phase_seconds_median_steady": phase_medians,
            "phase_seconds_fenced": fenced_medians,
            "joint_hbm_roofline_fraction": roofline_fraction,
            "eval_seconds_median": round(eval_s, 3),
            "sparse_epoch_seconds_median": round(sparse_epoch_s, 3) if sparse_epoch_s else None,
            "sparse_fused_epoch_seconds_median": (
                round(sparse_fused_epoch_s, 3) if sparse_fused_epoch_s else None
            ),
            "sparse_train_store": sparse_train_store,
            "baseline": "torch-CPU reference epoch (bench_baseline.json)",
            "baseline_epoch_seconds": ref_epoch_s,
            "device": describe(dev),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
