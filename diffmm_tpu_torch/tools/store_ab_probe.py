"""Interleaved A/B of the sparse form's train store: the dense (U, I) store
against the O(nnz) CSR store, the port of ``tools/store_ab_probe.py``.

Two Coaches in one process on the sparse graph form, one a store, each
warmed by one epoch, then fenced single epochs (``train_epoch(fence=True)``,
per-phase times) and fused chunks interleaved A, B, A, B, so that whatever
drifts on the host hits both arms alike. The store answers the membership
questions of negative sampling, of the diffusion rows and of the eval mask;
the joint phase reads neither. Prints one JSON line with the JAX tool's keys
(``--out`` also writes it); each arm's peak card memory goes to stderr.

  python -m diffmm_tpu_torch.tools.store_ab_probe -c conf/tiktok_tuned.toml --synthetic tiktok --chunks 3

Where it differs from the JAX tool: each arm counts its own epochs, so the
two arms train the same run (same learning rates, same draws) and their
losses agree (the JAX tool's arms share one epoch counter); the first
chunk of each arm replays graphs its epochs captured already (the port
compiles nothing at run time); ``backend`` is the device type. It runs on
the card; ``--device cpu`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch

from diffmm_tpu_torch.config import apply_overrides, load_config
from diffmm_tpu_torch.data.synthetic import SHAPES, host_data
from diffmm_tpu_torch.utils.device import resolve_device, synchronize
from diffmm_tpu_torch.utils.logging import NullLog

STORES = ("dense", "csr")


def measure(base, host, dev, chunks: int, fenced: int, scan: int) -> tuple[dict, dict]:
    """The interleaved runs on the sparse form of ``base``. Returns the
    line's measured part (``fused_epoch_s``, ``fenced_phase_s``) and each
    arm's losses, epoch by epoch."""
    from diffmm_tpu_torch.train.coach import Coach

    coaches, peaks = {}, {}
    for store in STORES:
        cfg = copy.deepcopy(base)
        cfg.train.graph_form = "sparse"
        cfg.train.train_store = store
        coaches[store] = Coach(cfg, host, device=dev, log=NullLog())
        if coaches[store].train_store_form != store:
            raise RuntimeError(f"asked for the {store} store, the Coach made {coaches[store].train_store_form}")
    losses: dict[str, list[dict]] = {s: [] for s in STORES}
    epoch = dict.fromkeys(STORES, 0)

    def arm(store: str, train, n: int = 1) -> float:
        """One step of an arm (an epoch or a chunk of n) from its own epoch
        counter; returns the wall seconds an epoch, the card drained."""
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = train(epoch[store])
        synchronize(dev)
        wall = (time.perf_counter() - t0) / n
        losses[store].extend(out if isinstance(out, list) else [out])
        epoch[store] += n
        if dev.type == "cuda":
            peaks[store] = max(peaks.get(store, 0), torch.cuda.max_memory_allocated(dev))
        return wall

    for store, coach in coaches.items():  # warm: each phase's graph captured
        arm(store, coach.train_epoch)

    phases: dict[str, dict[str, list[float]]] = {s: {} for s in STORES}
    for _ in range(fenced):
        for store, coach in coaches.items():
            coach.timer.reset()
            arm(store, lambda e, c=coach: c.train_epoch(e, fence=True))
            for name, total in coach.timer.totals.items():
                phases[store].setdefault(name, []).append(total)

    fused: dict[str, list[float]] = {s: [] for s in STORES}
    for store, coach in coaches.items():  # the first chunk of each arm, untimed
        arm(store, lambda e, c=coach: c.train_epochs_fused(e, scan), scan)
    for _ in range(chunks):
        for store, coach in coaches.items():
            fused[store].append(arm(store, lambda e, c=coach: c.train_epochs_fused(e, scan), scan))
            print(f"fused[{store}]: {fused[store][-1]:.3f}s/epoch", file=sys.stderr, flush=True)
    for store, peak in peaks.items():
        print(f"peak memory[{store}]: {peak / 2**30:.3f} GiB", file=sys.stderr, flush=True)

    med = lambda v: round(float(np.median(v)), 4)  # noqa: E731  (the JAX tool's median)
    return {
        "fused_epoch_s": {s: med(v) for s, v in fused.items()},
        "fenced_phase_s": {s: {k: med(v) for k, v in ph.items()} for s, ph in phases.items()},
    }, losses


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", "-c", default="conf/tiktok_tuned.toml")
    ap.add_argument("--chunks", type=int, default=3, help="fused chunks per arm")
    ap.add_argument("--fenced", type=int, default=3, help="fenced epochs per arm")
    ap.add_argument("--scan", type=int, default=10, help="epochs per fused chunk")
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu (plain PyTorch versions)")
    ap.add_argument("--synthetic", default=None, choices=sorted(SHAPES),
                    help="synthesise the data at this dataset's shape")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = load_config(args.config)
    apply_overrides(base, args.set)
    host = host_data(base, args.synthetic)
    measured, _ = measure(base, host, dev, args.chunks, args.fenced, args.scan)
    line = json.dumps({"config": args.config, "backend": dev.type, "scan": args.scan, **measured})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
