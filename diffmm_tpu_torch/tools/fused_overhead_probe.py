"""Attribute a fused chunk's wall time: host preparation and upload against
the card's work, the port of ``tools/fused_overhead_probe.py``.

It prints the JAX tool's lines:

* ``upload probe``: one permutation-sized int32 block (``scan`` epochs of
  the joint blocks' interaction indices) copied to the card and summed
  there, the MB/s of that round trip;
* ``compile+first chunk``: the first chunk of ``scan`` epochs with the eval
  of each ``tstEpoch`` boundary on the card (``train_epochs_fused(e, scan,
  eval_split="test")``). On the card nothing compiles at run time: this
  chunk's first epoch runs each phase's first block eagerly and captures
  its CUDA graph (``train/graphs.py``), which is what makes it longer than
  the rest; the kernels were built before it (``ops/kernels``);
* three steady chunks, each as ``call`` (the host's draws, their upload,
  the chunk's launches and its one read of the results at the end) and
  ``device drain`` (what the card still had queued when the call returned),
  and the wall seconds an epoch.

  python -m diffmm_tpu_torch.tools.fused_overhead_probe conf/tiktok_tuned.toml 10 --synthetic tiktok

It runs on the card; ``--device cpu`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from diffmm_tpu_torch.config import apply_overrides, load_config
from diffmm_tpu_torch.data.synthetic import SHAPES, host_data
from diffmm_tpu_torch.utils.device import resolve_device
from diffmm_tpu_torch.utils.logging import NullLog


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="conf/tiktok_tuned.toml")
    ap.add_argument("scan", nargs="?", type=int, default=10, help="epochs a chunk")
    ap.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu (plain PyTorch versions)")
    ap.add_argument("--synthetic", default=None, choices=sorted(SHAPES),
                    help="synthesise the data at this dataset's shape")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    scan = args.scan

    from diffmm_tpu_torch.train.coach import Coach

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    cfg.train.epoch_scan = scan
    host = host_data(cfg, args.synthetic)
    coach = Coach(cfg, host, device=dev, log=NullLog())

    # upload bandwidth probe: one permutation-block-sized array
    nb_j = -(-host.nnz // cfg.train.batch)
    blob = np.random.randint(0, host.nnz, size=(scan, nb_j, cfg.train.batch)).astype(np.int32)
    t0 = time.perf_counter()
    on_dev = torch.as_tensor(blob, device=dev)
    float(on_dev.sum())  # the transfer and a small reduction, read back
    up_s = time.perf_counter() - t0
    mb = blob.nbytes / 1e6
    print(f"upload probe: {mb:.1f} MB in {up_s:.2f}s = {mb / up_s:.1f} MB/s", flush=True)

    t0 = time.perf_counter()
    coach.train_epochs_fused(0, scan, eval_split="test")
    float(coach.gcn_params["u_embs"][0, 0])
    print(f"compile+first chunk: {time.perf_counter() - t0:.1f}s", flush=True)

    # steady chunks: the call (which ends in the chunk's one read of its
    # results), then whatever the card still had queued
    for i in range(1, 4):
        t0 = time.perf_counter()
        coach.train_epochs_fused(i * scan, scan, eval_split="test")
        t1 = time.perf_counter()
        float(coach.gcn_params["u_embs"][0, 0])
        t2 = time.perf_counter()
        print(
            f"chunk {i}: call(incl. host prep+upload+result fetch)="
            f"{t1 - t0:.2f}s  +device drain={t2 - t1:.2f}s  "
            f"-> {(t2 - t0) / scan:.3f}s/epoch wall",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
