"""Single-process scale probe: steady epoch seconds for one configuration,
the port of ``tools/scale_probe.py``.

N single epochs (the median of the steady ones, after the first, which
captures each phase's CUDA graph), optionally followed by a first fused
chunk of ``--scan`` epochs and ``--chunks`` timed ones. Prints one JSON line
with the JAX tool's keys (``--out`` also writes it to a file).

  python -m diffmm_tpu_torch.tools.scale_probe -c conf/yelp.toml --synthetic yelp \\
      --set train.graph_form=sparse --epochs 3 --scan 2 --chunks 2
  python -m diffmm_tpu_torch.tools.scale_probe -c conf/sports.toml --synthetic sports \\
      --set train.graph_form=sparse --epochs 3

``--synthetic`` names a shape of ``data/synthetic.py::SHAPES`` (yelp: path
F's data, 38,403 x 20,000; sports: the structured synthetic of
``tests/test_scale_accuracy.py``, 35,598 x 18,357), drawn from the config's
seed; without it the config's dataset is loaded. It runs on the card;
``--device cpu`` runs the plain versions on the CPU. ``backend`` is the
device type (``cuda`` or ``cpu``). The first fused chunk's time keeps the
JAX tool's name, ``fused_compile_chunk_s``, though the port compiles
nothing at run time: that chunk captures the phases' CUDA graphs only
where no single epoch ran before it (``--epochs 0``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from diffmm_tpu_torch.config import apply_overrides, load_config
from diffmm_tpu_torch.data.synthetic import SHAPES, host_data
from diffmm_tpu_torch.utils.device import resolve_device, synchronize
from diffmm_tpu_torch.utils.logging import NullLog


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", "-c", default="conf/yelp.toml")
    ap.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL")
    ap.add_argument("--epochs", type=int, default=3, help="single epochs")
    ap.add_argument("--scan", type=int, default=0,
                    help="fused chunk length (0 = skip the fused chunks)")
    ap.add_argument("--chunks", type=int, default=2,
                    help="timed fused chunks after the first one")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu (plain PyTorch versions)")
    ap.add_argument("--synthetic", default=None, choices=sorted(SHAPES),
                    help="synthesise the data at this dataset's shape")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from diffmm_tpu_torch.train.coach import Coach

    config = load_config(args.config)
    apply_overrides(config, args.set)
    host = host_data(config, args.synthetic)
    coach = Coach(config, host, device=dev, log=NullLog())

    result = {
        "config": args.config,
        "set": args.set,
        "backend": dev.type,
        "shape": [host.user_num, host.item_num],
        "nnz": int(host.nnz),
        "graph_form": "dense" if coach.dense_graphs else "sparse",
        "train_store": coach.train_store_form,
    }

    times = []
    for ep in range(args.epochs):
        t0 = time.perf_counter()
        coach.train_epoch(ep)
        synchronize(dev)
        times.append(round(time.perf_counter() - t0, 3))
        print(f"epoch {ep}: {times[-1]:.2f}s", file=sys.stderr, flush=True)
    steady = sorted(times[1:]) if len(times) > 1 else times
    result["epoch_s_all"] = times
    # --epochs 0: a fused-only probe
    result["epoch_s_median_steady"] = steady[len(steady) // 2] if steady else None

    if args.scan > 1:
        ep0 = args.epochs
        t0 = time.perf_counter()
        coach.train_epochs_fused(ep0, args.scan)
        synchronize(dev)
        result["fused_compile_chunk_s"] = round(time.perf_counter() - t0, 1)
        f_times = []
        for i in range(1, args.chunks + 1):
            t0 = time.perf_counter()
            coach.train_epochs_fused(ep0 + i * args.scan, args.scan)
            synchronize(dev)
            f_times.append(round((time.perf_counter() - t0) / args.scan, 3))
            print(f"fused chunk {i}: {f_times[-1]:.3f}s/epoch (scan={args.scan})",
                  file=sys.stderr, flush=True)
        result["fused_scan"] = args.scan
        result["fused_epoch_s_all"] = f_times
        result["fused_epoch_s_median"] = sorted(f_times)[len(f_times) // 2]

    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
