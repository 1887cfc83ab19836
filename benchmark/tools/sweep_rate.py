"""The highest request rate a serving cell sustains, by a sweep on the card.

    python3 -m benchmark.tools.sweep_rate --workload sports.serve --rates 1000,2000,3000 --seconds 5

One process, one index, the cell's open loop at each rate in turn (a short
closed-loop warm-up first). Per rate, one JSON line: the latency quantiles
from the due time, the service time, how late the generator started the
requests, and whether a backlog grew (the median lateness of the last tenth
of the requests against the first tenth's). PERF.md names the rate the cell
runs at (about 0.8 of the highest rate with no growing backlog).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from benchmark import run as bench
from benchmark.harness import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_rate: needs a CUDA card", file=sys.stderr)
        return 3
    manifest = json.load(open(os.path.join(bench.ROOT, "BENCHMARK.json")))
    r = bench.Run(manifest, args.workload, args.seed, args.seconds, False, torch.device("cuda", 0))
    inputs, _, _, index, server = serve.build(r)
    from diffmm_tpu_torch.eval.serving import warmup

    warmup(index, [int(r.traffic["k"])])
    due, users = serve.schedule(r.traffic, args.seconds, args.seed, inputs.user_num)
    serve.open_loop(server(500)[0], due[:500] * 0.0, users[:500])
    for rate in (float(x) for x in args.rates.split(",")):
        traffic = {**r.traffic, "rate_per_s": rate}
        due, users = serve.schedule(traffic, args.seconds, args.seed, inputs.user_num)
        lat, late, service = serve.open_loop(server(len(due))[0], due, users)
        tenth = max(1, len(late) // 10)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat),
            "p50_ms": serve.percentile(lat, 0.5) * 1e3, "p95_ms": serve.percentile(lat, 0.95) * 1e3,
            "p99_ms": serve.percentile(lat, 0.99) * 1e3,
            "service_p50_ms": serve.percentile(service, 0.5) * 1e3,
            "late_first_tenth_ms": float(np.median(late[:tenth])) * 1e3,
            "late_last_tenth_ms": float(np.median(late[-tenth:])) * 1e3,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
