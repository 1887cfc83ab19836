"""Readings for the correctness limits of a cell, on the card.

    python3 -m benchmark.tools.calibrate --workload tiktok.train --seeds 11,12,13 \\
        --candidates program,control,half [--set config.program.train.segsum_compute=bf16]

For each seed, the numbers that decide ``correct`` (``harness/checks.py``)
of each candidate against the reference: ``program`` the program as the
cell's window drives it (its first ``checked_steps`` steps; no window),
``control`` the reference in the nearest precision below the
configuration's (TF32 products for float32) in the program's place, and a
planted fault: ``half`` (training: each block's losses over half of its
rows) or ``alter`` (serving: one served item of every answer replaced by the
next one below the top k). ``--set`` changes a setting of the program's
run (a lower-precision path of the program's own, read as a control); the
reference keeps the configuration as stated. One JSON line per seed and
candidate on standard output. PERF.md sets each limit from these readings.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import numpy as np
import torch

from benchmark import run as bench
from benchmark.harness import checks, serve, train


def train_readings(r, candidates: list[str], program_set: dict):
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import NullLog

    inputs = train.make_inputs(r.config["data"], r.seed, r.device)
    spec = r.config["program"]
    n_steps = int(r.traffic["checked_steps"])
    scan = max(1, int(spec["train"].get("epoch_scan", 1)))
    cands = {}
    if "program" in candidates:
        pc = train.program_config(r, inputs)
        for key, value in program_set.items():
            section, name = key.split(".")[-2:]
            setattr(getattr(pc, section), name, value)
        coach = Coach(pc, train.host_data(inputs), device=r.device, log=NullLog())
        cands["program"] = train.program_records(coach, train.ProgramSteps(coach, scan, r.traffic["eval_split"]),
                                                 n_steps, inputs)
        del coach
        gc.collect()
        torch.cuda.empty_cache()
    truth = train.reference_records(spec, inputs, r.seed, r.device, 1, scan)
    follower = train.Reference(spec, inputs, r.seed, r.device)
    for name in candidates:
        if name == "control":
            cands[name] = train.reference_records(spec, inputs, r.seed, r.device, n_steps, scan, tf32=True)
        elif name == "half":
            cands[name] = train.reference_records(spec, inputs, r.seed, r.device, n_steps, scan, fault=name)
        yield name, checks.train_numbers(cands.pop(name), truth, follower, inputs)


def serve_readings(r, candidates: list[str], program_set: dict):
    from benchmark.reference import serving as ref

    inputs, u_emb, i_emb, index, server = serve.build(r)
    k = int(r.traffic["k"])
    _, users = serve.schedule(r.traffic, r.seconds, r.seed, inputs.user_num)
    for name in candidates:
        if name == "program":
            one, ids, scores = server(len(users))
            for j, u in enumerate(users):
                one(j, int(u))
        elif name == "control":
            ids, scores = ref.answers(u_emb, i_emb, inputs.rows, inputs.cols, users, k, tf32=True)
        elif name == "alter":
            ids, scores = ref.answers(u_emb, i_emb, inputs.rows, inputs.cols, users, k + 1)
            ids = np.concatenate([ids[:, : k - 1], ids[:, k:]], axis=1)
            scores = np.concatenate([scores[:, : k - 1], scores[:, k:]], axis=1)
        else:
            raise SystemExit(f"unknown candidate {name!r}")
        yield name, ref.answer_numbers(u_emb, i_emb, inputs.rows, inputs.cols, users, ids, scores, k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--candidates", default="program,control")
    ap.add_argument("--seconds", type=float, default=10.0, help="serving: the window whose requests are answered")
    ap.add_argument("--set", action="append", default=[], metavar="config.program.SECTION.KEY=VALUE",
                    help="a setting of the program's run (training)")
    args = ap.parse_args(argv)
    manifest = json.load(open(os.path.join(bench.ROOT, "BENCHMARK.json")))
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cands = args.candidates.split(",")
    program_set = dict(kv.split("=", 1) for kv in args.set)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = bench.Run(manifest, args.workload, seed, args.seconds, False, dev)
        readings = train_readings if r.traffic["kind"] == "train" else serve_readings
        for name, numbers in readings(r, cands, program_set):
            print(json.dumps({"workload": args.workload, "seed": seed, "candidate": name,
                              "set": program_set if name == "program" else {}, "numbers": numbers}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
