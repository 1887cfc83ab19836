"""Tiny shapes of the benchmark's cells, for runs on the CPU: the same code,
the kernels' plain versions, a catalog of tens of items."""

from __future__ import annotations

import json
import os

import torch

from benchmark import run as bench

SHAPES = {
    "tiktok": {"config.data.users": 60, "config.data.items": 40,
               "config.data.modalities": [["image", 8], ["text", 12], ["audio", 8]],
               "config.data.graph": {"kind": "uniform", "train_edges": 300, "test_edges": 31,
                                     "degrees": {"min": 3, "sigma": 1.25}}},
    "sports": {"config.data.users": 70, "config.data.items": 50,
               "config.data.modalities": [["image", 16], ["text", 8]],
               "config.data.graph": {"kind": "latent", "rank": 4, "train_edges": 350, "test_edges": 36,
                                     "degrees": {"min": 3, "sigma": 1.25}}},
}
TRAIN = {"config.program.train.batch": 32, "config.program.train.test_batch": 32,
         "config.program.base.denoise_dim": "[16]"}
SERVE = {"traffic.rate_per_s": 200, "traffic.warmup_requests": 5, "traffic.trace_seconds": 0.2}


def manifest(here: str = bench.HERE) -> dict:
    """``BENCHMARK.json``, with the serving cell of ``serve_cell.json``
    added: its harness is kept and tested for a later benchmark PR, though
    the cell is not in the manifest (PERF.md, Open questions)."""
    with open(os.path.join(os.path.dirname(here), "BENCHMARK.json")) as fh:
        m = json.load(fh)
    with open(os.path.join(bench.HERE, "tests", "serve_cell.json")) as fh:
        for key, entries in json.load(fh).items():
            m[key] += entries
    return m


def tiny_run(workload: str, seed: int = 7, seconds: float = 0.5, trace: bool = False,
             manifest_: dict | None = None, here: str = bench.HERE) -> bench.Run:
    """A :class:`benchmark.run.Run` of ``workload`` at a tiny shape on the CPU."""
    m = manifest_ or manifest()
    cell = {w["name"]: w for w in m["workloads"]}[workload]
    config = cell["config"]
    over = dict(SHAPES.get(config, {}))
    with open(os.path.join(here, "traffic", f"{cell['traffic']}.json")) as fh:
        kind = json.load(fh)["kind"]
    over.update(TRAIN if kind == "train" else SERVE)
    return bench.Run(m, workload, seed, seconds, trace, torch.device("cpu"), overrides=over, here=here)
