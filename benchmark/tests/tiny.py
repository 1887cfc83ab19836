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


def mesh_cell(tmp_path, layout: str, base: str = "tiktok") -> tuple[dict, str]:
    """``(manifest, here)`` with a configuration ``<base>_mesh`` (``base``'s,
    with ``"mesh": layout``) and its cell ``<base>_mesh.train`` on D·M chips,
    added as new files in a copy of the benchmark's data folders and new
    manifest entries alone; the cell reports what ``<base>.train`` does."""
    import shutil

    here = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(bench.HERE, sub), here / sub)
    name = f"{base}_mesh"
    config = json.loads((here / "configs" / f"{base}.json").read_text())
    config.update(name=name, mesh=layout)
    (here / "configs" / f"{name}.json").write_text(json.dumps(config))
    (here / "limits" / f"{name}.train.json").write_text((here / "limits" / f"{base}.train.json").read_text())
    data, model = (int(v) for v in layout.split("x"))
    m = manifest()
    m["configs"].append({"name": name, "source": "a test's own", "file": f"benchmark/configs/{name}.json",
                         "reduced": [], "why": "a mesh found by name"})
    m["workloads"].append({"name": f"{name}.train", "config": name, "traffic": "train_epochs",
                           "chips": data * model, "why": "a mesh found by name"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if f"{base}.train" in metric.get("workloads", []):
            metric["workloads"].append(f"{name}.train")
    return m, str(here)


def tiny_mesh_run(tmp_path, layout: str, trace: bool = False, base: str = "tiktok",
                  seed: int = 2**31 + 77, extra: dict | None = None) -> bench.Run:
    """A :class:`benchmark.run.Run` of :func:`mesh_cell`'s cell at ``base``'s
    tiny shape on CPU ranks."""
    m, here = mesh_cell(tmp_path, layout, base)
    over = {**SHAPES[base], **TRAIN, **(extra or {})}
    return bench.Run(m, f"{base}_mesh.train", seed, 0.5, trace, torch.device("cpu"), overrides=over, here=here)
