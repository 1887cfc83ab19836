"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``kind`` names the driver in
``benchmark/harness/<kind>.py``; its correctness limits are
``benchmark/limits/<workload>.json``, and each per-layer metric is read by
``benchmark/metrics/<metric>.py``. A run makes its inputs from the seed,
sets up and warms up, measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints one JSON line last
on standard output. It needs the CUDA cards the cell asks for, and exits
with an error and no result without them.

A configuration with ``"mesh": "DxM"`` runs as D·M ranks, one card each,
that this process starts (``benchmark/harness/ranks.py``); the cell's
``chips`` is D·M. Each rank measures its own card; the line reports every
card (``device.count``, the fullest card's peak) and rank 0's per-layer
metrics, and this process prints it.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time


def _process_start() -> float:
    """Wall time at which this process started (``/proc``), else now."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T0 = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "diffmm_tpu")


class Run:
    """One run's cell, settings and clock."""

    def __init__(self, manifest: dict, workload: str, seed: int, seconds: float, trace: bool, device,
                 overrides: dict | None = None, t0: float | None = None, here: str = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
        self.manifest = manifest
        self.cell = cells[workload]
        self.name = workload
        self.here = here
        self.config = _load(os.path.join(here, "configs", f"{self.cell['config']}.json"))
        self.traffic = _load(os.path.join(here, "traffic", f"{self.cell['traffic']}.json"))
        self.limits = _load(os.path.join(here, "limits", f"{workload}.json"))
        for key, value in (overrides or {}).items():
            _set(self, key, value)
        self.layout = mesh_layout(self.config, self.cell)
        if self.layout is not None and self.traffic["kind"] != "train":
            raise SystemExit(f"cell {workload!r}: a mesh runs the train kind only, not {self.traffic['kind']!r}")
        self.world = 1 if self.layout is None else self.layout[0] * self.layout[1]
        self.rank = 0
        self.mesh = None  # the (data, model) DeviceMesh, in a rank of a mesh cell
        self.seed = int(seed) % (1 << 63)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t0 = T0 if t0 is None else t0

    def smi(self) -> str:
        from benchmark.harness.health import smi

        return smi(self.device.index or 0) if self.device.type == "cuda" else "cpu"

    def note(self, what: str, **values) -> None:
        """A ``health`` line on standard error; a rank of a mesh cell names
        itself."""
        from benchmark.harness.health import note

        note(what if self.layout is None else f"rank {self.rank} {what}", **values)


def mesh_layout(config: dict, cell: dict) -> tuple[int, int] | None:
    """``(D, M)`` of the configuration's ``mesh`` key (``"DxM"``), or None
    without one. The cell's ``chips`` must be D·M."""
    spec = config.get("mesh")
    if spec is None:
        return None
    try:
        data, model = (int(v) for v in str(spec).lower().split("x"))
    except ValueError:
        raise SystemExit(f"configuration {cell['config']!r}: mesh must be 'DxM', got {spec!r}") from None
    if data < 1 or model < 1:
        raise SystemExit(f"configuration {cell['config']!r}: mesh {spec!r} needs both sizes at least 1")
    if data * model != int(cell["chips"]):
        raise SystemExit(f"configuration {cell['config']!r} has mesh {spec!r}, {data * model} cards, "
                         f"but cell {cell['name']!r} has chips {cell['chips']}")
    return data, model


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _set(run: Run, key: str, value) -> None:
    """``"config.data.users"``-style override (tests shrink a cell so)."""
    head, *path = key.split(".")
    obj = getattr(run, head)
    for p in path[:-1]:
        obj = obj[p]
    obj[path[-1]] = value


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def read_metric(name: str, layer: dict, here: str = HERE):
    """The value of per-layer metric ``name`` (its reader's ``read`` in
    ``<here>/metrics/<name>.py``), or None where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", os.path.join(here, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(layer)


def run_cell(r: Run) -> dict:
    """Run the cell; the result line as a dict (``checks`` last). A mesh
    cell runs in its ranks (:func:`benchmark.harness.ranks.launch`)."""
    if r.layout is None:
        return line(r, [measure(r)])
    from benchmark.harness import ranks

    return line(r, ranks.launch(r, "benchmark.run.measure"))


def measure(r: Run) -> dict:
    """This process's part of a run: the driver's run on its card, and what
    the line takes of it. Rank 0 (the only rank of a cell without a mesh)
    also judges ``correct`` and reads the metrics; every rank reports its
    card."""
    from benchmark.harness import checks

    driver = importlib.import_module(f"benchmark.harness.{r.traffic['kind']}")
    out = driver.run(r)
    part = {"rank": r.rank, "attempted": int(out["attempted"]), "failed": int(out["failed"]),
            "kind": _device_kind(r.device), "memory_peak_bytes": int(out["memory_peak_bytes"]),
            "smi": out.get("smi")}
    summary = out["trace"]
    if summary is not None:
        part["busy_s"], part["window_s"] = summary.busy_s, summary.window_s
    if r.rank != 0:
        return part
    correct, judged = checks.judge(out["numbers"], r.limits)
    e2e = {m["name"]: m for m in r.manifest["end_to_end"]}
    reported = {n for n in out["metrics"] if n in e2e and ("workloads" not in e2e[n] or r.name in e2e[n]["workloads"])}
    if not r.trace:
        metrics = {n: {"value": out["metrics"][n], "unit": e2e[n]["unit"]} for n in sorted(reported)}
    else:
        metrics = {}
        for m in r.manifest["per_layer"]:
            if _applies(m, r.name, reported):
                value = read_metric(m["name"], out["layer"], r.here)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        part["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.idle_gaps()}
    part.update(correct=correct, metrics=metrics, checks=judged)
    return part


def line(r: Run, parts: list[dict]) -> dict:
    """The result line from each card's part (rank order): rank 0's
    correctness, counts and metrics, every card counted, the fullest card's
    peak. Each card's reading goes on a ``health`` line first, and the
    numbers compared last."""
    from benchmark.harness import checks, health

    head = parts[0]
    steps = [p["attempted"] for p in parts]
    if len(set(steps)) > 1:
        raise SystemExit(f"benchmark: the ranks ran different numbers of steps: {steps}")
    result = {"correct": head["correct"], "attempted": head["attempted"], "failed": head["failed"]}
    device = {"platform": "gpu" if r.device.type == "cuda" else r.device.type,
              "kind": head["kind"], "count": len(parts),
              "memory_peak_bytes": max(p["memory_peak_bytes"] for p in parts)}
    result["metrics"] = head["metrics"]
    if r.trace:
        device["busy_s"] = head["busy_s"]
        device["window_s"] = head["window_s"]
        result["breakdown"] = head["breakdown"]
    result["device"] = device
    for p in parts:
        card = {"kind": p["kind"], "smi": p["smi"], "memory_peak_bytes": p["memory_peak_bytes"],
                "attempted": p["attempted"]}
        if "busy_s" in p:
            card.update(busy_s=p["busy_s"], window_s=p["window_s"], busy_share=p["busy_s"] / p["window_s"])
        health.note(f"card {p['rank']}", **card)
    checks.print_checks(head["checks"])
    result["checks"] = head["checks"]
    return result


def _device_kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(os.path.join(ROOT, "diffmm_tpu_torch")):
        print("benchmark: the program (diffmm_tpu_torch/) is not in this checkout", file=sys.stderr)
        return 2
    manifest = _load(manifest_path)
    # caches of the program's compilers stay in the checkout, at fixed paths
    cache = os.path.join(ROOT, "benchmark", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    import torch

    chips = {w["name"]: w for w in manifest["workloads"]}.get(args.workload, {}).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    r = Run(manifest, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    from benchmark.harness.ranks import RankFailure

    try:
        result = run_cell(r)
    except RankFailure as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 5
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
