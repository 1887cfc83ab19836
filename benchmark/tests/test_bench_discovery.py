"""A configuration, a traffic mix and a per-layer metric are added as new
files and manifest entries alone: the harness finds each by its name, with
no file that exists edited."""

from __future__ import annotations

import json
import shutil

from benchmark import run as bench
from benchmark.tests.tiny import manifest, tiny_run


def test_new_files_are_found_by_name(tmp_path):
    here = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(f"{bench.HERE}/{sub}", here / sub)
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}

    config = json.loads((here / "configs" / "tiktok.json").read_text())
    config["name"] = "dummy"
    config["data"].update(users=50, items=30, modalities=[["image", 8], ["text", 8]],
                          graph={"kind": "uniform", "train_edges": 200, "test_edges": 20,
                                 "degrees": {"min": 3, "sigma": 1.0}})
    (here / "configs" / "dummy.json").write_text(json.dumps(config))
    traffic = json.loads((here / "traffic" / "train_epochs.json").read_text())
    traffic.update(checked_steps=2, fenced_epochs=1, trace_epochs=1)
    (here / "traffic" / "dummy_epochs.json").write_text(json.dumps(traffic))
    (here / "metrics" / "dummy_metric.py").write_text(
        "def read(layer):\n    return 42.0 if layer.get('kind') == 'train' else None\n")
    limits = json.loads((here / "limits" / "tiktok.train.json").read_text())
    (here / "limits" / "dummy.cell.json").write_text(json.dumps(limits))

    m = manifest()
    m["configs"].append({"name": "dummy", "source": "a test's own", "file": "benchmark/configs/dummy.json",
                         "reduced": [], "why": "found by name"})
    m["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy_epochs", "chips": 1,
                           "why": "found by name"})
    m["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher", "source": "program_counter",
                           "layer": "dummy", "moves": "train_epoch_s", "workloads": ["dummy.cell"]})
    m["end_to_end"][1]["workloads"].append("dummy.cell")

    r = tiny_run("dummy.cell", trace=True, manifest_=m, here=str(here))
    assert r.config["name"] == "dummy" and r.traffic["checked_steps"] == 2
    result = bench.run_cell(r)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["dummy_metric"]["value"] == 42.0
    assert "phase_s.joint" not in result["metrics"]  # listed for other cells only
    # nothing that was there changed
    assert all(p.read_bytes() == data for p, data in before.items())
