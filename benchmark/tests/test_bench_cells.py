"""Each cell runs end to end on the CPU at a tiny shape, through the same
code as on the card, and prints a line that meets the benchmark's contract."""

from __future__ import annotations

import json
import math

import pytest

from benchmark import run as bench
from benchmark.tests.tiny import manifest, tiny_run

CELLS = [w["name"] for w in manifest()["workloads"]]
UNIT_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_/%.-")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_line(workload, trace, capsys):
    m = manifest()
    r = tiny_run(workload, seed=2**31 + 12345, trace=trace)
    result = bench.run_cell(r)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1 and "memory_peak_bytes" in dev
    e2e = {x["name"]: x for x in m["end_to_end"]}
    layer = {x["name"]: x for x in m["per_layer"]}
    for name, metric in line["metrics"].items():
        spec = (layer if trace else e2e)[name]
        assert metric["unit"] == spec["unit"] and set(metric["unit"]) <= UNIT_CHARS
        assert math.isfinite(metric["value"])
    if trace:
        assert "busy_s" in dev and dev["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["metrics"], "every cell reports a per-layer metric"
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    # the numbers compared are the last lines on standard error, each with its limit
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("checks ")
    assert json.loads(err[-1][len("checks "):]) == line["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    """Without the cards the cell asks for, a run exits non-zero and prints
    no result."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_without_the_program(tmp_path, monkeypatch, capsys):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run exits non-zero and prints no result."""
    monkeypatch.setattr(bench, "ROOT", str(tmp_path))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest()))
    rc = bench.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
