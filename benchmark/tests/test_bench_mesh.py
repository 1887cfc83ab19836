"""Multi-card cells on the CPU: a configuration with ``"mesh": "DxM"`` runs
as D·M gloo ranks started by the benchmark's own launcher
(``harness/ranks.py``), through the same code as on the cards, and a rank
that fails or hangs ends the run with no line and no process left."""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import time
import types

import pytest
import torch

from benchmark import run as bench
from benchmark.harness import ranks
from benchmark.tests.tiny import manifest, tiny_mesh_run, tiny_run


def _cards(err: str) -> dict[int, dict]:
    """Each card's ``health card <r>`` line of standard error."""
    out = {}
    for row in err.splitlines():
        if row.startswith("health card "):
            head, _, body = row.partition(": ")
            out[int(head.split()[-1])] = json.loads(body)
    return out


@pytest.mark.parametrize("layout", ["2x1", pytest.param("1x2", marks=pytest.mark.slow)])
def test_mesh_cell_line(layout, tmp_path, capsys):
    r = tiny_mesh_run(tmp_path, layout, trace=layout == "1x2")
    assert r.layout == tuple(int(v) for v in layout.split("x")) and r.world == 2
    line = json.loads(json.dumps(bench.run_cell(r)))
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 2 and dev["memory_peak_bytes"] >= 0
    if r.trace:
        assert line["metrics"] and "busy_s" in dev and dev["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"setup_s", "train_epoch_s"}
    err = capsys.readouterr()
    assert err.out == ""  # the ranks print nothing to standard output
    cards = _cards(err.err)
    assert sorted(cards) == [0, 1]
    assert {c["attempted"] for c in cards.values()} == {line["attempted"]}  # the same steps on both ranks
    assert all(("busy_share" in c) == r.trace for c in cards.values())
    last = err.err.strip().splitlines()[-1]
    assert json.loads(last[len("checks "):]) == line["checks"]
    assert not mp.active_children()


def test_mesh_disagreeing_with_chips_is_refused_at_load():
    with pytest.raises(SystemExit, match=r"'tiktok' has mesh '2x1', 2 cards, but cell 'tiktok.train' has chips 1"):
        bench.Run(manifest(), "tiktok.train", 1, 1, False, torch.device("cpu"), overrides={"config.mesh": "2x1"})
    with pytest.raises(SystemExit, match="mesh must be 'DxM'"):
        bench.Run(manifest(), "tiktok.train", 1, 1, False, torch.device("cpu"), overrides={"config.mesh": "two"})


def test_a_cell_without_mesh_runs_in_this_process():
    r = tiny_run("sports.train")
    assert r.layout is None and r.world == 1 and r.mesh is None


def test_failing_ranks_print_no_line(tmp_path, capsys):
    """Every rank's Coach raises (a batch the data axis does not divide):
    the run raises, prints nothing, and leaves no rank."""
    r = tiny_mesh_run(tmp_path, "2x1", extra={"config.program.train.batch": 33})
    with pytest.raises(ranks.RankFailure, match="must be divisible by the data-axis size"):
        bench.run_cell(r)
    assert capsys.readouterr().out == ""
    assert not mp.active_children()


def test_main_exits_nonzero_without_a_line_when_a_rank_fails(monkeypatch, capsys):
    def fail(r):
        raise ranks.RankFailure("rank 1 failed")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(bench, "run_cell", fail)
    rc = bench.main(["--workload", "tiktok.train", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    out = capsys.readouterr()
    assert out.out == "" and "rank 1 failed" in out.err


# the launcher alone: rank 0 waits in a collective while rank 1 misbehaves

def _rank_1_raises(run):
    import torch.distributed as dist

    if run.rank == 1:
        raise ValueError("planted")
    dist.barrier()


def _rank_1_dies(run):
    import torch.distributed as dist

    if run.rank == 1:
        os._exit(3)
    dist.barrier()


def _rank_1_hangs(run):
    import torch.distributed as dist

    if run.rank == 1:
        time.sleep(3600)
    dist.barrier()


def _ranks_report(run):
    return {"rank": run.rank, "tensor": torch.full((3,), float(run.rank))}


def _two_cpu_ranks():
    return types.SimpleNamespace(world=2, layout=(2, 1), device=torch.device("cpu"))


@pytest.mark.parametrize("fn, message", [
    ("_rank_1_raises", "(?s)rank 1 failed:.*ValueError: planted"),
    ("_rank_1_dies", r"rank 1 ended \(exit code 3\) without its result"),
    ("_rank_1_hangs", r"ranks \[0, 1\] had not reported within 4 s of joining"),
])
def test_a_failing_rank_ends_the_launch(fn, message):
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailure, match=message):
        ranks.launch(_two_cpu_ranks(), f"benchmark.tests.test_bench_mesh.{fn}", join_s=120, run_s=4)
    assert time.monotonic() - t0 < 120
    assert not mp.active_children()


def test_results_come_back_by_value():
    out = ranks.launch(_two_cpu_ranks(), "benchmark.tests.test_bench_mesh._ranks_report", join_s=120, run_s=60)
    assert [o["rank"] for o in out] == [0, 1]
    assert torch.equal(out[1]["tensor"], torch.ones(3))
    assert not mp.active_children()


def test_calibrate_reads_a_mesh_cell(tmp_path):
    """``tools/calibrate.py``'s readings of a two-rank cell: rank 0 reads the
    program's numbers from the mesh and a planted fault's from the
    reference; the other rank returns none."""
    r = tiny_mesh_run(tmp_path, "2x1")
    rows = ranks.launch(r, "benchmark.tools.calibrate.mesh_readings", [5], ["program", "half"], {},
                        join_s=120, run_s=600)
    assert rows[1] == []
    numbers = {name: n for _, name, n in rows[0]}
    limits = r.limits
    assert all(numbers["program"][k] <= v for k, v in limits.items() if v is not None)
    assert numbers["half"]["loss.total"] > limits["loss.total"]
    assert not mp.active_children()
