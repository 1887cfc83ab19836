"""The readers of the program's span records (``harness/spans.py`` and the
nine metrics that use it) on a made-up trace and made-up records."""

from __future__ import annotations

import importlib.util
import os

import pytest

from benchmark import run as bench
from benchmark.harness.peaks import HBM_BYTES_S
from benchmark.harness.trace import TraceSummary

PARTS = {"joint": ("forward", "loss", "backward", "adam"), "diffusion": ("forward", "backward", "adam")}
READERS = ["k4_roofline", "span_s.eval"] + [f"block_ms.{ph}.{p}" for ph, parts in PARTS.items() for p in parts]


def reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(bench.HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(name, enter, parent=None, device_s=None, work=None, parts=None):
    return {"name": name, "parent": parent, "enter_ns": enter, "exit_ns": enter + 10, "device_s": device_s,
            "work": work or {}, "graphs": {}, "parts": parts}


# the window's host events run from 1,000 to 9,000 ns
TRACE = TraceSummary(
    1e-5,
    [("void segsum_plan(int)", 1000, 1500), ("void segsum_kernel<false, 2, 1>", 1500, 3500),
     ("void dual_kernel<64>", 4000, 6000)],
    [("host_a", 1000, 5000), ("host_b", 4000, 9000)],
)
RECORDS = [
    _rec("joint", 500, work={"segsum": 9, "segsum.bytes": 10**9},  # before the window
         parts={"forward": 1.0, "loss": 1.0, "backward": 1.0, "adam": 1.0}),
    _rec("tables", 1000),
    _rec("fused", 1100, work={"segsum": 3, "segsum.bytes": 6_000_000, "segsum_unfused.bytes": 700_000}),
    _rec("joint", 1200, parent="fused", work={"segsum": 2, "segsum.bytes": 5_000_000},
         parts={"forward": 1e-3, "loss": 0.5e-3, "backward": 2e-3, "adam": 0.4e-3}),
    _rec("eval", 1300, parent="fused", device_s=0.004, parts={"forward": 1e-3, "rank": 2e-3}),
    _rec("diffusion", 2000, device_s=0.05, parts={"forward": 3e-3, "backward": 4e-3, "adam": 1e-3}),
    _rec("joint", 3000, parts={"forward": 3e-3, "loss": 1.5e-3, "backward": 4e-3, "adam": 0.6e-3}),
    _rec("joint", 4000, parts=None),  # a block whose parts another span took
    _rec("eval", 5000, device_s=0.006),
    _rec("eval", 6000, device_s=0.008),
    _rec("eval", 9500, device_s=9.0),  # after the window
]


@pytest.fixture()
def records(monkeypatch):
    from diffmm_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_records", lambda since_ns=0: [dict(r) for r in RECORDS])


def test_k4_roofline_counts_the_windows_top_level_bytes(records):
    # top-level spans in the window: tables and fused (the fused joint is its child)
    want = 100.0 * (6_700_000 / HBM_BYTES_S) / 2.5e-6
    assert reader("k4_roofline").read({"trace": TRACE}) == pytest.approx(want)


def test_span_s_eval_is_the_median_of_the_windows_evals(records):
    assert reader("span_s.eval").read({"trace": TRACE}) == pytest.approx(0.006)


@pytest.mark.parametrize("phase", sorted(PARTS))
def test_block_ms_is_the_median_part_of_the_sampled_blocks(records, phase):
    sampled = [r["parts"] for r in RECORDS[1:-1] if r["name"] == phase and r["parts"]]
    for part in PARTS[phase]:
        got = reader(f"block_ms.{phase}.{part}").read({"trace": TRACE})
        values = sorted(1e3 * p[part] for p in sampled)
        want = values[len(values) // 2] if len(values) % 2 else (values[0] + values[1]) / 2
        assert got == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_a_trace_or_records(monkeypatch, records, name):
    mod = reader(name)
    assert mod.read({}) is None
    assert mod.read({"trace": None}) is None
    assert mod.read({"trace": TraceSummary(1.0, [], [])}) is None
    from diffmm_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_records", lambda since_ns=0: [])
    assert mod.read({"trace": TRACE}) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_on_a_program_without_span_records(monkeypatch, name):
    """A program older than the span records (the parent of this metric)."""
    from diffmm_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_records")
    assert reader(name).read({"trace": TRACE}) is None


def test_k4_roofline_needs_k4_in_the_trace(records):
    trace = TraceSummary(1e-5, [("void dual_kernel<64>", 1000, 3000)], [("host", 1000, 9000)])
    assert reader("k4_roofline").read({"trace": trace}) is None
