"""The reader of ``adam_roofline`` on made-up traces and span records: the
Adam bytes of the window's top-level spans at the HBM rate over the device
time of ``adam_kernel``; None without a trace, a kernel or the counter (a
program older than the pass), and no share above 100% at the peak."""

from __future__ import annotations

import importlib.util
import os

import pytest

from benchmark import run as bench
from benchmark.harness.peaks import HBM_BYTES_S
from benchmark.harness.trace import TraceSummary

ADAM = "void (anonymous namespace)::adam_kernel((anonymous namespace)::Table)"
FOREACH = "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>"


def reader():
    spec = importlib.util.spec_from_file_location(
        "adam_roofline", os.path.join(bench.HERE, "metrics", "adam_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(name, enter, parent=None, work=None):
    return {"name": name, "parent": parent, "enter_ns": enter, "exit_ns": enter + 10, "device_s": None,
            "work": work or {}, "graphs": {}, "parts": None}


# the window's top-level spans count 28 * 3e6 bytes: the diffusion step's
# trees and the joint step's; a fused chunk's child and a span before the
# trace add nothing
RECORDS = [
    _rec("diffusion", 500, work={"adam": 2, "adam.bytes": 28 * 10**9}),  # before the trace
    _rec("diffusion", 2000, work={"adam": 2, "adam.bytes": 28 * 2 * 10**6, "segsum.bytes": 10**9}),
    _rec("fused", 3000, work={"adam": 1, "adam.bytes": 28 * 10**6}),
    _rec("joint", 3100, parent="fused", work={"adam": 1, "adam.bytes": 28 * 10**6}),
]
WINDOW_BYTES = 28 * 3 * 10**6


@pytest.fixture()
def records(monkeypatch):
    from diffmm_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_records", lambda since_ns=0: [dict(r) for r in RECORDS])


def _trace(adam_ns: list[int]) -> TraceSummary:
    """A window from 1,000 to 20,000 ns: a K4 launch, Adam's launches of
    the given lengths, one after another, and a ``_foreach`` kernel."""
    device, at = [("void segsum_kernel<false, 2, 1>", 1000, 2000)], 2000
    for ns in adam_ns:
        device.append((ADAM, at, at + ns))
        at += ns
    device.append((FOREACH, at, at + 500))
    return TraceSummary(2e-5, device, [("host", 1000, 20_000)])


def _layer(trace):
    return {"kind": "train", "trace": trace, "shape": {}, "train_epoch_s": 0.5, "cards": 1}


def test_adam_roofline_is_the_windows_bytes_at_hbm_over_the_kernels_time(records):
    got = reader().read(_layer(_trace([20_000, 10_000, 10_000])))
    assert got == pytest.approx(100.0 * (WINDOW_BYTES / HBM_BYTES_S) / 40e-6)
    assert 0 < got < 100  # honest numbers: 84 MB in 40 us is 2.1 TB/s


def test_adam_roofline_reads_100_at_the_peak(records):
    at_peak = round(1e9 * WINDOW_BYTES / HBM_BYTES_S)
    assert reader().read(_layer(_trace([at_peak]))) == pytest.approx(100.0, rel=1e-4)


def test_adam_roofline_gives_none_without_a_trace_or_a_kernel(records):
    mod = reader()
    assert mod.read({}) is None
    assert mod.read(_layer(None)) is None
    assert mod.read(_layer(TraceSummary(1.0, [], []))) is None
    assert mod.read(_layer(_trace([]))) is None  # the parent's Adam: _foreach passes only


def test_adam_roofline_gives_none_without_the_counter(monkeypatch):
    """The parent's records have no ``adam.bytes``; a program without span
    records gives None too."""
    from diffmm_tpu_torch.utils import profiling

    older = [_rec("diffusion", 2000, work={"segsum.bytes": 10**9})]
    monkeypatch.setattr(profiling, "span_records", lambda since_ns=0: older)
    assert reader().read(_layer(_trace([20_000]))) is None
    monkeypatch.delattr(profiling, "span_records")
    assert reader().read(_layer(_trace([20_000]))) is None
