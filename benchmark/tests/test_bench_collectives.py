"""The readers of a mesh cell's collectives and whole-mesh share
(``allreduce_roofline``, ``comm_share.train``, ``block_ms.diffusion.reduce``,
``mfu.train_mesh``) on made-up traces and records: what each reads, None
where it finds nothing to read, and no share above 100% at the peak."""

from __future__ import annotations

import importlib.util
import os

import pytest

from benchmark import run as bench
from benchmark.harness.trace import TraceSummary

READERS = ["allreduce_roofline", "comm_share.train", "block_ms.diffusion.reduce", "mfu.train_mesh"]
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"


def reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(bench.HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(name, enter, parent=None, work=None, parts=None):
    return {"name": name, "parent": parent, "enter_ns": enter, "exit_ns": enter + 10, "device_s": None,
            "work": work or {}, "graphs": {}, "parts": parts}


def _trace(nccl_ns: int, busy_ns: int = 10_000) -> TraceSummary:
    """A window from 1,000 to 20,000 ns: a kernel, then NCCL's all-reduce
    for ``nccl_ns`` (busy ``busy_ns`` in all)."""
    start = 1000 + busy_ns - nccl_ns
    return TraceSummary(2e-5, [("void segsum_kernel<false, 2, 1>", 1000, start), (NCCL, start, start + nccl_ns)],
                        [("host", 1000, 20_000)])


# the bytes of the window's top-level spans: 9e5 (the fused joint is a child)
RECORDS = [
    _rec("diffusion", 500, work={"allreduce.grads.bytes": 10**12, "allreduce.grads.calls": 1}),  # before it
    _rec("diffusion", 2000, work={"allreduce.grads.bytes": 600_000, "allreduce.grads.calls": 2,
                                  "segsum.bytes": 10**9},
         parts={"forward": 3e-3, "backward": 4e-3, "reduce": 2e-3, "adam": 1e-3}),
    _rec("fused", 3000, work={"allreduce.propagate.bytes": 200_000, "allreduce.other.bytes": 100_000}),
    _rec("joint", 3100, parent="fused", work={"allreduce.propagate.bytes": 200_000}),
    _rec("diffusion", 4000, parts={"forward": 3e-3, "backward": 4e-3, "reduce": 4e-3, "adam": 1e-3}),
    _rec("diffusion", 5000, parts={"forward": 3e-3, "backward": 4e-3, "adam": 1e-3}),  # one device's parts
    _rec("diffusion", 6000, parts={"forward": 3e-3, "backward": 4e-3, "reduce": 3e-3, "adam": 1e-3}),
]
WINDOW_BYTES = 900_000


@pytest.fixture()
def records(monkeypatch):
    from diffmm_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_records", lambda since_ns=0: [dict(r) for r in RECORDS])


def _layer(trace, **kw):
    shape = {"users": 400, "items": 600, "nnz": 3500, "feat_dims": [64, 16], "latdim": 16, "hidden": [32],
             "steps": 5, "batch": 64, "cl_method": 1, "tst_epoch": 1}
    return {"kind": "train", "trace": trace, "shape": shape, "train_epoch_s": 0.5, "cards": 4, **kw}


def test_allreduce_roofline_is_the_windows_bytes_at_nvlink_over_nccl_time(records):
    mod = reader("allreduce_roofline")
    got = mod.read(_layer(_trace(4000)))
    assert got == pytest.approx(100.0 * (WINDOW_BYTES / mod.NVLINK_BYTES_S) / 4e-6)


def test_comm_share_is_nccl_over_busy():
    assert reader("comm_share.train").read(_layer(_trace(2500))) == pytest.approx(25.0)


def test_block_ms_reduce_is_the_median_of_the_mesh_steps(records):
    assert reader("block_ms.diffusion.reduce").read(_layer(_trace(2500))) == pytest.approx(3.0)


def test_mfu_train_mesh_is_mfu_train_over_the_cards():
    for cards in (1, 2, 4):
        layer = _layer(None, cards=cards)
        assert reader("mfu.train_mesh").read(layer) == pytest.approx(reader("mfu.train").read(layer) / cards)


def test_no_share_passes_100_at_the_peak(records):
    """NCCL's all-reduce exactly as long as the window's bytes at NVLink's
    rate, and all the card's work: both shares read 100."""
    mod = reader("allreduce_roofline")
    at_peak = round(1e9 * WINDOW_BYTES / mod.NVLINK_BYTES_S)  # 2,000 ns
    trace = TraceSummary(2e-5, [(NCCL, 1000, 1000 + at_peak)], [("host", 1000, 20_000)])
    assert mod.read(_layer(trace)) == pytest.approx(100.0)
    assert reader("comm_share.train").read(_layer(trace)) == pytest.approx(100.0)
    # two NCCL kernels over the same interval count once
    twice = TraceSummary(2e-5, [(NCCL, 1000, 1000 + at_peak), (NCCL, 1000, 1000 + at_peak)], [("host", 1000, 20_000)])
    assert mod.read(_layer(twice)) == pytest.approx(100.0)
    assert reader("comm_share.train").read(_layer(twice)) == pytest.approx(100.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_a_trace(records, name):
    mod = reader(name)
    assert mod.read({}) is None
    if name != "mfu.train_mesh":  # a host-clock share: it reads no trace
        assert mod.read(_layer(None)) is None
        assert mod.read(_layer(TraceSummary(1.0, [], []))) is None


@pytest.mark.parametrize("name", ["allreduce_roofline", "comm_share.train"])
def test_readers_give_none_without_nccl_kernels(records, name):
    trace = TraceSummary(2e-5, [("void segsum_kernel<false, 2, 1>", 1000, 5000)], [("host", 1000, 20_000)])
    assert reader(name).read(_layer(trace)) is None


@pytest.mark.parametrize("name", ["allreduce_roofline", "block_ms.diffusion.reduce"])
def test_readers_give_none_without_a_counter_or_a_part(monkeypatch, name):
    """One card's records (or a program older than the counters and the
    part): no ``allreduce.*`` counter, no ``reduce`` part."""
    from diffmm_tpu_torch.utils import profiling

    one_card = [_rec("diffusion", 2000, work={"segsum.bytes": 10**9},
                     parts={"forward": 3e-3, "backward": 4e-3, "adam": 1e-3})]
    monkeypatch.setattr(profiling, "span_records", lambda since_ns=0: one_card)
    assert reader(name).read(_layer(_trace(4000))) is None
    monkeypatch.delattr(profiling, "span_records")
    assert reader(name).read(_layer(_trace(4000))) is None


def test_mfu_train_mesh_needs_its_cards_and_epoch():
    assert reader("mfu.train_mesh").read(_layer(None, cards=None)) is None
    assert reader("mfu.train_mesh").read(_layer(None, train_epoch_s=0)) is None
    assert reader("mfu.train_mesh").read(_layer(None, kind="serve")) is None
