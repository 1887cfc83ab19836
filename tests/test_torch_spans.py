"""The port's spans and work counters (``utils/profiling.py``,
``ops/kernels``): span records, their nesting and counter deltas, the
ring's bound, the trace's clock, K4's byte rule, the launch counters'
readers; on a card (``gpu``) the parts of captured steps, K4's work through
graph replays and the captures of later epochs.

Run the card's tests with ``python -m pytest tests/test_torch_spans.py -q
--noconftest -p no:cacheprovider``."""

import importlib.util
import pathlib
import time

import pytest
import torch

from diffmm_tpu_torch.ops import kernels
from diffmm_tpu_torch.ops.kernels import add_launches, add_work, count, launch_counts, work_counts
from diffmm_tpu_torch.ops.kernels.segsum import LAUNCHES as K4_LAUNCHES
from diffmm_tpu_torch.ops.kernels.segsum import least_bytes, segment_offsets
from diffmm_tpu_torch.utils import profiling
from diffmm_tpu_torch.utils.profiling import RING, PhaseTimer, span, span_records

REPO = pathlib.Path(__file__).resolve().parent.parent
KERNELS = {"spmm_dual", "denoise_layer1", "denoise_layer1_partial", "denoise_layer2", "segsum",
           "segsum_unfused", "adam"}


def _by_name(records):
    return {r["name"]: r for r in records}


def test_span_records_nest_and_children_add_to_parent():
    since = time.time_ns()
    with span("outer"):
        count("segsum", 100)
        with span("a"):
            count("segsum", 10)
            count("spmm_dual")
            with span("a1"):
                count("segsum", 1)
        with span("b"):
            count("segsum_unfused", 7)
    recs = span_records(since)
    assert [r["name"] for r in recs] == ["a1", "a", "b", "outer"]  # in exit order
    by = _by_name(recs)
    assert by["outer"]["parent"] is None and by["a"]["parent"] == "outer"
    assert by["a1"]["parent"] == "a" and by["b"]["parent"] == "outer"
    for child, parent in (("a1", "a"), ("a", "outer"), ("b", "outer")):
        assert by[parent]["enter_ns"] <= by[child]["enter_ns"] <= by[child]["exit_ns"] <= by[parent]["exit_ns"]
    assert by["a1"]["work"] == {"segsum": 1, "segsum.bytes": 1}
    assert by["a"]["work"] == {"segsum": 2, "segsum.bytes": 11, "spmm_dual": 1}
    assert by["b"]["work"] == {"segsum_unfused": 1, "segsum_unfused.bytes": 7}
    own = {"segsum": 1, "segsum.bytes": 100}
    summed = dict(own)
    for child in ("a", "b"):
        for k, v in by[child]["work"].items():
            summed[k] = summed.get(k, 0) + v
    assert by["outer"]["work"] == summed
    assert all(r["device_s"] is None and r["parts"] is None and r["graphs"] == {} for r in recs)
    add_work({k: -v for k, v in by["outer"]["work"].items()})


def test_ring_keeps_the_last_records():
    since = time.time_ns()
    for i in range(RING + 25):
        with span(f"s{i}"):
            pass
    recs = span_records(since)
    assert len(recs) == RING
    assert recs[0]["name"] == "s25" and recs[-1]["name"] == f"s{RING + 24}"
    assert len(span_records(since_ns=recs[-1]["enter_ns"])) == 1
    since = time.time_ns()
    assert span_records(since) == []


def test_span_stamps_bracket_the_trace_event():
    """A span's host stamps are ``time.time_ns()``, the clock of the
    profiler's events: they bracket the span's named range within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with span(f"probe{i}"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    recs = _by_name(span_records(since))
    seen = 0
    for ev in prof.profiler.kineto_results.events():
        rec = recs.get(ev.name())
        if rec is None:
            continue
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert 0 <= start - rec["enter_ns"] < 1_000_000
        assert 0 <= rec["exit_ns"] - end < 1_000_000
        seen += 1
    assert seen == 3


def test_phase_timer_totals_outer_phases_and_summary_every_span():
    timer = PhaseTimer()
    with timer.phase("fused"):
        with timer.phase("joint"):
            pass
        with timer.phase("eval"):
            pass
    with timer.phase("joint"):
        pass
    assert set(timer.totals) == {"fused", "joint"} and timer.counts["joint"] == 1
    summary = timer.summary()
    assert "eval=" in summary and "joint=" in summary and "/2" in summary and "fused=" in summary
    timer.reset()
    assert timer.summary() == "" and not timer.totals


def test_step_parts_are_claimed_only_for_card_steps():
    """A phase on the CPU claims no parts (a card's earlier readings are not
    its own) and its span carries none."""
    parts = profiling.StepParts("probe", ("a", "b"))
    since = time.time_ns()
    with span("phase"):
        parts.claim(torch.device("cpu"))
        parts.mark(0, torch.device("cpu"))
    profiling.settle()
    assert parts.owner is None and parts not in profiling._claimed
    assert _by_name(span_records(since))["phase"]["parts"] is None


def _k4_case(M, R, d, nnz, n, dtype, seed):
    """Tables, index vectors naming every row, and offsets with no pads."""
    gen = torch.Generator().manual_seed(seed)
    tables = torch.randn((M, R, d), generator=gen).to(dtype)
    srcs = [torch.cat([torch.arange(R), torch.randint(0, R, (nnz - R,), generator=gen)])
            [torch.randperm(nnz, generator=gen)].to(torch.int32) for _ in range(M)]
    ids = torch.sort(torch.randint(0, n, (nnz,), generator=gen)).values
    return tables, srcs, segment_offsets(ids, n)


@pytest.mark.parametrize("case", [(1, 50, 16, 120, 30, torch.float32, 1),
                                  (2, 37, 64, 37, 11, torch.float32, 2),
                                  (3, 20, 32, 90, 64, torch.bfloat16, 3)])
def test_k4_byte_rule_is_chip_smokes_bound_where_every_row_is_named(case):
    M, R, d, nnz, n, dtype, seed = case
    tables, srcs, offsets = _k4_case(M, R, d, nnz, n, dtype, seed)
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bytes", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, _, n_bytes = smoke._k4_bound(tables, srcs, offsets)
    assert least_bytes(M, R, d, tables.element_size(), nnz, n) == n_bytes
    # the unfused entry's row is its edge: the messages, no index vectors
    assert least_bytes(1, nnz, d, 4, nnz, n, indexed=False) == nnz * d * 4 + 8 * (n + 1) + 4 * n * d


def test_launch_counters_read_and_add_as_before():
    counts, work = launch_counts(), work_counts()
    assert set(counts) == KERNELS
    assert set(work) == KERNELS | {"segsum.bytes", "segsum_unfused.bytes", "adam.bytes"}
    add_launches({"segsum": 3, "spmm_dual": 2, "not_a_kernel": 5, "segsum.bytes": 99})
    after = launch_counts()
    assert after["segsum"] == counts["segsum"] + 3 and after["spmm_dual"] == counts["spmm_dual"] + 2
    assert kernels.work_counts()["segsum.bytes"] == work["segsum.bytes"]  # launches only
    assert K4_LAUNCHES["segsum"] == after["segsum"] and dict(K4_LAUNCHES) == {
        "segsum": after["segsum"], "segsum_unfused": after["segsum_unfused"]}
    add_launches({"segsum": -3, "spmm_dual": -2})
    assert launch_counts() == counts
    before = dict(K4_LAUNCHES)
    K4_LAUNCHES["segsum"] += 1
    assert K4_LAUNCHES != before and launch_counts()["segsum"] == counts["segsum"] + 1
    K4_LAUNCHES["segsum"] -= 1
    assert K4_LAUNCHES == before
    with pytest.raises(KeyError):
        K4_LAUNCHES["spmm_dual"]


def test_fused_chunk_spans_on_the_cpu():
    """A fused chunk's phases and evals are children of ``fused``; the
    chunk's tables are read before it; only ``fused`` keeps a host total."""
    from diffmm_tpu_torch.config import Config
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.train.coach import Coach

    cfg = Config()
    cfg.base.latdim, cfg.base.denoise_dim, cfg.train.batch, cfg.train.test_batch = 16, "[32]", 16, 8
    host = make_synthetic_host_data(cfg, user_num=40, item_num=30, seed=1)
    coach = Coach(cfg, host, device="cpu")
    coach.train_epoch(0)
    coach.timer.reset()
    since = time.time_ns()
    coach.train_epochs_fused(1, 2, "test")
    recs = span_records(since)
    top = [r["name"] for r in recs if r["parent"] is None]
    assert top == ["tables", "fused"]
    kids = [r["name"] for r in recs if r["parent"] == "fused"]
    assert kids == ["neg_sampling", "diffusion", "rebuild", "joint", "eval"] * 2 + ["readback"]
    assert set(coach.timer.totals) == {"fused"}
    assert "eval=" in coach.timer.summary() and "joint=" in coach.timer.summary()
    since = time.time_ns()
    coach.train_epoch(3)
    coach.test_epoch()
    coach.capture_best(3)
    assert [r["name"] for r in span_records(since)] == [
        "tables", "neg_sampling", "diffusion", "rebuild", "joint", "readback", "eval", "best"]


# ------------------------------------------------------------------ card
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _tiktok_coach(cuda, **train):
    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.data.synthetic import synthesize_shape
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import NullLog

    cfg = load_config(str(REPO / "conf" / "tiktok.toml"))
    for key, value in train.items():
        setattr(cfg.train, key, value)
    return Coach(cfg, synthesize_shape(cfg, "tiktok"), device=cuda, log=NullLog())


def _epoch_records(coach, epoch):
    since = time.time_ns()
    coach.train_epoch(epoch)
    coach.test_epoch()
    return _by_name(span_records(since))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_captured_step_parts_tile_the_phase(cuda, form, monkeypatch):
    """The parts of a replayed joint and diffusion step (events recorded by
    the graph) read positive and sum to within 5% of the phase's last
    block, timed alone by events around its replay; the blocks together
    are within 5% of the phase span's device seconds; the eval's parts
    read positive inside its span."""
    from diffmm_tpu_torch.train.graphs import BlockGraph

    coach = _tiktok_coach(cuda, graph_form=form)
    first = _epoch_records(coach, 0)
    assert first["joint"]["graphs"].get("joint.captures") == 1
    replay, blocks = BlockGraph.__call__, []

    def timed(self, *inputs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        replay(self, *inputs)
        end.record()
        blocks.append((self.phase, start, end))

    monkeypatch.setattr(BlockGraph, "__call__", timed)
    recs = _epoch_records(coach, 1)
    for phase, n_parts in (("joint", 4), ("diffusion", 3)):
        rec = recs[phase]
        parts = rec["parts"]
        assert parts is not None and len(parts) == n_parts and all(v > 0 for v in parts.values()), rec
        times = [s.elapsed_time(e) * 1e-3 for ph, s, e in blocks if ph == phase]
        assert len(times) == rec["graphs"][f"{phase}.replays"]
        assert abs(sum(parts.values()) / times[-1] - 1.0) < 0.05, (phase, parts, times[-1])
        assert abs(sum(times) / rec["device_s"] - 1.0) < 0.05, (phase, sum(times), rec["device_s"])
    ev = recs["eval"]["parts"]
    assert ev is not None and ev["forward"] > 0 and ev["rank"] > 0
    assert sum(ev.values()) <= recs["eval"]["device_s"]


@pytest.mark.gpu
def test_step_parts_wait_for_every_boundary(cuda):
    """A step called alone may mark only some boundaries: the parts are
    read once every boundary has been marked, not before."""
    parts = profiling.StepParts("probe", ("a", "b"))
    x = torch.ones(1 << 20, device=cuda)
    parts.mark(1, cuda)
    since = time.time_ns()
    with span("first", cuda):
        parts.claim(cuda)
    torch.cuda.synchronize(cuda)
    profiling.settle()
    assert parts.owner is not None
    with span("second", cuda):
        parts.claim(cuda)
        for i in range(3):
            parts.mark(i, cuda)
            x.mul_(1.0001)
    torch.cuda.synchronize(cuda)
    profiling.settle()
    recs = _by_name(span_records(since))
    assert recs["first"]["parts"] is None and parts.owner is None
    assert set(recs["second"]["parts"]) == {"a", "b"} and all(v > 0 for v in recs["second"]["parts"].values())


@pytest.mark.gpu
def test_replayed_epoch_counts_the_eager_epochs_k4_work(cuda):
    """K4's launches and bytes over a replayed epoch equal an eager
    Coach's over the same epoch, and epochs after the first capture
    nothing."""
    graphed = _tiktok_coach(cuda, graph_form="sparse")
    eager = _tiktok_coach(cuda, graph_form="sparse")
    eager.graphs.capture = False
    work = {}
    for name, coach in (("graphed", graphed), ("eager", eager)):
        coach.train_epoch(0)
        before = work_counts()
        since = time.time_ns()
        coach.train_epoch(1)
        after = work_counts()
        work[name] = {k: after[k] - before[k] for k in after if k.startswith("segsum")}
        recs = span_records(since)
        assert not any(k.endswith(".captures") for r in recs for k in r["graphs"]), name
        spans_k4 = sum(r["work"].get("segsum.bytes", 0) for r in recs if r["parent"] is None)
        assert spans_k4 == work[name]["segsum.bytes"]
    assert work["graphed"]["segsum"] > 0 and work["graphed"]["segsum.bytes"] > 0
    assert work["graphed"] == work["eager"]
    assert profiling.GRAPHS["joint.replays"] > 0


@pytest.mark.gpu
def test_span_stamps_bracket_the_card_trace(cuda):
    """On the card too, each phase span's host stamps bracket its named
    range in the profiler's trace within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    coach = _tiktok_coach(cuda)
    coach.train_epoch(0)
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        coach.train_epoch(1)
        torch.cuda.synchronize(cuda)
    recs = _by_name(span_records(since))
    seen = 0
    for ev in prof.profiler.kineto_results.events():
        rec = recs.get(ev.name())
        if rec is None or ev.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert 0 <= start - rec["enter_ns"] < 1_000_000, ev.name()
        assert 0 <= rec["exit_ns"] - end < 1_000_000, ev.name()
        seen += 1
    assert seen >= 5
