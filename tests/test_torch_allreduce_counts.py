"""The mesh's collectives in the work counters (``parallel/collectives.py``,
``ops/kernels`` ``count_allreduce``): on four gloo ranks each all-reduce's
calls and bytes are counted under the site that asks for it, and every
``torch.distributed`` all-reduce over more than one rank in a mesh epoch
goes through the counted funnel; the mesh's steps mark a ``reduce`` part around the gradients' sum.
One device runs no collective, so it records no ``allreduce.*`` counter and
no ``reduce`` part."""

from __future__ import annotations

import copy
from collections import defaultdict

import pytest
import torch

from diffmm_tpu_torch.ops.kernels import ALLREDUCE_SITES, count_allreduce, work_counts
from diffmm_tpu_torch.parallel.launch import run_ranks

SITES = ("grads", "propagate", "gather", "topk", "other")


def _config():
    from diffmm_tpu_torch.config import Config

    cfg = Config()
    cfg.base.seed = 11
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[16]"
    cfg.train.batch = 32
    cfg.train.test_batch = 32
    cfg.train.graph_form = "sparse"
    cfg.hyper.steps = 3
    return cfg


def _host(cfg):
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data

    return make_synthetic_host_data(cfg, user_num=48, item_num=64, seed=5)


def _allreduce_delta(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in work_counts().items()
            if k.startswith("allreduce.") and n != before.get(k, 0)}


def _marked_parts(patch) -> list:
    """Wrap ``StepParts.mark`` (through ``patch``, ``setattr`` or a
    monkeypatch's) so that each mark logs its step's parts and the boundary
    marked; returns the log."""
    from diffmm_tpu_torch.utils.profiling import StepParts

    log = []
    mark = StepParts.mark

    def logged(self, i, device):
        log.append((self.name, self.parts, i))
        return mark(self, i, device)

    patch(StepParts, "mark", logged)
    return log


def _calls_on_rank():
    """Each entry of the collectives once or twice, by hand; returns the
    counted deltas and the buffers' sizes by site."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    from diffmm_tpu_torch.parallel.collectives import (
        AllGatherRows,
        AllReduceSum,
        all_reduce_grads,
        all_reduce_sum_,
        placed_all_reduce,
    )

    rank, world, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    one = dist.new_group([rank], use_local_synchronization=True)
    before = work_counts()
    assert not any(k.startswith("allreduce.") for k in before)
    want = defaultdict(int)

    def made(site, t):
        want[f"allreduce.{site}.calls"] += 1
        want[f"allreduce.{site}.bytes"] += t.numel() * t.element_size()

    x = torch.ones(5)
    made("other", x)
    all_reduce_sum_(x, group)
    y = torch.ones((3, 2), dtype=torch.int32)
    made("propagate", y)
    all_reduce_sum_(y, group, "propagate")
    z = torch.randn((4, 3), requires_grad=True)
    AllReduceSum.apply(z, group, "propagate").sum().backward()  # the forward and the backward's sum
    made("propagate", z)
    made("propagate", z)
    frame = placed_all_reduce(torch.ones((2, 3)), 2 * rank, 2 * world, group)
    made("gather", frame)
    frame = placed_all_reduce(torch.ones((2, 5), dtype=torch.int64), 5 * rank, 5 * world, group, dim=1,
                              site="topk")
    made("topk", frame)
    rows = torch.randn((2, 3), requires_grad=True)
    whole = AllGatherRows.apply(rows, 2 * rank, 2 * world, group)
    whole.sum().backward()
    made("gather", whole)
    made("gather", whole)
    grads = [torch.ones(3), torch.ones(4, dtype=torch.bfloat16), torch.ones((2, 2))]
    all_reduce_grads(grads, group)  # one flat buffer a dtype
    want["allreduce.grads.calls"] += 2
    want["allreduce.grads.bytes"] += 4 * (3 + 4) + 2 * 4
    all_reduce_sum_(torch.ones(7), one)  # a group of one rank: not counted
    return _allreduce_delta(before), dict(want)


def _mesh_epoch_on_rank():
    """One sparse-form epoch and its eval on a 4x1 mesh, with every
    ``torch.distributed.all_reduce`` tallied beside the counters, and the
    steps' marks logged."""
    import torch.distributed as dist

    from diffmm_tpu_torch.parallel.mesh import make_mesh
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import NullLog

    torch.set_num_threads(1)
    seen = {"calls": 0, "bytes": 0}
    reduce = dist.all_reduce

    def tallied(t, op=dist.ReduceOp.SUM, group=None, **kwargs):
        if dist.get_world_size(group) > 1:  # the model axis's groups of one rank move nothing
            seen["calls"] += 1
            seen["bytes"] += t.numel() * t.element_size()
        return reduce(t, op=op, group=group, **kwargs)

    dist.all_reduce = tallied
    log = _marked_parts(setattr)
    cfg = _config()
    coach = Coach(cfg, _host(cfg), device="cpu", log=NullLog(), mesh=make_mesh(4, model_parallel=1))
    before = work_counts()
    coach.train_epoch(0)
    coach.test_epoch("test")
    return _allreduce_delta(before), seen, log


@pytest.fixture(scope="module")
def four_ranks():
    return run_ranks(_calls_on_rank, 4), run_ranks(_mesh_epoch_on_rank, 4)


def test_sites_are_the_programs():
    assert ALLREDUCE_SITES == SITES
    with pytest.raises(ValueError, match="unknown all-reduce site 'elsewhere'"):
        count_allreduce("elsewhere", 4)  # refused before anything is counted
    assert not any(k.startswith("allreduce.") for k in work_counts())


def test_bytes_by_site_are_the_buffers_summed(four_ranks):
    by_hand, _ = four_ranks
    for counted, want in by_hand:
        assert counted == want
        assert set(counted) == {f"allreduce.{s}.{k}" for s in SITES for k in ("calls", "bytes")}


def test_a_mesh_epoch_counts_every_all_reduce(four_ranks):
    """Every all-reduce of a sparse epoch and its eval on the 4x1 mesh is
    counted, under the sites that run there: the gradients' sums, K4's mesh
    form, and the losses', negatives', tables' and eval's sums (the model
    axis's gathers and top-k merges run over groups of one rank)."""
    _, epochs = four_ranks
    for counted, seen, _ in epochs:
        calls = sum(n for k, n in counted.items() if k.endswith(".calls"))
        n_bytes = sum(n for k, n in counted.items() if k.endswith(".bytes"))
        assert (calls, n_bytes) == (seen["calls"], seen["bytes"]) and calls > 0
        assert {k.split(".")[1] for k in counted} == {"grads", "propagate", "other"}
    assert len({tuple(sorted(c.items())) for c, _, _ in epochs}) == 1  # the same on every rank


def test_mesh_steps_mark_a_reduce_part(four_ranks):
    from diffmm_tpu_torch.train import steps

    _, epochs = four_ranks
    for _, _, log in epochs:
        log = [m for m in log if m[0] != "eval"]
        marked = {(name, parts) for name, parts, _ in log}
        assert marked == {("diffusion", steps.MESH_DIFFUSION_PARTS.parts), ("joint", steps.MESH_JOINT_PARTS.parts)}
        for name, parts, i in log:
            assert 0 <= i <= len(parts)
        for name in ("diffusion", "joint"):
            parts = dict((n, p) for n, p, _ in log)[name]
            at = {i for n, _, i in log if n == name}
            assert at == set(range(len(parts) + 1)) and parts[-2:] == ("reduce", "adam")


def test_one_device_records_no_collective_and_no_reduce_part(monkeypatch):
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import NullLog

    log = _marked_parts(monkeypatch.setattr)
    cfg = _config()
    coach = Coach(copy.deepcopy(cfg), _host(cfg), device="cpu", log=NullLog())
    coach.train_epoch(0)
    coach.test_epoch("test")
    assert not any(k.startswith("allreduce.") for k in work_counts())
    assert {(name, parts) for name, parts, _ in log if name != "eval"} == {
        ("diffusion", steps.DIFFUSION_PARTS.parts), ("joint", steps.JOINT_PARTS.parts)}
    assert all("reduce" not in parts for _, parts, _ in log)


def _refuse_all_reduce(monkeypatch):
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise AssertionError("one device called torch.distributed.all_reduce")

    monkeypatch.setattr(dist, "all_reduce", refuse)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_one_device_is_a_split_of_one_and_calls_no_collective(monkeypatch, form):
    """A one-device Coach runs its steps on the split of one rank
    (``make_split(None, item_num)``: whole shares with no process group, the
    whole catalog, every leaf replicated) and never reaches
    ``torch.distributed.all_reduce``: an epoch, its eval and a fused chunk
    of two with evals."""
    import numpy as np

    from diffmm_tpu_torch.parallel.sharding import REPLICATED, Shard, make_split
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import NullLog

    _refuse_all_reduce(monkeypatch)
    cfg = _config()
    cfg.train.graph_form = form
    cfg.train.epoch_scan, cfg.train.tstEpoch = 2, 1
    coach = Coach(copy.deepcopy(cfg), _host(cfg), device="cpu", log=NullLog())
    assert coach.dense_graphs == (form == "dense")
    assert coach.split == make_split(None, 64)
    alone = Shard(0, 1, None)
    assert (coach.split.rows, coach.split.world, coach.split.cat) == (alone, alone, None)
    assert (coach.split.lo, coach.split.hi, coach.split.gcn_place, coach.split.dn_place) == (0, 64, REPLICATED, REPLICATED)
    losses = coach.train_epoch(0)
    evals = [coach.test_epoch("test")]
    results, fused_evals, best = coach.train_epochs_fused(1, 2, "test")
    evals += fused_evals
    assert all(np.isfinite(v) for r in [losses, *results] for v in r.values())
    assert all(0.0 <= e["Recall"] <= 1.0 for e in evals) and best is not None


def test_collectives_without_a_group_return_their_input(monkeypatch):
    """A ``None`` group is one device: each collective helper gives its
    input back as it is (no frame, no copy), the autograd forms' backward
    the cotangent as it is, and nothing reaches ``torch.distributed``."""
    from diffmm_tpu_torch.parallel.collectives import (
        AllGatherRows,
        AllReduceSum,
        all_reduce_grads,
        all_reduce_sum_,
        placed_all_reduce,
    )

    _refuse_all_reduce(monkeypatch)
    before = work_counts()
    x = torch.arange(6.0).reshape(3, 2)
    assert all_reduce_sum_(x, None, "grads") is x
    assert placed_all_reduce(x, 0, 3, None) is x
    assert all_reduce_grads([x], None)[0] is x
    y = x.clone().requires_grad_()
    out = AllGatherRows.apply(AllReduceSum.apply(y, None), 0, 3, None)
    assert out.data_ptr() == y.data_ptr()
    (out * 2.0).sum().backward()
    assert torch.equal(y.grad, torch.full_like(x, 2.0))
    assert _allreduce_delta(before) == {}
