"""The numbers that decide ``correct``, and their judgment against the
cell's limits (``benchmark/limits/<workload>.json``; PERF.md gives the
readings each limit was set from)."""

from __future__ import annotations

import json
import math
import sys

import numpy as np

LOSS_KEYS = ("Loss", "BPR Loss", "reg loss", "CL loss")
# a leaf whose gradient, in the reference, is below this share of the median
# leaf's moves by round-off alone and is left out of the leaf comparisons
NEGLIGIBLE_LEAF = 1e-3


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def worst_leaf(prog: dict, ref: dict, keep: list[str]) -> tuple[float, str]:
    """The largest gap of norms over the kept leaves, each against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; with the leaf it came from."""
    median = float(np.median([ref[k] for k in keep]))
    worst, at = 0.0, ""
    for k in keep:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
        if not math.isfinite(prog[k]):
            gap = math.inf
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def _median_leaf(prog: dict, ref: dict, keep: list[str]) -> float:
    """The median over the kept leaves of the gap of norms (each measured
    as in :func:`worst_leaf`)."""
    median = float(np.median([ref[k] for k in keep]))
    return float(np.median([abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keep]))


def train_numbers(cand: dict, truth: dict, follower, inputs) -> dict:
    """The training cells' numbers (PERF.md, "How correct is decided") of a
    candidate's records (the program's, or the control's) against the
    reference's independent run (``truth``) and against the reference
    following the candidate's own state (``follower``, a
    :class:`~benchmark.reference.diffmm.Reference`):

    * ``loss.diffusion``: the widest relative gap of the first epoch's
      diffusion losses; ``loss.total``, ``loss.bpr``, ``loss.reg``,
      ``loss.cl``: that of its joint losses, each;
    * ``grad1``, ``grad1.median``: the gap of the Adam first moment's norm
      after the first step (the gradient as the optimizer holds it), worst
      and median leaf;
    * ``change``, ``change.median``: the gap of the parameters' change over
      the first step, worst and median leaf;
    * ``rebuild``: after each checked step, how far the candidate's rebuilt
      graphs lie below the top-degree items that its own denoisers give in
      the reference (:meth:`Reference.rebuild_gap`);
    * ``embed``: the widest gap between an embedding that the first step's
      eval ranked and the reference's forward of the candidate's parameters
      over its rebuilt graphs at that point, over the largest magnitude of
      the reference's table (users and items, the worse);
    * ``eval``: after each checked step, the relative gap between the Recall
      and NDCG the candidate reported and the reference's eval of the
      candidate's parameters and graphs."""
    out = {}
    c0, t0 = cand["losses"][0], truth["losses"][0]
    out["loss.diffusion"] = max(_rel(c0[k], t0[k]) for k in t0 if k not in LOSS_KEYS)
    for name, key in zip(("loss.total", "loss.bpr", "loss.reg", "loss.cl"), LOSS_KEYS):
        out[name] = _rel(c0[key], t0[key])
    median = float(np.median(list(truth["mu1"].values())))
    keep = [k for k, v in truth["mu1"].items() if v >= NEGLIGIBLE_LEAF * median]
    left = sorted(set(truth["mu1"]) - set(keep))
    if left:
        print(f"checks: leaves left out (reference gradient under {NEGLIGIBLE_LEAF} of the median leaf's): "
              f"{left}", file=sys.stderr)
    out["grad1"], at1 = worst_leaf(cand["mu1"], truth["mu1"], keep)
    out["grad1.median"] = _median_leaf(cand["mu1"], truth["mu1"], keep)
    out["change"], at2 = worst_leaf(cand["delta"], truth["delta"], keep)
    out["change.median"] = _median_leaf(cand["delta"], truth["delta"], keep)
    print(f"checks: worst leaf grad1 {at1}, change {at2}", file=sys.stderr)
    spec = follower.base["topk"], follower.train["test_batch"]
    rebuild = evals = 0.0
    for step in cand["steps"]:
        dn = [_to(p, follower.dev) for p in step["dn"]]
        rebuild = max(rebuild, follower.rebuild_gap(dn, step["edges"]))
        if step["eval"] is not None:
            recall, ndcg, _ = follower.evaluate(*spec, gcn=_to(step["gcn"], follower.dev),
                                                modal_graphs=follower.graphs_of(step["edges"]))
            n = len(inputs.test_users)
            evals = max(evals, _rel(step["eval"]["Recall"], recall / n), _rel(step["eval"]["NDCG"], ndcg / n))
    out["rebuild"], out["eval"] = rebuild, evals
    out["embed"] = math.inf
    first = cand["steps"][0]
    if cand["embed"] is not None:
        want = follower.final_embeddings(_to(first["gcn"], follower.dev), follower.graphs_of(first["edges"]))
        out["embed"] = max(_table_gap(got, ref) for got, ref in zip(cand["embed"], want))
    return out


def _table_gap(got, ref) -> float:
    ref = ref.float().cpu()
    gap = float((got.float() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    return gap if math.isfinite(gap) else math.inf


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device).float()


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each number beside its limit (None: read and
    printed, not compared); correct when every compared number is finite
    and at or under its limit."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, checks


def print_checks(checks: dict) -> None:
    """The compared numbers, each beside its limit: the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print("checks " + json.dumps(checks), file=sys.stderr, flush=True)
