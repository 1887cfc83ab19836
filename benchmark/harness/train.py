"""Traffic kind ``train``: back-to-back training epochs, as ``Coach.run``
runs them, with the eval of every ``tstEpoch`` boundary.

One step is one call of the window: ``train_epoch`` and ``test_epoch`` where
the configuration's ``train.epoch_scan`` is 1, one fused chunk
(``train_epochs_fused`` with the eval on the card) where it is more; the
best-Recall epoch is captured as ``Coach.run`` captures it. No checkpoint is
written.

Set-up builds one Coach from the seed and drives it through the traffic's
``checked_steps`` first steps, which capture every phase's CUDA graph and
whose losses, evals and end states are kept (with the Adam moments and the
parameters' change after the first); that same Coach then runs the window.
The first step is always one epoch through ``train_epoch`` and
``test_epoch``, as ``Coach.run`` runs an epoch outside a whole chunk: a
fused chunk equals that many single epochs bit for bit
(``tests/test_torch_fused.py``), so the reference compares the first epoch's
numbers in every cell, and the later checked steps warm up the chunk.
Once the window has closed (and, with ``--trace 1``, the profiled steps and
the fenced epochs that give the phase times), the Coach is freed and the
plain reference (``benchmark/reference/diffmm.py``) trains from the same
seed on the same inputs through the first step, and follows the program's
own state after each checked step (:func:`~benchmark.harness.checks.
train_numbers`; PERF.md says why the later steps are not compared).

On a mesh (a rank of a cell whose configuration has ``mesh``; ``r.mesh``
its DeviceMesh) every rank makes the same inputs from the seed (one digest
of them is compared across the ranks at set-up) and builds its Coach with
``mesh=``. The window's clock is rank 0's: after each step rank 0 decides
whether the window has closed and every rank follows it, so each runs the
same whole steps. The records that the check reads are gathered whole
(``Coach._whole``; every rank takes part), and once every rank has freed
its state, rank 0 alone runs the single-device reference on its card.
"""

from __future__ import annotations

import copy
import gc
import hashlib
import math
import time

import numpy as np
import torch

from benchmark.harness import checks
from benchmark.harness.data import make_inputs
from benchmark.harness.trace import profiled
from benchmark.reference.diffmm import Reference, leaves

PHASES = ("neg_sampling", "diffusion", "rebuild", "joint")


def program_config(run, inputs):
    """The program's Config: the configuration's settings as they are run,
    the seed, and the inputs' sizes."""
    from diffmm_tpu_torch.config import config_from_dict

    pc = config_from_dict(copy.deepcopy(run.config["program"]), strict=True)
    pc.base.seed = run.seed
    pc.data.name = "synthetic"
    pc.data.user_num, pc.data.item_num = inputs.user_num, inputs.item_num
    for mod, d in zip(inputs.modalities, inputs.feat_dims):
        setattr(pc.data, f"{mod}_feat_dim", d)
    return pc


def host_data(inputs):
    from diffmm_tpu_torch.data.loader import HostData

    users = inputs.test_users
    return HostData(
        name="synthetic", user_num=inputs.user_num, item_num=inputs.item_num,
        modalities=list(inputs.modalities), feat_dims=list(inputs.feat_dims),
        train_rows=inputs.rows, train_cols=inputs.cols, user_degrees=inputs.degrees,
        csr_offsets=inputs.offsets, k_max=int(inputs.degrees.max()), raw_feats=list(inputs.feats),
        test_users=users, test_items=inputs.test_items[users], test_counts=inputs.test_counts[users],
    )


def _losses(result: dict, modalities) -> dict:
    out = {k: result[k] for k in checks.LOSS_KEYS}
    for m, mod in enumerate(modalities):
        out[f"modal{m} loss"] = result[f"{mod} loss"]
    return out


class ProgramSteps:
    """The window's call on a Coach: returns the step's loss dicts and eval
    dicts, one per epoch."""

    def __init__(self, coach, scan: int, split: str):
        self.coach, self.scan, self.split = coach, scan, split
        self.epoch = 0
        self.best = 0.0

    def __call__(self):
        c, e = self.coach, self.epoch
        if self.scan == 1 or e == 0:
            results = [c.train_epoch(e)]
            evals = [c.test_epoch(self.split) if e % c.config.train.tstEpoch == 0 else None]
            if evals[0] is not None and evals[0]["Recall"] > self.best:
                self.best = evals[0]["Recall"]
                c.capture_best(e)
        else:
            results, evals, bundle = c.train_epochs_fused(e, self.scan, self.split)
            best_at = None
            for j, ev in enumerate(evals):
                if ev is not None and ev["Recall"] > self.best:
                    self.best, best_at = ev["Recall"], e + j
            if best_at is not None and bundle is not None:
                c._capture_best_from(bundle[1], bundle[2], best_at)
        self.epoch += len(results)
        return results, evals


def _named(gcn: dict, dn: list) -> list:
    """(name, tensor) of every parameter leaf, in the optimizers' order."""
    out = [(f"gcn.{k}", v) for k, v in leaves(gcn)]
    for m, p in enumerate(dn):
        out += [(f"dn{m}.{k}", v) for k, v in leaves(p)]
    return out


def _mu_norms(gcn_state, dn_states, names) -> dict:
    mus = list(gcn_state.mu) + [t for s in dn_states for t in s.mu]
    return {n: float(torch.linalg.vector_norm(t.float())) for (n, _), t in zip(names, mus)}


def _whole_params(coach) -> tuple:
    """The parameter trees, whole: the live ones on one device; on a mesh
    gathered from the ranks' slices (a collective: every rank calls it)."""
    if coach.mesh is None:
        return coach.gcn_params, coach.dn_params
    whole = coach._whole(coach.gcn_params, coach.dn_params)
    return whole["gcn_params"], whole["dn_params"]


def _whole_states(coach) -> tuple:
    """The Adam states, whole (as :func:`_whole_params`)."""
    if coach.mesh is None:
        return coach.gcn_opt_state, coach.dn_opt_states
    whole = coach._whole(gcn_state=coach.gcn_opt_state, dn_states=coach.dn_opt_states)
    return whole["gcn_opt_state"], whole["dn_opt_states"]


def inputs_digest(inputs) -> str:
    """One digest of everything the inputs hold: the host arrays' bytes and
    the features' bits (summed on the device as integers, with weights by
    position, in blocks)."""
    h = hashlib.sha256()
    for a in (inputs.rows, inputs.cols, inputs.degrees, inputs.test_items, inputs.test_counts):
        h.update(np.ascontiguousarray(a).tobytes())
    for f in inputs.feats:
        bits = f.contiguous().view(-1).view(torch.int32)
        total = 0
        for lo in range(0, bits.numel(), 1 << 22):
            block = bits[lo:lo + (1 << 22)].to(torch.int64)
            weights = torch.arange(lo, lo + block.numel(), device=block.device, dtype=torch.int64) * 2 + 1
            total += int((block * weights).sum())
        h.update(f"{tuple(f.shape)}:{total}".encode())
    return h.hexdigest()


def _same_inputs(inputs) -> None:
    """Raise unless every rank made the same inputs."""
    import torch.distributed as dist

    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, inputs_digest(inputs))
    if len(set(digests)) > 1:
        raise RuntimeError(f"the ranks made different inputs from one seed: {digests}")


def _agreed(r, stop: bool) -> bool:
    """Rank 0's ``stop``, on every rank of a mesh (``stop`` as it is
    without one)."""
    if r.mesh is None:
        return stop
    import torch.distributed as dist

    flag = torch.tensor([int(stop)], device=r.device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def _snapshot(named) -> dict:
    return {n: t.detach().to("cpu", copy=True) for n, t in named}


def _delta(named, before: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.detach().float().cpu() - before[n])) for n, t in named}


def run(r) -> dict:
    """One run of a training cell (``r`` a :class:`benchmark.run.Run`)."""
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import NullLog

    traffic = r.traffic
    dev = r.device
    inputs = make_inputs(r.config["data"], r.seed, dev)
    if r.mesh is not None:
        _same_inputs(inputs)
    pc = program_config(r, inputs)
    coach = Coach(pc, host_data(inputs), device=dev, log=NullLog(), mesh=r.mesh)
    scan = max(1, int(pc.train.epoch_scan))
    steps = ProgramSteps(coach, scan, traffic["eval_split"])
    n_checked = int(traffic["checked_steps"])

    rec = program_records(coach, steps, n_checked, inputs)
    failed = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    r.note("card before window", smi=r.smi())

    # the window: whole steps until --seconds have passed
    t_start = time.perf_counter()
    setup_s = time.time() - r.t0
    epochs = 0
    while True:
        results, _ = steps()
        epochs += len(results)
        failed += sum(not all(math.isfinite(v) for v in x.values()) for x in results)
        elapsed = time.perf_counter() - t_start
        if _agreed(r, elapsed >= r.seconds):
            break
    train_epoch_s = elapsed / epochs
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    smi = r.smi()
    r.note("card after window", smi=smi)
    r.note("window", epochs=epochs, seconds=elapsed, train_epoch_s=train_epoch_s,
           max_memory_allocated=peak, setup_s=setup_s)

    layer = {"kind": "train", "train_epoch_s": train_epoch_s, "shape": shape(inputs, pc), "phases": {},
             "cards": r.world}
    summary = None
    if r.trace:
        traces = []
        n_steps = max(1, -(-int(traffic["trace_epochs"]) // scan))
        with profiled(dev, traces):
            for _ in range(n_steps):
                steps()
        summary = traces[0]
        layer["trace"] = summary
        layer["trace_epochs"] = n_steps * scan
        traced = summary.window_s / (n_steps * scan)
        r.note("tracing overhead", traced_epoch_s=traced, untraced_epoch_s=train_epoch_s,
               overhead=traced / train_epoch_s - 1.0)
        for _ in range(int(traffic["fenced_epochs"])):
            coach.timer.reset()
            coach.train_epoch(steps.epoch, fence=True)
            steps.epoch += 1
            for ph in PHASES:
                layer["phases"].setdefault(ph, []).append(coach.timer.totals.get(ph, 0.0))
        r.note("phases", **layer["phases"])

    # the check: the reference, once the program's state is freed
    del coach, steps
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = None
    if r.mesh is not None:
        import torch.distributed as dist

        dist.barrier()  # every rank's state is freed
    if r.rank == 0:
        t_ref = time.perf_counter()
        spec = r.config["program"]
        ref = reference_records(spec, inputs, r.seed, dev, 1, scan)
        follower = Reference(spec, inputs, r.seed, dev)
        numbers = checks.train_numbers(rec, ref, follower, inputs)
        r.note("reference", seconds=time.perf_counter() - t_ref)
    return {
        "metrics": {"setup_s": setup_s, "train_epoch_s": train_epoch_s},
        "attempted": epochs, "failed": failed, "numbers": numbers,
        "memory_peak_bytes": peak, "layer": layer, "trace": summary, "smi": smi,
    }


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    return tree.detach().to("cpu", copy=True)


def _keep_step(rec: dict, gcn, dn, edges, last_eval) -> None:
    """What the state-following checks read of a step's end: the GCN and
    denoiser parameters, the rebuilt edges, and the eval the step reported
    for its last epoch (which ranked that state)."""
    rec["steps"].append({"gcn": _host_tree(gcn), "dn": _host_tree(dn),
                         "edges": [e.detach().to("cpu", copy=True).numpy() for e in edges], "eval": last_eval})


def program_records(coach, steps, n_steps: int, inputs) -> dict:
    """The program's records over its first ``n_steps`` window calls: each
    epoch's losses and eval, each step's end state, after the first step
    the Adam first moments' norms and the parameters' change, and the
    embeddings that the first step's eval ranked. On a mesh the state is
    gathered whole on every rank (every rank calls this)."""
    before = _snapshot(_named(*_whole_params(coach)))
    rec = {"losses": [], "evals": [], "steps": [], "embed": None}
    for s in range(n_steps):
        if s == 0:
            # the first step's eval ranks the embeddings of the Coach's own
            # forward (eager in test_epoch): keep a copy of what it made
            forward = coach.forward

            def kept(*args, **kwargs):
                out = forward(*args, **kwargs)
                rec["embed"] = tuple(t.detach().to("cpu", copy=True) for t in out)
                return out

            coach.forward = kept
        results, evals = steps()
        if s == 0:
            del coach.forward
        rec["losses"] += [_losses(x, inputs.modalities) for x in results]
        evals = [{k: ev[k] for k in ("Recall", "NDCG")} for ev in evals if ev is not None]
        rec["evals"] += evals
        gcn, dn = _whole_params(coach)
        _keep_step(rec, gcn, dn, [b[: inputs.nnz] for b in coach.edge_buffers], evals[-1] if evals else None)
        if s == 0:
            names = _named(gcn, dn)
            rec["mu1"] = _mu_norms(*_whole_states(coach), names)
            rec["delta"] = _delta(names, before)
            del before
    return rec


def reference_records(spec: dict, inputs, seed: int, dev, n_steps: int, scan: int,
                      tf32: bool = False, fault: str | None = None) -> dict:
    """The reference's records over the same steps as the program's (one
    epoch, then chunks of ``scan``; in TF32 with ``tf32``, with a planted
    ``fault``)."""
    ref = Reference(spec, inputs, seed, dev, tf32=tf32, fault=fault)
    named = _named(ref.gcn, ref.dn)
    before = _snapshot(named)
    topk, test_batch = int(spec["base"]["topk"]), int(spec["train"]["test_batch"])
    tst = int(spec["train"]["tstEpoch"])
    rec = {"losses": [], "evals": [], "steps": [], "embed": None}
    e = 0
    for s in range(n_steps):
        last = None
        for _ in range(1 if s == 0 else scan):
            rec["losses"].append(ref.epoch(e))
            if e % tst == 0:
                if s == 0:
                    rec["embed"] = tuple(t.to("cpu", copy=True) for t in ref.final_embeddings())
                recall, ndcg, _ = ref.evaluate(topk, test_batch)
                n = len(inputs.test_users)
                last = {"Recall": recall / n, "NDCG": ndcg / n}
                rec["evals"].append(last)
            e += 1
        _keep_step(rec, ref.gcn, ref.dn, ref.edges, last)
        if s == 0:
            mus = list(ref.gcn_opt.mu) + [t for o in ref.dn_opts for t in o.mu]
            rec["mu1"] = {n: float(torch.linalg.vector_norm(t)) for (n, _), t in zip(named, mus)}
            rec["delta"] = _delta(named, before)
            del before
    return rec


def shape(inputs, pc) -> dict:
    """The sizes the per-layer counters read."""
    return {
        "users": inputs.user_num, "items": inputs.item_num, "nnz": inputs.nnz,
        "feat_dims": list(inputs.feat_dims), "latdim": pc.base.latdim,
        "hidden": pc.base.denoise_dims(), "d_emb": pc.base.d_emb_size, "steps": pc.hyper.steps,
        "batch": pc.train.batch, "test_batch": pc.train.test_batch, "topk": pc.base.topk,
        "cl_method": pc.base.cl_method, "graph_form": pc.train.graph_form,
        "dense_store": pc.train.dense_store, "tst_epoch": pc.train.tstEpoch,
        "epoch_scan": pc.train.epoch_scan,
    }
