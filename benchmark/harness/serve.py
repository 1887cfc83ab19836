"""Traffic kind ``serve``: an open loop of single-user top-k requests
through ``eval/serving.py::recommend``, in process.

The index is the configuration's catalog with random f32 embeddings drawn
from the seed on the device and the seen lists of the generated train
edges, which the program turns into its CSR (``seen_csr_from_edges``).
Arrivals are a Poisson process at the traffic's fixed rate, drawn from the
traffic's ``arrival_seed`` and scaled to fill the window exactly: every seed
offers the same arrivals, so the queue sees the same bursts. Each request
names one user, Zipf-distributed over a permutation of the users drawn from
the run's seed.

One thread sends and serves: a request waits, if it is early, until it is
due, and is timed from when it was due to when its ids and scores are on
the host, so a stall delays the requests behind it and counts in their
latency. After the window every answer is checked against the reference
(``benchmark/reference/serving.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import health
from benchmark.harness.data import derive_seed, make_inputs
from benchmark.harness.trace import profiled
from benchmark.reference.serving import answer_numbers


def percentile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by the nearest rank below
    (``tools/serve_bench.py``'s ``pct``)."""
    lat = sorted(values)
    return lat[min(len(lat) - 1, int(q * len(lat)))]


def schedule(traffic: dict, seconds: float, seed: int, user_num: int):
    """``(due (n,) seconds from the window's start, users (n,))``."""
    rate = float(traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(int(traffic["arrival_seed"])).exponential(1.0, n)
    due = (np.cumsum(gaps) - gaps[0]) * (seconds / gaps.sum())
    rng = np.random.default_rng(derive_seed(seed, 4))
    ranks = np.arange(1, user_num + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -float(traffic["zipf_s"]))
    cdf /= cdf[-1]
    picks = np.minimum(np.searchsorted(cdf, rng.random(n)), user_num - 1)
    users = rng.permutation(user_num)[picks].astype(np.int64)
    return due, users


def open_loop(serve, due: np.ndarray, users: np.ndarray, clock=time.perf_counter, wait=None):
    """Send request j at ``due[j]`` seconds after the start, or as soon as
    the one before it returns; ``serve(j, user)`` answers request j.
    Returns (latency from due, lateness of the start, service time), each
    per request."""
    n = len(due)
    lat, late, service = np.empty(n), np.empty(n), np.empty(n)
    t0 = clock()
    for j in range(n):
        at = t0 + due[j]
        now = clock()
        while now < at:
            if wait is not None:
                wait(at - now)
            elif at - now > 2e-3:
                time.sleep(at - now - 1e-3)
            now = clock()
        start = now
        serve(j, int(users[j]))
        done = clock()
        lat[j], late[j], service[j] = done - at, start - at, done - start
    return lat, late, service


def build(r):
    """The cell's inputs, embeddings, the program's index, and a maker of
    request functions: ``(inputs, u_emb, i_emb, index, server)``, where
    ``server(n)`` gives ``(serve, ids, scores)``: ``serve(j, user)`` answers
    one request through ``recommend`` and copies its ids and scores to the
    host, into row j of the preallocated (n, k) arrays (the loop keeps no
    object of its own per request)."""
    from diffmm_tpu_torch.eval.serving import RecIndex, recommend, seen_csr_from_edges

    traffic, dev = r.traffic, r.device
    inputs = make_inputs(r.config["data"], r.seed, dev, with_feats=False)
    d = int(traffic["emb_dim"])
    gen = torch.Generator(device=dev).manual_seed(derive_seed(r.seed, 3))
    u_emb = torch.randn((inputs.user_num, d), generator=gen, device=dev)
    i_emb = torch.randn((inputs.item_num, d), generator=gen, device=dev)
    indptr, indices, width = seen_csr_from_edges(inputs.rows, inputs.cols, inputs.user_num)
    index = RecIndex(u_emb, i_emb, torch.as_tensor(indptr, device=dev),
                     torch.as_tensor(indices, device=dev), width)
    k = int(traffic["k"])

    def server(n: int):
        ids = np.empty((n, k), dtype=np.int64)
        scores = np.empty((n, k), dtype=np.float32)

        def serve(j: int, user: int) -> None:
            got_ids, got_scores = recommend(index, torch.tensor([user]), k)
            ids[j] = got_ids.cpu().numpy()[0]
            scores[j] = got_scores.cpu().numpy()[0]

        return serve, ids, scores

    return inputs, u_emb, i_emb, index, server


def run(r) -> dict:
    """One run of a serving cell (``r`` a :class:`benchmark.run.Run`)."""
    from diffmm_tpu_torch.eval.serving import warmup

    traffic, dev = r.traffic, r.device
    inputs, u_emb, i_emb, index, server = build(r)
    k = int(traffic["k"])
    warmup(index, [k])
    due, users = schedule(traffic, r.seconds, r.seed, inputs.user_num)
    w_n = int(traffic["warmup_requests"])
    open_loop(server(w_n)[0], due[:w_n] * 0.0, users[:w_n])
    serve, ids, scores = server(len(due))
    health.note("card before window", smi=r.smi())

    setup_s = time.time() - r.t0
    lat, late, service = open_loop(serve, due, users)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    health.note("card after window", smi=r.smi())
    p95 = percentile(lat, 0.95) * 1e3
    health.note("window", requests=len(lat), serve_p95_ms=p95, p50_ms=percentile(lat, 0.5) * 1e3,
                p99_ms=percentile(lat, 0.99) * 1e3, max_memory_allocated=peak, setup_s=setup_s)
    health.note("generator lateness", p50_ms=percentile(late, 0.5) * 1e3, p99_ms=percentile(late, 0.99) * 1e3,
                max_ms=float(late.max()) * 1e3, service_p50_ms=percentile(service, 0.5) * 1e3)

    layer = {"kind": "serve"}
    summary = None
    if r.trace:
        n_tr = max(1, int(float(traffic["trace_seconds"]) * float(traffic["rate_per_s"])))
        t_due, t_users = schedule(traffic, float(traffic["trace_seconds"]), r.seed + 1, inputs.user_num)
        traces = []
        with profiled(dev, traces):
            _, _, t_service = open_loop(server(n_tr)[0], t_due[:n_tr], t_users[:n_tr])
        summary = traces[0]
        layer["trace"] = summary
        layer["service_s"] = t_service
        health.note("tracing overhead", traced_service_p50_ms=percentile(t_service, 0.5) * 1e3,
                    untraced_service_p50_ms=percentile(service, 0.5) * 1e3)

    numbers = answer_numbers(u_emb, i_emb, inputs.rows, inputs.cols, users, ids, scores, k)
    return {
        "metrics": {"setup_s": setup_s, "serve_p95_ms": p95},
        "attempted": len(due), "failed": 0, "numbers": numbers,
        "memory_peak_bytes": peak, "layer": layer, "trace": summary,
    }
