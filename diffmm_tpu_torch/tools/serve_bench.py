"""End-to-end latency benchmark of the port's HTTP serving front end,
counterpart of ``tools/serve_bench.py``.

It starts ``python -m diffmm_tpu_torch.eval.serve_http`` on an exported
index (on the card, or the CPU with ``--device cpu``), warms the k bucket,
then drives closed-loop ``GET /recommend`` traffic from N client threads
and prints p50/p95/p99 latency and throughput as one JSON line.

  python -m diffmm_tpu_torch.tools.serve_bench index.npz --requests 2000 --clients 4
  python -m diffmm_tpu_torch.tools.serve_bench synthetic:9308,6710,64   # tiktok shape
  python -m diffmm_tpu_torch.tools.serve_bench synthetic:60,40,8 --device cpu

``synthetic:U,I,d`` writes a random-embedding index of that shape first
(the JAX tool's, from the same seed): a request is one product and one
top-k, whose time does not depend on the learned values, so any deployment
shape can be measured without a training run.

``--model-shards M`` serves the catalog in M shards, which needs M ranks:
the server is started as ``python -m torch.distributed.run
--nproc_per_node M -m diffmm_tpu_torch.eval.serve_http ... --model-shards
M``. Under NCCL each rank takes a card of its own, so on one card that
form runs with ``--device cpu`` (gloo).

``SERVE_BENCH_CHILD_ENV``, a JSON object of environment overrides for the
server (value null = unset), sets the server's environment apart from this
process's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from diffmm_tpu_torch.parallel.mesh import free_port

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _synthesize_index(spec: str) -> str:
    """``synthetic:U,I,d`` -> the path of a temporary npz with random
    embeddings and about 12 seen items a user in the CSR export form (so
    ``mask_seen`` does real work)."""
    u, i, d = (int(v) for v in spec.split(":", 1)[1].split(","))
    rng = np.random.default_rng(0)
    path = os.path.join(tempfile.mkdtemp(prefix="serve_bench_"), "index.npz")
    counts = rng.poisson(12.0, u).clip(1, i)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = rng.integers(0, i, int(indptr[-1])).astype(np.int32)
    np.savez(
        path,
        u_final=rng.standard_normal((u, d), dtype=np.float32),
        i_final=rng.standard_normal((i, d), dtype=np.float32),
        seen_indptr=indptr,
        seen_indices=indices,
    )
    return path


def _wait_health(base: str, server: subprocess.Popen, deadline_s: float = 600.0) -> dict:
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        if server.poll() is not None:
            raise SystemExit(f"server exited with code {server.returncode} before becoming "
                             "healthy; see its stderr above")
        try:
            with urllib.request.urlopen(f"{base}/health", timeout=5) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.5)
    raise SystemExit("server never became healthy")


def server_command(index: str, port: int, k: int, device: str | None, approx: bool,
                   model_shards: int) -> list[str]:
    """The server's command line: ``serve_http`` in one process, or under
    ``torch.distributed.run`` with M ranks for ``model_shards`` M > 1."""
    serve = ["-m", "diffmm_tpu_torch.eval.serve_http", index, "--port", str(port), "--warmup", str(k)]
    if device:
        serve += ["--device", device]
    if approx:
        serve.append("--approx")
    if model_shards == 1:
        return [sys.executable, *serve]
    return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(model_shards),
            "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
            *serve, "--model-shards", str(model_shards)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("index", help="npz index from --export-index (either package's), or synthetic:U,I,d")
    p.add_argument("--port", type=int, default=None, help="the server's port (default: a free one)")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--requests", type=int, default=2000)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--approx", action="store_true")
    p.add_argument("--device", default=None,
                   help="the server's device: cuda (the default; needs a card) or cpu")
    p.add_argument("--model-shards", type=int, default=1, metavar="M",
                   help="serve_http --model-shards M over M ranks of torch.distributed.run "
                   "(catalog shards, exact distributed top-k); one card a rank under NCCL, so on "
                   "one card pass --device cpu")
    args = p.parse_args(argv)

    synthetic = args.index.startswith("synthetic:")
    index = _synthesize_index(args.index) if synthetic else os.path.abspath(args.index)
    port = args.port or free_port()
    cmd = server_command(index, port, args.k, args.device, args.approx, args.model_shards)
    env = os.environ.copy()
    for key, val in json.loads(os.environ.get("SERVE_BENCH_CHILD_ENV", "{}")).items():
        if val is None:
            env.pop(key, None)
        else:
            env[key] = str(val)
    server = subprocess.Popen(cmd, cwd=REPO, env=env)
    base = f"http://127.0.0.1:{port}"
    try:
        health = _wait_health(base, server)
        users = health["users"]
        lat: list[float] = []
        lock = threading.Lock()
        n_done = 0

        def client(cid: int) -> None:
            nonlocal n_done
            rng_state = cid * 2654435761 % users
            local: list[float] = []
            while True:
                with lock:
                    if n_done >= args.requests:
                        break
                    n_done += 1
                rng_state = (rng_state * 1103515245 + 12345) % users
                t0 = time.perf_counter()
                with urllib.request.urlopen(f"{base}/recommend?user={rng_state}&k={args.k}",
                                            timeout=30) as r:
                    body = json.loads(r.read())
                local.append(time.perf_counter() - t0)
                assert len(body["items"]) == args.k
            with lock:
                lat.extend(local)

        # one priming request (the server's --warmup ran each k already)
        with urllib.request.urlopen(f"{base}/recommend?user=0&k={args.k}") as r:
            r.read()
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
        lat.sort()

        def pct(q: float) -> float:
            return lat[min(len(lat) - 1, int(q * len(lat)))]

        print(json.dumps({
            "metric": "serve_http_latency",
            "unit": "ms",
            "users": health["users"],
            "items": health["items"],
            "k": args.k,
            "clients": args.clients,
            "requests": len(lat),
            "p50_ms": pct(0.50) * 1e3,
            "p95_ms": pct(0.95) * 1e3,
            "p99_ms": pct(0.99) * 1e3,
            "throughput_rps": len(lat) / wall,
            "device": args.device or "cuda",
            "approx": args.approx,
            "model_shards": args.model_shards,
        }), flush=True)
        return 0
    finally:
        server.terminate()
        server.wait(timeout=30)
        if synthetic:
            shutil.rmtree(os.path.dirname(index))


if __name__ == "__main__":
    raise SystemExit(main())
