"""Minimal HTTP serving front end over an exported recommendation index.

    python -m diffmm_tpu_torch.eval.serve_http index.npz --port 8188 [--warmup 10,20]
    python -m diffmm_tpu_torch.eval.serve_http index.npz --device cpu [--approx]
    torchrun --nproc_per_node M -m diffmm_tpu_torch.eval.serve_http index.npz --model-shards M

    GET /health            -> {"status": "ok", "users": U, "items": I}
    GET /recommend?user=42&k=20[&mask_seen=0] -> {"user": 42, "items": [...],
                                                  "scores": [...]}

Counterpart of ``diffmm_tpu/eval/serve_http.py``: the stdlib
``ThreadingHTTPServer``, the same paths, JSON and 400/404 errors, one
:func:`~diffmm_tpu_torch.eval.serving.recommend` (a product and a top-k)
per request. The index goes onto the card unless ``--device cpu`` is
given; without a card the server stops with an error, it does not move to
the CPU. Each request runs on a new host thread, which takes the index's
device first; the first product on a thread also creates that thread's
cuBLAS handle, a cost ``--warmup`` (run on the main thread) cannot take
ahead. ``--approx`` is the JAX package's ``approx_max_k`` (recall target
0.95), which off the TPU is the exact top-k; the port serves that exact
top-k (``eval/serving.py``), so ``--approx`` answers as the JAX package's
server does on any backend but the TPU. It is a server-wide setting: under
``--model-shards`` every rank takes it at startup.

``--model-shards M`` (JAX ``serve_http.py:92-124``) serves the catalog in
M shards, one a rank of a group of M processes started by ``torchrun
--nproc_per_node M`` (NCCL on cards, gloo with ``--device cpu``); M must
be the world size. Each rank keeps its catalog rows (``place_index``).
Rank 0 binds HTTP and answers ``/health``; for each request it broadcasts
``(go, B, k, mask_seen)`` and the user ids, and every rank runs
``recommend`` over the model axis together (:class:`ShardedRecommender`);
the other ranks wait in :func:`follow` for the next broadcast or the stop
that rank 0 sends when its server ends. A catalog M does not divide is
served replicated, with the JAX package's warning.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from diffmm_tpu_torch.eval.serving import RecIndex, _catalog, load_index, recommend, warmup


class ShardedRecommender:
    """``recommend`` over a mesh's model axis, called on rank 0 by the
    request threads: under one lock (every rank must make the same
    collectives in the same order) it broadcasts the request's header
    ``(go=1, B, k, mask_seen)`` and user ids to the axis, whose other ranks
    run :func:`follow`, then runs its own part of ``recommend``.
    :meth:`stop` sends ``go=0``. ``approx`` is the server's, the same on
    every rank (:func:`follow` takes it at startup)."""

    def __init__(self, index: RecIndex, mesh, approx: bool = False):
        from diffmm_tpu_torch.parallel.mesh import MODEL_AXIS

        self.index, self.mesh, self.approx = index, mesh, approx
        self.group = mesh.get_group(MODEL_AXIS)
        self.lock = threading.Lock()

    def __call__(self, users: torch.Tensor, k: int, mask_seen: bool):
        import torch.distributed as dist

        dev = self.index.u_final.device
        with self.lock:
            header = torch.tensor([1, users.shape[0], k, int(mask_seen)], dtype=torch.int64, device=dev)
            dist.broadcast(header, dist.get_global_rank(self.group, 0), group=self.group)
            users = users.to(device=dev, dtype=torch.int64).contiguous()
            dist.broadcast(users, dist.get_global_rank(self.group, 0), group=self.group)
            return recommend(self.index, users, k, mask_seen, mesh=self.mesh, approx=self.approx)

    def stop(self) -> None:
        import torch.distributed as dist

        with self.lock:
            header = torch.zeros(4, dtype=torch.int64, device=self.index.u_final.device)
            dist.broadcast(header, dist.get_global_rank(self.group, 0), group=self.group)


def follow(index: RecIndex, mesh, approx: bool = False) -> int:
    """The loop of a model rank other than 0: take each broadcast request
    and run its part of ``recommend`` (with the server's ``approx``), until
    rank 0's stop. Returns the number of requests served."""
    import torch.distributed as dist

    from diffmm_tpu_torch.parallel.mesh import MODEL_AXIS

    group = mesh.get_group(MODEL_AXIS)
    src = dist.get_global_rank(group, 0)
    dev = index.u_final.device
    served = 0
    while True:
        header = torch.empty(4, dtype=torch.int64, device=dev)
        dist.broadcast(header, src, group=group)
        go, batch, k, mask_seen = header.tolist()
        if not go:
            return served
        users = torch.empty(batch, dtype=torch.int64, device=dev)
        dist.broadcast(users, src, group=group)
        recommend(index, users, k, bool(mask_seen), mesh=mesh, approx=approx)
        served += 1


def make_handler(index: RecIndex, recommender=None, approx: bool = False):
    """The request handler class over ``index`` (JAX ``make_handler``):
    each request one ``recommend`` with ``approx``; ``recommender`` (a
    :class:`ShardedRecommender`, which carries its own ``approx``) answers
    in place of a direct ``recommend``."""
    user_num = int(index.u_final.shape[0])
    item_num = _catalog(index)
    dev = index.u_final.device

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args) -> None:  # quiet
            pass

        def do_GET(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            if url.path == "/health":
                return self._send(200, {"status": "ok", "users": user_num, "items": item_num})
            if url.path != "/recommend":
                return self._send(404, {"error": f"unknown path {url.path}"})
            q = parse_qs(url.query)
            try:
                user = int(q["user"][0])
                k = int(q.get("k", ["20"])[0])
                mask_seen = q.get("mask_seen", ["1"])[0] not in ("0", "false")
            except (KeyError, ValueError) as e:
                return self._send(400, {"error": f"bad query: {e}"})
            if not (0 <= user < user_num):
                return self._send(400, {"error": f"user {user} out of range [0, {user_num})"})
            if not (1 <= k <= item_num):
                return self._send(400, {"error": f"k {k} out of range [1, {item_num}]"})
            # a handler thread is new: it takes the index's device first
            on_dev = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            with on_dev:
                users = torch.tensor([user], dtype=torch.int32, device=dev)
                if recommender is None:
                    ids, scores = recommend(index, users, k, mask_seen, approx=approx)
                else:
                    ids, scores = recommender(users, k, mask_seen)
                ids, scores = ids[0].tolist(), scores[0].tolist()
            return self._send(200, {"user": user, "items": ids, "scores": scores})

    return Handler


def make_server(index: RecIndex, host: str = "127.0.0.1", port: int = 8188,
                warmup_ks: list[int] | None = None, recommender=None,
                approx: bool = False) -> ThreadingHTTPServer:
    """A server over ``index`` on ``(host, port)`` (port 0: any free one),
    after a warmup of ``warmup_ks`` when given (on a mesh every rank warms
    up at once, before rank 0 makes its server); ``serve_forever`` starts
    it. ``recommender``, ``approx``: see :func:`make_handler`."""
    if warmup_ks and recommender is None:
        warmup(index, warmup_ks, approx=approx)
    return ThreadingHTTPServer((host, port), make_handler(index, recommender, approx))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="serve top-k recommendations")
    parser.add_argument("index", help="npz index from --export-index (either package's)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8188)
    parser.add_argument("--device", default=None,
                        help="cuda (the default; needs a card) or cpu")
    parser.add_argument("--approx", action="store_true",
                        help="the JAX package's approx_max_k (recall target 0.95); off the TPU "
                        "that is the exact top-k, which the port serves")
    parser.add_argument("--model-shards", type=int, default=1, metavar="M",
                        help="serve the catalog in M shards over the M ranks of torchrun "
                        "--nproc_per_node M (exact distributed top-k; M must divide the catalog, "
                        "else it is served replicated)")
    parser.add_argument("--warmup", default=None, metavar="K1,K2,...",
                        help="run these k values once (both mask modes) before accepting requests")
    args = parser.parse_args(argv)
    ks = [int(v) for v in args.warmup.split(",")] if args.warmup else None
    if args.model_shards > 1:
        return serve_sharded(args, ks)
    index = load_index(args.index, device=args.device)
    if ks:
        print(f"warming up k={ks} ...", flush=True)
    server = make_server(index, args.host, args.port, ks, approx=args.approx)
    print(f"serving ({index.u_final.shape[0]}, {index.i_final.shape[0]}) index on "
          f"http://{args.host}:{server.server_address[1]} ({index.u_final.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def serve_sharded(args, ks: list[int] | None) -> int:
    """``--model-shards M``: the group of M ranks (from the launcher's
    environment), a ``1xM`` mesh, the index placed on it; rank 0 serves
    HTTP, the others :func:`follow`."""
    import torch.distributed as dist

    from diffmm_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from diffmm_tpu_torch.utils.device import resolve_device

    m = args.model_shards
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != m:
        raise ValueError(f"--model-shards {m} needs {m} ranks (torchrun --nproc_per_node {m}), "
                         f"the launcher started {world}")
    init_distributed("gloo" if args.device == "cpu" else "nccl")
    rank = dist.get_rank()
    mesh = make_mesh(m, model_parallel=m)
    index = load_index(args.index, device=resolve_device(args.device), mesh=mesh)
    if index.item_num is None and rank == 0:
        # recommend() and place_index() keep the replicated call for a
        # catalog the axis does not divide: say so
        print(f"WARNING: catalog {index.i_final.shape[0]} does not divide --model-shards {m}; "
              "serving REPLICATED", flush=True)
    if ks:
        if rank == 0:
            print(f"warming up k={ks} ...", flush=True)
        warmup(index, ks, mesh, approx=args.approx)
    if rank != 0:
        follow(index, mesh, approx=args.approx)
        return 0
    recommender = ShardedRecommender(index, mesh, approx=args.approx)
    server = make_server(index, args.host, args.port, recommender=recommender)
    print(f"serving ({index.u_final.shape[0]}, {_catalog(index)}) index in {m} catalog shards on "
          f"http://{args.host}:{server.server_address[1]} ({index.u_final.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        recommender.stop()
    return 0


if __name__ == "__main__":
    from diffmm_tpu_torch.parallel.mesh import shutdown_distributed

    try:
        code = main()
    finally:
        shutdown_distributed()
    raise SystemExit(code)
