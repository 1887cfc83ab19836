"""Minimal HTTP serving front end over an exported recommendation index.

    python -m diffmm_tpu_torch.eval.serve_http index.npz --port 8188 [--warmup 10,20]
    python -m diffmm_tpu_torch.eval.serve_http index.npz --device cpu

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
ahead. ``--approx`` refuses: the port has no approximate top-k (ROADMAP.md
A5); ``--model-shards`` above 1 refuses until the multi-device slice
(ROADMAP.md A7).
"""

from __future__ import annotations

import argparse
import contextlib
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from diffmm_tpu_torch.eval.serving import RecIndex, load_index, recommend, warmup


def make_handler(index: RecIndex):
    """The request handler class over ``index``."""
    user_num = int(index.u_final.shape[0])
    item_num = int(index.i_final.shape[0])
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
                ids, scores = recommend(index, torch.tensor([user], dtype=torch.int32, device=dev),
                                        k, mask_seen)
                ids, scores = ids[0].tolist(), scores[0].tolist()
            return self._send(200, {"user": user, "items": ids, "scores": scores})

    return Handler


def make_server(index: RecIndex, host: str = "127.0.0.1", port: int = 8188,
                warmup_ks: list[int] | None = None) -> ThreadingHTTPServer:
    """A server over ``index`` on ``(host, port)`` (port 0: any free one),
    after a warmup of ``warmup_ks`` when given; ``serve_forever`` starts it."""
    if warmup_ks:
        warmup(index, warmup_ks)
    return ThreadingHTTPServer((host, port), make_handler(index))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="serve top-k recommendations")
    parser.add_argument("index", help="npz index from --export-index (either package's)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8188)
    parser.add_argument("--device", default=None,
                        help="cuda (the default; needs a card) or cpu")
    parser.add_argument("--approx", action="store_true",
                        help="not ported: the port has no approximate top-k (ROADMAP.md A5)")
    parser.add_argument("--model-shards", type=int, default=1, metavar="M",
                        help="not ported above 1 (ROADMAP.md A7)")
    parser.add_argument("--warmup", default=None, metavar="K1,K2,...",
                        help="run these k values once (both mask modes) before accepting requests")
    args = parser.parse_args(argv)
    if args.approx:
        raise NotImplementedError("--approx: the port has no approximate top-k (ROADMAP.md A5)")
    if args.model_shards > 1:
        raise NotImplementedError("--model-shards > 1 is not ported yet (ROADMAP.md A7: multi-device)")
    index = load_index(args.index, device=args.device)
    ks = [int(v) for v in args.warmup.split(",")] if args.warmup else None
    if ks:
        print(f"warming up k={ks} ...", flush=True)
    server = make_server(index, args.host, args.port, ks)
    print(f"serving ({index.u_final.shape[0]}, {index.i_final.shape[0]}) index on "
          f"http://{args.host}:{server.server_address[1]} ({index.u_final.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
