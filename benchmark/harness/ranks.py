"""The ranks of a multi-card cell: one process a card, started by the
benchmark itself, as ``torchrun --nproc_per_node D·M`` would start them.

A configuration with ``"mesh": "DxM"`` runs as D·M ranks made here from a
spawn context. Rank r gets the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` on a free
port of 127.0.0.1), joins the group through the program's
``parallel/mesh.py::init_distributed`` (NCCL on the cards, card r its own;
gloo for CPU ranks), lays the ranks out with ``make_mesh(world,
model_parallel=M)``, which is what users run, and calls the function it was
given with its :class:`benchmark.run.Run`. Its result comes back pickled by
value over a pipe of its own, never as a handle to shared memory. A rank
writes nothing to standard output (its standard output is its standard
error); the parent prints the one last line.

The deadline: a rank that raises or ends without a result ends the run at
once; every rank has to have joined the group within :data:`JOIN_S`
seconds of the launch (a checkout's first run builds the kernels there),
and to have reported its result within :data:`RUN_S` seconds of the last
join. Past either, or at the first failure, every rank is killed with what
it started, and the launch raises :class:`RankFailure`. A collective that
waits longer than :data:`GROUP_TIMEOUT_S` raises in its rank, and a rank
whose launcher dies is killed with it.

This is the benchmark's own launcher, shaped as the program's
``parallel/launch.py::run_ranks`` is, so that no change to the program can
change how a cell is started.
"""

from __future__ import annotations

import ctypes
import datetime
import importlib
import multiprocessing as mp
import os
import pickle
import signal
import socket
import time
import traceback
from multiprocessing.connection import wait

JOIN_S = 1000.0
RUN_S = 330.0
GROUP_TIMEOUT_S = 600.0


class RankFailure(RuntimeError):
    """A rank raised, ended without its result, or missed the deadline."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """Have the kernel kill this process when its launcher ends (Linux)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _set_group_timeout(seconds: float) -> None:
    """The default timeout of every group this process makes (the world's
    and the mesh's axes), read by ``torch.distributed`` when a group is
    made without one."""
    import torch.distributed.distributed_c10d as c10d

    limit = datetime.timedelta(seconds=seconds)
    c10d.default_pg_timeout = limit
    if hasattr(c10d, "default_pg_nccl_timeout"):
        c10d.default_pg_nccl_timeout = limit


def _send(conn, kind: str, rank: int, payload) -> None:
    conn.send_bytes(pickle.dumps((kind, rank, payload)))


def _rank_main(rank: int, world: int, port: int, backend: str, run, fn: str, args: tuple, conn) -> None:
    _die_with_parent()
    os.setpgid(0, 0)  # its own process group: a kill reaches what it started (nvcc)
    os.dup2(2, 1)  # a rank prints nothing to standard output
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "CUDA_DEVICE_ORDER": "PCI_BUS_ID"})
    import torch
    import torch.distributed as dist

    try:
        from benchmark.run import forbidden_modules
        from diffmm_tpu_torch.parallel.mesh import init_distributed, make_mesh

        if backend == "gloo":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        _set_group_timeout(GROUP_TIMEOUT_S)
        init_distributed(backend)
        run.mesh = make_mesh(world, model_parallel=run.layout[1])
        run.rank = rank
        run.device = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
        _send(conn, "joined", rank, None)
        module, name = fn.rsplit(".", 1)
        value = getattr(importlib.import_module(module), name)(run, *args)
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"JAX or the JAX package was loaded: {found}")
        _send(conn, "result", rank, pickle.dumps(value))
    except BaseException:
        _send(conn, "error", rank, traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def _kill(procs) -> None:
    """Kill every rank still running, with its process group, and reap it."""
    for p in procs:
        if p.is_alive():
            for kill in (lambda: os.killpg(p.pid, signal.SIGKILL), p.kill):
                try:
                    kill()
                except (ProcessLookupError, PermissionError):
                    pass
    for p in procs:
        p.join(timeout=30)


def launch(run, fn: str, *args, join_s: float = JOIN_S, run_s: float = RUN_S) -> list:
    """``fn(run, *args)`` (``fn`` a module-level function's import path) on
    each of ``run.world`` ranks of ``run``'s mesh; each rank's result
    (picklable), in rank order. Raises :class:`RankFailure` when a rank
    raises, ends without its result or misses the deadline; no rank is left
    running when it returns or raises."""
    world = run.world
    backend = "nccl" if run.device.type == "cuda" else "gloo"
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs, readers = [], {}
    results: dict[int, object] = {}
    joined: set[int] = set()
    try:
        for rank in range(world):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, args=(rank, world, port, backend, run, fn, args, send),
                            name=f"bench-rank-{rank}")
            p.start()
            send.close()
            procs.append(p)
            readers[recv] = rank
        deadline, stage = time.monotonic() + join_s, f"joined the group within {join_s:g} s"
        sentinels = {p.sentinel: r for r, p in enumerate(procs)}

        def take(conn) -> None:
            nonlocal deadline, stage
            kind, rank, payload = pickle.loads(conn.recv_bytes())
            if kind == "error":
                raise RankFailure(f"rank {rank} failed:\n{payload}")
            if kind == "joined":
                joined.add(rank)
                if len(joined) == world:
                    deadline, stage = time.monotonic() + run_s, f"reported within {run_s:g} s of joining"
            else:
                results[rank] = pickle.loads(payload)

        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world)) - (set(results) if len(joined) == world else joined))
                raise RankFailure(f"ranks {late} had not {stage}")
            for ready in wait(list(readers) + list(sentinels), timeout=left):
                if ready in readers:
                    try:
                        take(ready)
                    except EOFError:
                        del readers[ready]
                elif ready in sentinels:
                    rank = sentinels.pop(ready)
                    conn = next((c for c, r in readers.items() if r == rank), None)
                    while conn is not None and rank not in results and conn.poll():
                        try:
                            take(conn)
                        except EOFError:
                            break
                    if rank not in results:
                        procs[rank].join(timeout=10)
                        raise RankFailure(f"rank {rank} ended (exit code {procs[rank].exitcode}) "
                                          "without its result")
        for p in procs:
            p.join(timeout=60)
        return [results[r] for r in range(world)]
    finally:
        _kill(procs)
        for conn in readers:
            conn.close()
