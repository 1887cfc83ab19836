"""Ranks on one machine without a launcher: :func:`run_ranks` spawns the
processes of one group, as ``torchrun --nproc_per_node N`` would.

The CPU tests run the mesh on gloo ranks made here, and ``chip_smoke.py``
runs its mesh phases in them so that no process group outlives a phase in
its own process. Each rank gets the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` on a free
port of 127.0.0.1), joins the group (``init_distributed``), runs the
function and leaves the group. A rank that raises fails the call with its
traceback.
"""

from __future__ import annotations

import os
import pickle
import queue
import time
import traceback

import torch.multiprocessing as mp

from diffmm_tpu_torch.parallel.mesh import free_port


def _rank_main(rank: int, world: int, port: int, backend: str, fn, args, results) -> None:
    import torch.distributed as dist

    from diffmm_tpu_torch.parallel.mesh import init_distributed

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    try:
        init_distributed(backend)
        # pickled by value here: a tensor would otherwise travel as a handle
        # to this process's shared memory, which ends with the process
        results.put((rank, True, pickle.dumps(fn(*args))))
    except Exception:  # the rank's traceback goes to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), backend: str = "gloo", timeout: float = 600.0) -> list:
    """``fn(*args)`` on ``world`` spawned ranks of one ``backend`` group;
    returns each rank's result (picklable) in rank order. ``fn`` must be
    importable by name (a module-level function). Raises if a rank fails,
    or does not report within ``timeout`` seconds; every process is ended
    before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, backend, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    errors = []
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world and not errors:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that died before it could report (it failed to start)
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} ended without a result (exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                elif time.monotonic() > deadline:
                    errors.append(f"ranks {sorted(set(range(world)) - set(out))} did not report in {timeout} s")
                continue
            if ok:
                out[rank] = pickle.loads(value)
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("run_ranks: " + "\n".join(errors))
    return [out[r] for r in range(world)]
