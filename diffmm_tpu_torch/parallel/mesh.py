"""The process group and the ``(data, model)`` device mesh.

Counterpart of ``diffmm_tpu/parallel/mesh.py`` (``make_mesh``,
``single_device_mesh``) and of ``jax.distributed.initialize`` in
``diffmm_tpu/cli.py:78-96``. The JAX package is one controller over every
device; the port runs one process per card with ``torch.distributed``, and
its mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank
with the dims ``("data", "model")``:

* ``data``: batch rows (diffusion and rebuild user blocks, eval user
  blocks; interaction blocks and the train edges over both axes) are split
  over it; the narrow parameters and their Adam moments are replicated, and
  the gradients are summed once a step (``parallel/sharding.py::
  reduce_grads``).
* ``model``: the catalog. Serving and the ranking eval score one catalog
  shard a rank (``eval/ranking.py``, ``eval/serving.py``), and training
  splits the catalog-wide parameters, their Adam moments and the dense
  blocks over it (``parallel/sharding.py``).

The backend is NCCL on the card. Gloo is used only where the caller names
it: the CPU ranks of the tests and of ``--device cpu``, and two ranks that
share one card in ``chip_smoke.py``. A group that fails to start raises;
nothing moves to another backend or to the CPU.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (for a group started here)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(backend: str | None = None) -> None:
    """Start this process's default group, once.

    Under a launcher (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) the group comes
    from that environment; without one it is a group of one rank on a free
    port of 127.0.0.1 (``--mesh 1x1`` in one process). ``backend`` is
    ``"nccl"`` when None: it needs a card, and this process's card is
    ``cuda:LOCAL_RANK``, selected before the group starts. ``"gloo"`` only
    when named. On the card, rank 0 builds the kernels and every rank
    waits for it before any loads them (:func:`build_kernels_once`)."""
    backend = backend or "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, asked for {backend}")
        return
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA card; name backend='gloo' for CPU ranks")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card of its own ({torch.cuda.device_count()} visible): "
                "under nccl each rank needs one card"
            )
        torch.cuda.set_device(local)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
    if torch.cuda.is_available():
        build_kernels_once()


def shutdown_distributed() -> None:
    """Leave the default group if this process is in one (the entry
    points' last step)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def build_kernels_once() -> None:
    """Rank 0 builds every kernel source (``ops/kernels.build_all``); a
    barrier follows, after which every rank loads the built libraries, so
    no two ranks run ``nvcc`` into one directory at once."""
    from diffmm_tpu_torch.ops.kernels import build_all

    if dist.get_rank() == 0:
        build_all()
    dist.barrier()


def make_mesh(n_devices: int | None = None, model_parallel: int = 1):
    """A ``(data, model)`` DeviceMesh over the ranks of the default group,
    ``model_parallel`` ranks on the model axis. ``n_devices`` (default:
    the world size) must be the world size: every rank takes part. The
    errors of the JAX ``make_mesh`` for too many devices and a model axis
    that does not divide them."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed() first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    refusal = mesh_refusal(n, world, model_parallel)
    if refusal:
        raise ValueError(refusal)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_refusal(n_devices: int, world: int, model_parallel: int) -> str | None:
    """Why :func:`make_mesh` refuses ``n_devices`` of a world of ``world``
    ranks with ``model_parallel`` on the model axis, or None where it
    builds the mesh (a launcher asks before it starts any rank)."""
    if n_devices > world:
        return f"requested {n_devices} devices, only {world} available"
    if n_devices < world:
        return f"the mesh spans every rank: requested {n_devices} devices of a world of {world}"
    if model_parallel < 1 or n_devices % model_parallel:
        return f"model_parallel={model_parallel} must divide {n_devices} devices"
    return None


def single_device_mesh():
    """The 1x1 mesh: the mesh code path on one rank."""
    return make_mesh(1, model_parallel=1)


def axis_size(mesh, axis: str) -> int:
    """Ranks on ``axis`` of ``mesh``."""
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return int(mesh.get_local_rank(axis))
