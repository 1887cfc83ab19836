"""Hand-written Hopper kernels and their build.

Counterpart of ``diffmm_tpu/ops/pallas/``: each TPU kernel there has a CUDA
C++ kernel in ``diffmm_tpu_torch/csrc/`` here, wrapped by a module of this
package with the same name:

* ``spmm_dual``   — K1, both dense propagation directions in one pass over
  the 0/1 adjacency (replaces ``ops/pallas/spmm_dual.py::_dual_kernel``).
* ``denoise_mlp`` — K2 and K3, the single-hidden-layer denoiser forward
  (replaces ``ops/pallas/denoise_mlp.py::_layer1_kernel`` and
  ``_layer2_kernel``).
* ``segsum``      — K4, the sparse graph form's sorted segment sum over CSR
  offsets with the row gather in front of it fused in (``segsum_gather``:
  the rows each edge names, read from L2 inside the kernel; replaces
  ``ops/pallas/segsum.py::_segsum_kernel`` and the ``take`` before it).

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
with a plain C interface, loaded through ``ctypes``, at first use, into
``diffmm_tpu_torch/_build/`` (listed in ``.gitignore``). Each library name
carries a hash of its source, so an edited source never loads a stale build.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all.

The kernels' work counters are one registry here: each wrapper counts its
launches (:func:`count`, its module's ``LAUNCHES`` a view of its own), and
K4's entries also the least bytes of the function each launch computes
(``<kernel>.bytes``). A wrapper counts where its Python code runs, which is
once at a CUDA graph's capture and never at its replay, so ``train/graphs.py``
adds a captured step's counts back at every replay (:func:`add_work`).
The mesh's collectives count there too (:func:`count_allreduce`): each
all-reduce's calls and bytes by the site that asks for it, under
``allreduce.<site>.calls`` and ``allreduce.<site>.bytes``, made at the
first all-reduce, so a process that runs none has no such counter.
:func:`work_counts` reads every counter, :func:`launch_counts` the launches
alone and :func:`add_launches` adds to them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections.abc import MutableMapping

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("spmm_dual", "denoise_mlp", "segsum")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return -(-x // m) * m


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the card's machine")


def _lib_path(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start_build(name: str) -> subprocess.Popen | None:
    src, out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _finish_build(name: str, proc: subprocess.Popen | None) -> str:
    """Wait for a build; returns nvcc's report (empty when already built)."""
    _, out = _lib_path(name)
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = f"{out}.tmp{os.getpid()}"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Build every kernel source at once (one ``nvcc`` each); returns the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    per source."""
    procs = {name: _start_build(name) for name in SOURCES}
    return {name: _finish_build(name, proc) for name, proc in procs.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built here on first use)."""
    lib = _libs.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(_lib_path(name)[1])
        _libs[name] = lib
    return lib


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (looked up once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_launch(err: int, what: str) -> None:
    """Raise when a kernel's C entry returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# kernel name -> launches, "<kernel>.bytes" -> bytes (the kernels that count them)
_WORK: dict[str, int] = {}


class Launches(MutableMapping):
    """A wrapper module's view of its kernels' launch counts in the
    registry (its ``LAUNCHES``), made once when the module is imported;
    ``with_bytes`` also registers each kernel's byte counter."""

    def __init__(self, *names: str, with_bytes: bool = False):
        self._names = names
        for name in names:
            _WORK[name] = 0
            if with_bytes:
                _WORK[f"{name}.bytes"] = 0

    def __getitem__(self, name: str) -> int:
        if name not in self._names:
            raise KeyError(name)
        return _WORK[name]

    def __setitem__(self, name: str, value: int) -> None:
        if name not in self._names:
            raise KeyError(name)
        _WORK[name] = value

    def __delitem__(self, name: str) -> None:
        raise TypeError("a kernel's launch counter cannot be removed")

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __repr__(self) -> str:
        return repr(dict(self))


def count(name: str, n_bytes: int | None = None) -> None:
    """One launch of kernel ``name``, computing a function of ``n_bytes``
    least bytes where the kernel counts them."""
    _WORK[name] += 1
    if n_bytes is not None:
        _WORK[f"{name}.bytes"] += n_bytes


# where an all-reduce comes from (parallel/collectives.py): the gradients'
# sum, a propagation's (K1's and K4's mesh forms, forward and backward), a
# gather of row or column shards, a top-k's merge, anything else
ALLREDUCE_SITES = ("grads", "propagate", "gather", "topk", "other")


def count_allreduce(site: str, n_bytes: int) -> None:
    """One all-reduce of an ``n_bytes`` buffer, asked for at ``site`` (one
    of :data:`ALLREDUCE_SITES`)."""
    if site not in ALLREDUCE_SITES:
        raise ValueError(f"unknown all-reduce site {site!r}; known: {ALLREDUCE_SITES}")
    for key, n in ((f"allreduce.{site}.calls", 1), (f"allreduce.{site}.bytes", n_bytes)):
        _WORK[key] = _WORK.get(key, 0) + n


def _registered() -> dict[str, int]:
    from diffmm_tpu_torch.ops.kernels import denoise_mlp, segsum, spmm_dual  # noqa: F401  (they register)

    return _WORK


def work_counts() -> dict[str, int]:
    """Every work counter so far: each kernel's launches by its name,
    ``<kernel>.bytes`` where it counts bytes, and the all-reduces'
    ``allreduce.<site>.calls`` and ``.bytes`` once there has been one."""
    return dict(_registered())


def add_work(delta: dict[str, int]) -> None:
    """Add ``delta[key]`` to each counter named in it (negative: take back)."""
    work = _registered()
    for key, n in delta.items():
        if key in work:
            work[key] += n


def launch_counts() -> dict[str, int]:
    """Every kernel's launch count so far, by kernel name."""
    return {name: n for name, n in _registered().items() if "." not in name}


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta[name]`` to kernel ``name``'s count (negative: take back)."""
    add_work({name: n for name, n in delta.items() if "." not in name})
