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

Each wrapper counts its launches in its module's ``LAUNCHES``;
:func:`launch_counts` reads them all and :func:`add_launches` adds to them
(a captured CUDA graph's launches, ``train/graphs.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

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


def _counters() -> tuple[dict[str, int], ...]:
    from diffmm_tpu_torch.ops.kernels import denoise_mlp, segsum, spmm_dual

    return spmm_dual.LAUNCHES, denoise_mlp.LAUNCHES, segsum.LAUNCHES


def launch_counts() -> dict[str, int]:
    """Every kernel's launch count so far, by kernel name."""
    return {name: n for counts in _counters() for name, n in counts.items()}


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta[name]`` to kernel ``name``'s count (negative: take back)."""
    for counts in _counters():
        for name in counts:
            counts[name] += delta.get(name, 0)
