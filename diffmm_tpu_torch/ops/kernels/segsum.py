"""K4: sorted segment sum over CSR offsets.

Counterpart of ``diffmm_tpu/ops/pallas/segsum.py`` (``sorted_segment_sum``;
kernel ``_segsum_kernel`` via ``_sorted_segment_sum_impl``):
``out[s] = sum_{e: ids[e] = s} msgs[e]`` for ascending ``ids``, f32 or bf16
messages, f32 accumulation, pad edges ``ids[e] == n`` ignored. The hand
kernel is ``csrc/segsum.cu``; its source note gives its design (one warp a
segment of at most 256 edges; a longer one cut into pieces of 256 edges,
one warp a piece, the pieces' sums added in piece order; no atomics on
values) and its bound.

The kernel and its plain version take the segment boundaries ``offsets``
(n + 1,) in place of the ids, so both read the segments from the same
input: :func:`segment_offsets` makes them once per adjacency build, where the
JAX package hoists its rank machinery (``BiAdj.rank_aux``). Its plans
(``make_segsum_plan``, ``make_ranked_plan``, ``spans_fit``,
``segsum_fits_vmem``) size work to the TPU's VMEM window; this kernel has
no window, so they have no counterpart.

The backward of the sparse form's propagations is K4 too: the three
``torch.autograd.Function``\\ s of ``ops/graph.py`` (after the JAX custom
VJPs ``graph.py:339-520``) gather the cotangent by the opposite order's
source rows and launch this kernel over the other direction's offsets.
K4's own VJP in the JAX package (``_ssum_bwd``, a gather of the cotangent
by ``ids``) is the first half of each of those backwards, so it has no
function of its own here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diffmm_tpu_torch.ops.kernels import check_launch, load_library

# Launches of the kernel, counted by segsum where it launches.
LAUNCHES = {"segsum": 0}


def segment_offsets(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1,) int64 CSR offsets of ascending ``ids``: ``offsets[s]`` is the
    first edge whose id is >= s, so segment s spans ``[offsets[s],
    offsets[s + 1])`` and the pads (ids >= n) lie past ``offsets[n]``."""
    bounds = torch.arange(n + 1, dtype=ids.dtype, device=ids.device)
    return torch.searchsorted(ids, bounds)


def segsum_plain(msgs: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: each edge's segment from ``offsets`` (the
    pads and any edge outside ``[offsets[0], offsets[n])`` go to one extra
    row that is dropped), then ``index_add_`` of the f32 messages into
    (n + 1, d) zeros."""
    n = offsets.shape[0] - 1
    edges = torch.arange(msgs.shape[0], device=msgs.device)
    seg = torch.searchsorted(offsets, edges, right=True) - 1
    seg = torch.where(seg < 0, n, seg)
    out = torch.zeros((n + 1, msgs.shape[1]), dtype=torch.float32, device=msgs.device)
    out.index_add_(0, seg, msgs.to(torch.float32))
    return out[:n]


def _lib():
    lib = load_library("segsum")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segsum_scratch.argtypes = [i, ctypes.c_longlong, i, p]
        lib.segsum_scratch.restype = None
        lib.segsum_forward.argtypes = [p, i, p, p, p, p, i, ctypes.c_longlong, i, p]
        lib.segsum_forward.restype = i
        lib._typed = True
    return lib


@functools.cache
def _workspace(n: int, nnz: int, d: int, device: torch.device) -> tuple:
    """The scratch of a call of this shape on this card, made once (this
    cache keeps it alive): the f32 partials of the segments that cross
    pieces and their int32 tickets, zeroed here and left at zero by every
    launch. Calls run on one stream at a time, so one scratch serves them
    all. Returns the two tensors and their data pointers."""
    sizes = (ctypes.c_longlong * 2)()
    _lib().segsum_scratch(n, nnz, d, sizes)
    parts = torch.empty(sizes[0], dtype=torch.float32, device=device)
    tickets = torch.zeros(sizes[1], dtype=torch.int32, device=device)
    return parts, tickets, parts.data_ptr(), tickets.data_ptr()


def _launch(msgs: torch.Tensor, offsets: torch.Tensor):
    if msgs.dim() != 2 or msgs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segsum: msgs must be (nnz, d) f32 or bf16, got {msgs.dtype} {tuple(msgs.shape)}")
    if offsets.dim() != 1 or offsets.shape[0] < 1 or offsets.dtype != torch.int64:
        raise ValueError(f"segsum: offsets must be (n + 1,) int64, got {offsets.dtype} {tuple(offsets.shape)}")
    if msgs.device != offsets.device:
        raise ValueError("segsum: msgs and offsets must be on one device")
    lib = _lib()
    msgs = msgs.contiguous()
    offsets = offsets.contiguous()
    (nnz, d), n = msgs.shape, offsets.shape[0] - 1
    dev = msgs.device
    if nnz == 0 or n == 0 or d == 0:
        return torch.zeros((n, d), dtype=torch.float32, device=dev)
    _, _, parts, tickets = _workspace(n, nnz, d, dev)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    err = lib.segsum_forward(
        msgs.data_ptr(), int(msgs.dtype == torch.bfloat16), offsets.data_ptr(), out.data_ptr(),
        parts, tickets, n, nnz, d, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "segsum")
    LAUNCHES["segsum"] += 1
    return out


def segsum(msgs: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(n, d) f32 segment sums of ``msgs`` (nnz, d) over the non-decreasing
    CSR ``offsets`` (n + 1,) int64, e.g. ``segment_offsets(ids, n)``: the
    hand kernel for CUDA tensors, the plain version for CPU tensors (only
    there). Both read the edges ``[offsets[s], offsets[s + 1])`` of segment
    s, cut to ``[0, nnz)``."""
    if msgs.device.type == "cpu":
        return segsum_plain(msgs, offsets)
    if msgs.device.type != "cuda":
        raise ValueError(f"segsum: unsupported device {msgs.device}")
    return _launch(msgs, offsets)
