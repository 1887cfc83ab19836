"""K4: a gather-fused sorted segment sum over CSR offsets.

Counterpart of ``diffmm_tpu/ops/pallas/segsum.py`` (``sorted_segment_sum``;
kernel ``_segsum_kernel`` via ``_sorted_segment_sum_impl``) together with the
row gather in front of every call of it in the JAX package
(``sorted_segment_sum(cast(z).take(cols), rows)`` in ``_get_propagator``,
``diffmm_tpu/ops/graph.py:339-392``, its stacked forms, the KNN prototypes
and the ``jnp.take`` VJPs):

    out[s, m·d:(m+1)·d] = sum_{offsets[s] <= e < offsets[s+1]} table_m[src_m[e]]

for M tables (M, R, d), f32 or bf16, one int32 index vector each, f32
sums; an index outside ``[0, R)`` reads as a zero row. :func:`segsum_gather`
is the entry every call site takes. The hand kernel is ``csrc/segsum.cu``;
its source note gives its design (the rows gathered from L2 inside the
kernel, segments spread over warps along a merge path of segments and
edges, hubs cut into 256-edge pieces summed in piece order, no atomics on
values) and its bound. :func:`segsum` is the same kernel on a (nnz, d)
message tensor (row e for edge e): the unfused route, kept as a yardstick;
nothing of the training or serving path calls it, and ``LAUNCHES`` counts
its launches apart (``segsum_unfused``). Each launch also counts the least
bytes of the function it computes (:func:`least_bytes`): they belong to the
function, so any kernel that computes it counts the same.

The kernel and its plain version take the segment boundaries ``offsets``
(n + 1,) in place of the ids, so both read the segments from the same
input: :func:`segment_offsets` makes them once per adjacency build, where the
JAX package hoists its rank machinery (``BiAdj.rank_aux``). Its plans
(``make_segsum_plan``, ``make_ranked_plan``, ``spans_fit``,
``segsum_fits_vmem``) size work to the TPU's VMEM window; this kernel has
no window, so they have no counterpart.

The backward of the sparse form's propagations is K4 too: the three
``torch.autograd.Function``\\ s of ``ops/graph.py`` (after the JAX custom
VJPs ``graph.py:339-520``) reduce the cotangent's rows, named by the
opposite order's source rows, over the other direction's offsets. K4's own
VJP in the JAX package (``_ssum_bwd``, a gather of the cotangent by
``ids``) is the gather half of each of those launches, so it has no
function of its own here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diffmm_tpu_torch.ops.kernels import Launches, check_launch, count, load_library

# Launches of the kernel, counted where it launches: the fused entry
# (segsum_gather) and the unfused one (segsum), apart; each with its bytes.
LAUNCHES = Launches("segsum", "segsum_unfused", with_bytes=True)
# Modalities one launch takes (kMaxModal of csrc/segsum.cu): the shipped
# configurations have at most 3.
MAX_MODAL = 4
# Segment starts and edges together that one segment warp takes (the merge
# path's group of csrc/segsum.cu, at most 256): GROUP, or fewer where that
# would leave fewer than WARPS segment warps (a loss gather's backward:
# 1,024 edges over 9,308 mostly empty segments), at least 4.
GROUP = 64
WARPS = 4096


def merge_group(n: int, nnz: int) -> int:
    """The merge group of a call over n segments and nnz edges."""
    return max(4, min(GROUP, (n + nnz) // WARPS))


def segment_offsets(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1,) int64 CSR offsets of ascending ``ids``: ``offsets[s]`` is the
    first edge whose id is >= s, so segment s spans ``[offsets[s],
    offsets[s + 1])`` and the pads (ids >= n) lie past ``offsets[n]``."""
    bounds = torch.arange(n + 1, dtype=ids.dtype, device=ids.device)
    return torch.searchsorted(ids, bounds)


def least_bytes(M: int, R: int, d: int, elem: int, nnz: int, n: int, indexed: bool = True) -> int:
    """The least bytes one call's function moves, from sizes the host knows
    (a call also runs inside a graph's capture, where no device value may be
    read): the table rows the edges can name, at most one a row and one an
    edge, each read once (``M·min(nnz, R)·d·elem``), the index vectors
    (``4·nnz·M``, where the call has them: not the unfused entry, whose row
    is its edge), the offsets (``8·(n + 1)``) and the f32 output
    (``4·n·M·d``). Where every row is named and no edge is a pad it is
    ``chip_smoke.py``'s bound bytes."""
    return M * min(nnz, R) * d * elem + (4 * nnz * M if indexed else 0) + 8 * (n + 1) + 4 * n * M * d


def segsum_plain(msgs: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch segment sum: each edge's segment from ``offsets``
    (the pads and any edge outside ``[offsets[0], offsets[n])`` go to one
    extra row that is dropped), then ``index_add_`` of the f32 messages
    into (n + 1, d) zeros."""
    n = offsets.shape[0] - 1
    edges = torch.arange(msgs.shape[0], device=msgs.device)
    seg = torch.searchsorted(offsets, edges, right=True) - 1
    seg = torch.where(seg < 0, n, seg)
    out = torch.zeros((n + 1, msgs.shape[1]), dtype=torch.float32, device=msgs.device)
    out.index_add_(0, seg, msgs.to(torch.float32))
    return out[:n]


def _modal(table: torch.Tensor, src) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The (M, R, d) tables and the M index vectors of a call: a (R, d)
    table with one index tensor, or (M, R, d) with a sequence of M."""
    if isinstance(src, torch.Tensor):
        if table.dim() != 2:
            raise ValueError(f"segsum_gather: one index vector takes a (R, d) table, got {tuple(table.shape)}")
        tables, srcs = table[None], [src]
    else:
        srcs = list(src)
        if table.dim() != 3 or table.shape[0] != len(srcs):
            raise ValueError(f"segsum_gather: {len(srcs)} index vectors take a ({len(srcs)}, R, d) table, "
                             f"got {tuple(table.shape)}")
        tables = table
    if not 1 <= len(srcs) <= MAX_MODAL:
        raise ValueError(f"segsum_gather: {len(srcs)} modalities, one launch takes 1 to {MAX_MODAL}")
    if tables.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segsum_gather: the table must be f32 or bf16, got {tables.dtype}")
    nnz = srcs[0].shape[0]
    for s in srcs:
        if s.dim() != 1 or s.dtype != torch.int32 or s.shape[0] != nnz:
            raise TypeError(f"segsum_gather: each index vector must be (nnz,) int32 of one length, got "
                            f"{s.dtype} {tuple(s.shape)}")
    return tables, srcs


def segsum_gather_plain(table: torch.Tensor, src, offsets: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`segsum_gather`: each modality's rows
    gathered with a zero row for an index outside ``[0, R)``
    (``index_select`` on the table with one zero row appended), the M
    gathers side by side, then :func:`segsum_plain`."""
    return _gather_plain(*_modal(table, src), offsets)


def _gather_plain(tables: torch.Tensor, srcs: list[torch.Tensor], offsets: torch.Tensor) -> torch.Tensor:
    R, d = tables.shape[1:]
    msgs = []
    for t, s in zip(tables, srcs):
        idx = torch.where((s >= 0) & (s < R), s, R)
        msgs.append(torch.cat([t, t.new_zeros((1, d))]).index_select(0, idx))
    return segsum_plain(msgs[0] if len(msgs) == 1 else torch.cat(msgs, dim=1), offsets)


def _lib():
    lib = load_library("segsum")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.segsum_scratch.argtypes = [i, ll, i, i, i, p]
        lib.segsum_scratch.restype = None
        lib.segsum_forward.argtypes = [p, i, p, i, i, i, i, p, p, p, p, i, ll, i, p]
        lib.segsum_forward.restype = i
        lib._typed = True
    return lib


@functools.cache
def _workspace(n: int, nnz: int, modal: int, d: int, group: int, device: torch.device) -> tuple:
    """The scratch of a call of this shape on this card, made once (this
    cache keeps it alive): the f32 partials of the segments that cross
    pieces, and int32 words for their tickets (zeroed here and left at zero
    by every launch) and for the call's work plan (written by every
    launch). Calls run on one stream at a time, so one scratch serves them
    all. Returns the two tensors and their data pointers."""
    sizes = (ctypes.c_longlong * 2)()
    _lib().segsum_scratch(n, nnz, modal, d, group, sizes)
    parts = torch.empty(sizes[0], dtype=torch.float32, device=device)
    tickets = torch.zeros(sizes[1], dtype=torch.int32, device=device)
    return parts, tickets, parts.data_ptr(), tickets.data_ptr()


def _vec(d: int, ptr: int, elem: int) -> int:
    """The widest load (in elements, 4, 2 or 1) that the row width and the
    table's address allow."""
    for v in (4, 2):
        if d % v == 0 and ptr % (v * elem) == 0:
            return v
    return 1


def _launch(tables: torch.Tensor, srcs: list[torch.Tensor] | None, offsets: torch.Tensor,
            counter: str) -> torch.Tensor:
    """One launch over the (M, R, d) ``tables``; ``srcs`` None: row = edge."""
    if offsets.dim() != 1 or offsets.shape[0] < 1 or offsets.dtype != torch.int64:
        raise ValueError(f"segsum: offsets must be (n + 1,) int64, got {offsets.dtype} {tuple(offsets.shape)}")
    dev = tables.device
    if offsets.device != dev:
        raise ValueError("segsum: the messages and the offsets must be on one device")
    lib = _lib()
    tables = tables.contiguous()
    offsets = offsets.contiguous()
    M, R, d = tables.shape
    n = offsets.shape[0] - 1
    nnz = R if srcs is None else srcs[0].shape[0]
    if nnz == 0 or n == 0 or d == 0:
        return torch.zeros((n, M * d), dtype=torch.float32, device=dev)
    if R >= 2**31 or nnz >= 2**31:
        raise ValueError(f"segsum: {R} rows and {nnz} edges, the kernel's int32 rows take fewer than 2^31")
    n_bytes = least_bytes(M, R, d, tables.element_size(), nnz, n, indexed=srcs is not None)
    if tables.dtype == torch.bfloat16 and _vec(d, tables.data_ptr(), 2) < 2:
        # the kernel copies 4 bytes or more a lane; f32 holds every bf16 value
        # exactly and the kernel sums in f32, so the sums are the same bits
        tables = tables.float()
    srcs = [None] * M if srcs is None else [s.contiguous() for s in srcs]
    ptrs = (ctypes.c_void_p * M)(*(None if s is None else s.data_ptr() for s in srcs))
    group = merge_group(n, nnz)
    _, _, parts, tickets = _workspace(n, nnz, M, d, group, dev)
    out = torch.empty((n, M * d), dtype=torch.float32, device=dev)
    err = lib.segsum_forward(
        tables.data_ptr(), int(tables.dtype == torch.bfloat16), ptrs, M, R, d,
        _vec(d, tables.data_ptr(), tables.element_size()), offsets.data_ptr(), out.data_ptr(),
        parts, tickets, n, nnz, group, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "segsum")
    count(counter, n_bytes)
    return out


def segsum_gather(table: torch.Tensor, src, offsets: torch.Tensor) -> torch.Tensor:
    """(n, M·d) f32 segment sums of gathered rows over the non-decreasing
    CSR ``offsets`` (n + 1,) int64: ``table`` (R, d) with ``src`` one
    (nnz,) int32 index tensor (M = 1), or (M, R, d) with a sequence of M
    (the modalities side by side in the output, at most ``MAX_MODAL``).
    Segment s sums the rows named by its edges ``[offsets[s], offsets[s +
    1])``, cut to ``[0, nnz)``; an index outside ``[0, R)`` adds a zero
    row. The hand kernel for CUDA tensors, the plain version for CPU
    tensors (only there)."""
    tables, srcs = _modal(table, src)
    if any(x.device != tables.device for x in (*srcs, offsets)):
        raise ValueError("segsum_gather: the table, the indices and the offsets must be on one device")
    if tables.device.type == "cpu":
        return _gather_plain(tables, srcs, offsets)
    if tables.device.type != "cuda":
        raise ValueError(f"segsum_gather: unsupported device {tables.device}")
    return _launch(tables, srcs, offsets, "segsum")


def segsum(msgs: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(n, d) f32 segment sums of ``msgs`` (nnz, d), f32 or bf16, over the
    CSR ``offsets`` (the unfused route: K4 with row e for edge e). The hand
    kernel for CUDA tensors, the plain version for CPU tensors (only
    there)."""
    if msgs.dim() != 2 or msgs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segsum: msgs must be (nnz, d) f32 or bf16, got {msgs.dtype} {tuple(msgs.shape)}")
    if msgs.device.type == "cpu":
        return segsum_plain(msgs, offsets)
    if msgs.device.type != "cuda":
        raise ValueError(f"segsum: unsupported device {msgs.device}")
    return _launch(msgs[None], None, offsets, "segsum_unfused")
