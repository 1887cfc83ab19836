"""K1: dual-direction dense bipartite propagation in one pass over M.

Counterpart of ``diffmm_tpu/ops/pallas/spmm_dual.py`` (``_dual_call``;
kernel ``_dual_kernel``): ``(y_u, y_i) = (M @ z_i, Mᵀ @ z_u)`` for the (U, I)
0/1 block M stored int8, bf16 or packed int4, with z rounded to bf16 and f32
accumulation. The hand kernel is ``csrc/spmm_dual.cu``: one launch, M fed
to ``wgmma`` by TMA, z rounded to bf16 on chip, the cross-block sums in
distributed shared memory and in L2, in a fixed order; its source note gives
the design and its bound.

Packed int4 (``train.dense_store="int4"``): torch has no 4-bit type, so M is
a uint8 tensor of (U, ceil(I / 2)) bytes, two cells a byte: cell (u, 2j) in
the low nibble of byte j and cell (u, 2j + 1) in its high nibble, each a
signed 4-bit integer (JAX ``int4``); an odd I's last high nibble is zero. A
uint8 M means this packing everywhere in the port (:func:`pack_int4`,
:func:`unpack_int4`), and the catalog width I comes from z_i.

PyTorch has no int8 x bf16 product with f32 output, so the plain version
below materialises an f32 copy of M on every call; the kernel converts each
tile on chip and reads M once for both directions.

:class:`SpmmDual` is the JAX custom VJP (``_spmm_dual_fwd``/``_bwd``,
``spmm_dual.py:108-133``) as a ``torch.autograd.Function``: its backward is
the same wrapper with the cotangents in place of z, ``(dz_u, dz_i) = (M @
g_i, Mᵀ @ g_u)``, so on the card both passes launch this kernel (the
cotangents rounded to bf16 on chip, f32 out) and on the CPU both run the
plain version. M gets no gradient.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from diffmm_tpu_torch.ops.kernels import Launches, check_launch, count, load_library, round_up, sm_count

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Launches of the kernel, counted by spmm_dual where it launches.
LAUNCHES = Launches("spmm_dual")

_SUPPORTED_D = (16, 32, 64)

# M's storage types by name (``train.dense_store``) and the C entry's code of each
STORES = {torch.int8: "int8", torch.bfloat16: "bf16", torch.uint8: "int4"}
_KIND_CODE = {"bf16": 0, "int8": 1, "int4": 2}


def store_kind(dtype: torch.dtype) -> str:
    """``"int8"``, ``"bf16"`` or ``"int4"`` (a uint8 M is packed int4)."""
    if dtype not in STORES:
        raise TypeError(f"spmm_dual: M must be int8, bf16 or uint8 (packed int4), got {dtype}")
    return STORES[dtype]


def pack_int4(dense: torch.Tensor) -> torch.Tensor:
    """A (U, I) matrix of values in [-8, 8) as packed int4: (U, ceil(I / 2))
    uint8, cell 2j in the low nibble of byte j, an odd I's last high nibble
    zero."""
    u, i = dense.shape
    cells = torch.zeros((u, i + i % 2), dtype=torch.uint8, device=dense.device)
    cells[:, :i] = dense.to(torch.int8).view(torch.uint8) & 0xF
    return cells[:, 0::2] | (cells[:, 1::2] << 4)


def unpack_int4(mat: torch.Tensor, item_num: int) -> torch.Tensor:
    """The (U, item_num) int8 cells of a packed int4 ``mat`` (sign-extended)."""
    nib = torch.stack([mat & 0xF, mat >> 4], dim=-1).view(mat.shape[0], -1)[:, :item_num]
    return ((nib.to(torch.int16) ^ 8) - 8).to(torch.int8)


def spmm_dual_plain(mat: torch.Tensor, z_u: torch.Tensor, z_i: torch.Tensor):
    """The plain PyTorch version: ``(M @ bf16(z_i), Mᵀ @ bf16(z_u))`` in f32.

    ``torch.matmul`` on bf16 operands would round its output to bf16, where
    the JAX package keeps f32 (``preferred_element_type``); so the rounded
    operands go back to f32 and multiply there. Products of bf16 values and
    0/1 are exact in f32. A packed int4 M is unpacked first."""
    if mat.dtype == torch.uint8:
        mat = unpack_int4(mat, z_i.shape[0])
    m = mat.to(torch.float32)
    zu = z_u.to(torch.bfloat16).to(torch.float32)
    zi = z_i.to(torch.bfloat16).to(torch.float32)
    return m @ zi, m.T @ zu


def _lib():
    lib = load_library("spmm_dual")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spmm_dual_plan.argtypes = [i, i, i, i, i, p]
        lib.spmm_dual_plan.restype = i
        lib.spmm_dual_max_items.argtypes = [i, i, i]
        lib.spmm_dual_max_items.restype = i
        lib.spmm_dual_forward.argtypes = [p, i, ctypes.c_longlong] + [p] * 7 + [i] * 3 + [p, p]
        lib.spmm_dual_forward.restype = i
        lib._typed = True
    return lib


@dataclass(frozen=True)
class Plan:
    """The kernel's launch plan for one (U, I, D, storage) on one card (see
    ``csrc/spmm_dual.cu``): ``cluster`` blocks a cluster along I,
    ``col_blocks`` (a multiple of it) by ``row_blocks`` blocks, each column
    block ``items`` I columns and each row block ``rows`` U rows, ``groups``
    clusters along I and ``strips`` 128-row strips of U. ``raw`` is the C
    array the kernel takes."""

    cluster: int
    col_blocks: int
    row_blocks: int
    rows: int
    groups: int
    strips: int
    items: int
    raw: ctypes.Array

    def partial_bytes(self, user_num: int, item_num: int, d: int) -> int:
        """f32 scratch of the cross-block sums: Pu (groups, U, D) when
        groups > 1 and Pi (row_blocks, I, D) when row_blocks > 1."""
        pu = self.groups * user_num if self.groups > 1 else 0
        pi = self.row_blocks * item_num if self.row_blocks > 1 else 0
        return (pu + pi) * d * 4


@functools.cache
def plan(user_num: int, item_num: int, d: int, kind: str, device: torch.device) -> Plan:
    """The launch plan for M stored as ``kind`` (int8, bf16 or int4; looked
    up once per shape, storage and card). Raises where I is too wide for the
    grid to be one wave."""
    raw = (ctypes.c_int * 7)()
    check_launch(_lib().spmm_dual_plan(user_num, item_num, d, _KIND_CODE[kind], sm_count(device), raw),
                 "spmm_dual plan")
    return Plan(*raw[:7], raw=raw)


# The kernel's grid barrier: two int32 words a card, zeroed once (the kernel
# leaves the arrival count at zero). Calls run on one stream at a time.
_BARRIER: dict[torch.device, torch.Tensor] = {}


def _barrier(device: torch.device) -> torch.Tensor:
    if device not in _BARRIER:
        _BARRIER[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return _BARRIER[device]


def dense_storage(user_num: int, item_num: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A zeroed (U, I) matrix whose rows start on 16-byte boundaries: a
    view of (U + 1, ld) storage, ld's bytes a multiple of 16. For a uint8
    ``dtype`` (packed int4) the view is (U, ceil(I / 2)) bytes of rows of
    round_up(I, 32) / 2 bytes. The kernel's tensor map reads M in rows of
    that stride; the dense adjacency is built this way, and its build writes
    its pad edges into the spare row past the U rows
    (``ops/graph.py::build_dense_bi_adj_device``), which nothing reads."""
    if dtype == torch.uint8:
        store = torch.zeros((user_num + 1, round_up(item_num, 32) // 2), dtype=dtype, device=device)
        return store[:user_num, :(item_num + 1) // 2]
    per = 16 // torch.empty((), dtype=dtype).element_size()
    store = torch.zeros((user_num + 1, round_up(item_num, per)), dtype=dtype, device=device)
    return store[:user_num, :item_num]


def _vector_rows(mat: torch.Tensor, item_num: int) -> torch.Tensor:
    """``mat`` if its rows can be read by the tensor map, else a padded copy."""
    size = mat.element_size()
    if (mat.stride(1) == 1 and (mat.stride(0) * size) % 16 == 0
            and mat.data_ptr() % 16 == 0):
        return mat
    out = dense_storage(mat.shape[0], item_num, mat.dtype, mat.device)
    out.copy_(mat)
    return out


def _f32_rows(z: torch.Tensor) -> torch.Tensor:
    """z as contiguous, 16-byte-aligned f32 (no copy for the main path's z;
    the kernel rounds it to bf16 itself)."""
    z = z.to(torch.float32).contiguous()
    return z if z.data_ptr() % 16 == 0 else z.clone()


@functools.cache
def max_items(d: int, kind: str, device: torch.device) -> int:
    """The widest I one launch takes for M stored as ``kind``: its grid must
    be one wave of blocks."""
    n = _lib().spmm_dual_max_items(d, _KIND_CODE[kind], sm_count(device))
    if n <= 0:
        raise RuntimeError("spmm_dual: no launch plan fits this card")
    return n


def _launch_one(mat, zu, zi, y_i) -> torch.Tensor:
    """One launch over the columns of zi (M's bytes of them): writes y_i
    (the columns' rows), returns y_u over those columns."""
    U, (I, d) = mat.shape[0], zi.shape
    dev = mat.device
    kind = store_kind(mat.dtype)
    p = plan(U, I, d, kind, dev)
    y_u = torch.empty((U, d), dtype=torch.float32, device=dev)
    p_u = torch.empty((p.groups, U, d) if p.groups > 1 else (0,), dtype=torch.float32, device=dev)
    p_i = torch.empty((p.row_blocks, I, d) if p.row_blocks > 1 else (0,), dtype=torch.float32,
                      device=dev)
    err = _lib().spmm_dual_forward(
        mat.data_ptr(), _KIND_CODE[kind], mat.stride(0), zu.data_ptr(), zi.data_ptr(),
        y_u.data_ptr(), y_i.data_ptr(), p_u.data_ptr(), p_i.data_ptr(), _barrier(dev).data_ptr(),
        U, I, d, p.raw, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "spmm_dual")
    count("spmm_dual")
    return y_u


def _launch(mat: torch.Tensor, z_u: torch.Tensor, z_i: torch.Tensor):
    U = mat.shape[0]
    I, d = z_i.shape
    kind = store_kind(mat.dtype)
    per_byte = 2 if kind == "int4" else 1  # cells a storage element holds
    if d not in _SUPPORTED_D:
        raise ValueError(f"spmm_dual: width {d} not in {_SUPPORTED_D}")
    if z_u.shape != (U, d) or mat.shape[1] != -(-I // per_byte):
        raise ValueError(
            f"spmm_dual: shapes M {tuple(mat.shape)} ({kind}), z_u {tuple(z_u.shape)}, "
            f"z_i {tuple(z_i.shape)} do not match"
        )
    if not (z_u.device == z_i.device == mat.device):
        raise ValueError("spmm_dual: M, z_u and z_i must be on one device")
    dev = mat.device
    if U == 0 or I == 0:
        return (torch.zeros((U, d), dtype=torch.float32, device=dev),
                torch.zeros((I, d), dtype=torch.float32, device=dev))
    mat = _vector_rows(mat, I)
    zu, zi = _f32_rows(z_u), _f32_rows(z_i)
    y_i = torch.empty((I, d), dtype=torch.float32, device=dev)
    # a catalog wider than one wave of blocks goes in column chunks (each a
    # multiple of a block's columns, so every chunk starts 16-byte aligned,
    # and on a byte of packed int4); their y_u add up in chunk order
    width = max_items(d, kind, dev)
    y_u = None
    for a in range(0, I, width):
        b = min(a + width, I)
        part = _launch_one(mat[:, a // per_byte:-(-b // per_byte)], zu, zi[a:b], y_i[a:b])
        y_u = part if y_u is None else y_u.add_(part)
    return y_u, y_i


def spmm_dual(mat: torch.Tensor, z_u: torch.Tensor, z_i: torch.Tensor):
    """``(M @ z_i, Mᵀ @ z_u)`` in one adjacency pass: the hand kernel for
    CUDA tensors, the plain version for CPU tensors (only there). M is
    int8, bf16 or packed int4 (uint8, :func:`pack_int4`)."""
    if mat.device.type == "cpu":
        return spmm_dual_plain(mat, z_u, z_i)
    if mat.device.type != "cuda":
        raise ValueError(f"spmm_dual: unsupported device {mat.device}")
    return _launch(mat, z_u, z_i)


class SpmmDual(torch.autograd.Function):
    """:func:`spmm_dual` with its backward: ``SpmmDual.apply(mat, z_u, z_i)``
    -> ``(M @ z_i, Mᵀ @ z_u)``; the cotangents ``(g_u, g_i)`` of the two
    outputs go through the same call, ``spmm_dual(mat, g_u, g_i) = (M @ g_i,
    Mᵀ @ g_u) = (dz_u, dz_i)``. An unused output's cotangent arrives as
    zeros, and a non-contiguous one is made contiguous by the wrapper."""

    @staticmethod
    def forward(ctx, mat, z_u, z_i):
        ctx.save_for_backward(mat)
        return spmm_dual(mat, z_u, z_i)

    @staticmethod
    def backward(ctx, g_u, g_i):
        (mat,) = ctx.saved_tensors
        dz_u, dz_i = spmm_dual(mat, g_u, g_i)
        return None, dz_u, dz_i
