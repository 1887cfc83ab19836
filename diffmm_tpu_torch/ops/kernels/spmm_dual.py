"""K1: dual-direction dense bipartite propagation in one pass over M.

Counterpart of ``diffmm_tpu/ops/pallas/spmm_dual.py`` (``_dual_call``;
kernel ``_dual_kernel``): ``(y_u, y_i) = (M @ z_i, Mᵀ @ z_u)`` for the (U, I)
0/1 block M stored int8 or bf16, with z rounded to bf16 and f32
accumulation. The hand kernel is ``csrc/spmm_dual.cu``; its source note
gives its design (a deterministic two-pass cross-block reduction) and its
bound.

PyTorch has no int8 x bf16 product with f32 output, so the plain version
below materialises an f32 copy of M on every call; the kernel converts each
tile on chip and reads M once for both directions.

This slice ports the forward. The JAX custom VJP is the same call with the
cotangents swapped (``_spmm_dual_bwd``); the training slice wraps this
wrapper in a ``torch.autograd.Function`` the same way.
"""

from __future__ import annotations

import ctypes

import torch

from diffmm_tpu_torch.ops.kernels import check_launch, load_library, round_up, sm_count

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Launches of the kernel, counted by spmm_dual where it launches.
LAUNCHES = {"spmm_dual": 0}

_SUPPORTED_D = (16, 32, 64)


def spmm_dual_plain(mat: torch.Tensor, z_u: torch.Tensor, z_i: torch.Tensor):
    """The plain PyTorch version: ``(M @ bf16(z_i), Mᵀ @ bf16(z_u))`` in f32.

    ``torch.matmul`` on bf16 operands would round its output to bf16, where
    the JAX package keeps f32 (``preferred_element_type``); so the rounded
    operands go back to f32 and multiply there. Products of bf16 values and
    0/1 are exact in f32."""
    m = mat.to(torch.float32)
    zu = z_u.to(torch.bfloat16).to(torch.float32)
    zi = z_i.to(torch.bfloat16).to(torch.float32)
    return m @ zi, m.T @ zu


def _lib():
    lib = load_library("spmm_dual")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spmm_dual_forward.argtypes = [p, i, ctypes.c_longlong] + [p] * 6 + [i] * 8 + [p]
        lib.spmm_dual_forward.restype = i
        lib.spmm_dual_block_items.argtypes = [i]
        lib.spmm_dual_block_items.restype = i
        lib.spmm_dual_tile_rows.argtypes = []
        lib.spmm_dual_tile_rows.restype = i
        lib._typed = True
    return lib


def dense_storage(user_num: int, item_num: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A zeroed (U, I) matrix whose rows start on 16-byte boundaries: a
    view of (U, ld) storage, ld * itemsize a multiple of 16. The kernel
    reads M in 16-byte vectors; the dense adjacency is built this way."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return torch.zeros((user_num, round_up(item_num, per)), dtype=dtype, device=device)[:, :item_num]


def _vector_rows(mat: torch.Tensor) -> torch.Tensor:
    """``mat`` if its rows can be read in 16-byte vectors, else a padded copy."""
    size = mat.element_size()
    if (mat.stride(1) == 1 and (mat.stride(0) * size) % 16 == 0
            and mat.data_ptr() % 16 == 0):
        return mat
    out = dense_storage(mat.shape[0], mat.shape[1], mat.dtype, mat.device)
    out.copy_(mat)
    return out


def _launch(mat: torch.Tensor, z_u: torch.Tensor, z_i: torch.Tensor):
    U, I = mat.shape
    d = z_u.shape[1]
    if mat.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"spmm_dual: M must be int8 or bf16, got {mat.dtype}")
    if d not in _SUPPORTED_D:
        raise ValueError(f"spmm_dual: width {d} not in {_SUPPORTED_D}")
    if z_u.shape != (U, d) or z_i.shape != (I, d):
        raise ValueError(
            f"spmm_dual: shapes M {tuple(mat.shape)}, z_u {tuple(z_u.shape)}, "
            f"z_i {tuple(z_i.shape)} do not match"
        )
    if not (z_u.device == z_i.device == mat.device):
        raise ValueError("spmm_dual: M, z_u and z_i must be on one device")
    lib = _lib()
    mat = _vector_rows(mat)
    zu = z_u.to(torch.bfloat16).contiguous()
    zi = z_i.to(torch.bfloat16).contiguous()
    dev = mat.device
    # grid: C blocks along I (each owns SI columns), R along U, R * C at
    # most one block per SM (one ~206 KB block fills an SM's shared memory)
    si = lib.spmm_dual_block_items(d)
    tu = lib.spmm_dual_tile_rows()
    nc = -(-I // si)
    nr_target = max(1, sm_count(dev) // nc)
    su = round_up(-(-U // nr_target), tu)
    nr = -(-U // su)
    u_pad, i_pad = nr * su, nc * si
    y_u = torch.empty((U, d), dtype=torch.float32, device=dev)
    y_i = torch.empty((I, d), dtype=torch.float32, device=dev)
    p_u = torch.empty((nc, u_pad, d), dtype=torch.float32, device=dev)
    p_i = torch.empty((nr, i_pad, d), dtype=torch.float32, device=dev)
    err = lib.spmm_dual_forward(
        mat.data_ptr(), int(mat.dtype == torch.int8), mat.stride(0), zu.data_ptr(), zi.data_ptr(),
        y_u.data_ptr(), y_i.data_ptr(), p_u.data_ptr(), p_i.data_ptr(),
        U, I, d, su, nr, nc, u_pad, i_pad,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(err, "spmm_dual")
    LAUNCHES["spmm_dual"] += 1
    return y_u, y_i


def spmm_dual(mat: torch.Tensor, z_u: torch.Tensor, z_i: torch.Tensor):
    """``(M @ z_i, Mᵀ @ z_u)`` in one adjacency pass: the hand kernel for
    CUDA tensors, the plain version for CPU tensors (only there)."""
    if mat.device.type == "cpu":
        return spmm_dual_plain(mat, z_u, z_i)
    if mat.device.type != "cuda":
        raise ValueError(f"spmm_dual: unsupported device {mat.device}")
    return _launch(mat, z_u, z_i)
