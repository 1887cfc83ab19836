"""Adam's f32 step over a parameter tree in one pass.

Replaces no Pallas kernel: on the TPU, XLA fuses optax's update into the
step's program (``diffmm_tpu/train/optim.py``). Here the step ran as eleven
``torch._foreach_*`` passes (``train/optim.py::_adam_f32``, still the plain
version, and the CPU's); ``csrc/adam.cu`` does the same f32 operations,
rounded alike, in one launch over all of a tree's leaves, and its source note
gives its design and its bound: 28 bytes a parameter (:func:`least_bytes`).

:func:`fused_adam` takes the tree's leaves, their gradients and both
moments, in leaf order, and the step's (3,) row of
``train/optim.py::adam_scalars`` on the card (read there, so a captured graph
replays each step's row). Each launch counts itself (``LAUNCHES["adam"]``)
and its least bytes (``adam.bytes``), which graph replays add back
(``ops/kernels`` ``add_work``).
"""

from __future__ import annotations

import ctypes

import torch

from diffmm_tpu_torch.ops.kernels import Launches, check_launch, count, load_library, sm_count

LAUNCHES = Launches("adam", with_bytes=True)
# leaves one launch takes (kMaxLeaves of csrc/adam.cu: the table fills the
# kernel's 4 KB of parameters); a larger tree takes a launch per 48
MAX_LEAVES = 48


def least_bytes(n: int) -> int:
    """The bytes one step over ``n`` f32 parameters must move: p, g and
    both moments read, p and both moments written, once each."""
    return 28 * n


def _lib():
    lib = load_library("adam")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.adam_step.argtypes = [p, p, p, p, p, i, p, i, p]
        lib.adam_step.restype = i
        lib._typed = True
    return lib


def _check(leaves, grads, mu, nu, scalars: torch.Tensor) -> torch.device:
    if not (len(leaves) == len(grads) == len(mu) == len(nu)) or not leaves:
        raise ValueError(f"fused_adam: {len(leaves)} leaves, {len(grads)} gradients, {len(mu)} and {len(nu)} "
                         "moments; one of each a leaf, at least one")
    dev = leaves[0].device
    if dev.type != "cuda":
        raise ValueError(f"fused_adam: the leaves must be on a CUDA card, got {dev}")
    if (scalars.device != dev or scalars.dtype != torch.float32 or scalars.shape != (3,)
            or not scalars.is_contiguous()):
        raise ValueError(f"fused_adam: the scalars must be a contiguous (3,) f32 row on {dev}, got "
                         f"{scalars.dtype} {tuple(scalars.shape)} on {scalars.device}")
    for k, group in enumerate(zip(leaves, grads, mu, nu)):
        for name, x in zip(("leaf", "gradient", "first moment", "second moment"), group):
            if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
                raise ValueError(f"fused_adam: {name} {k} must be a contiguous f32 tensor on {dev}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}, strides {x.stride()}")
            if x.shape != group[0].shape:
                raise ValueError(f"fused_adam: {name} {k} is {tuple(x.shape)}, its leaf {tuple(group[0].shape)}")
    return dev


@torch.no_grad()
def fused_adam(leaves: list[torch.Tensor], grads: list[torch.Tensor], mu: list[torch.Tensor],
               nu: list[torch.Tensor], scalars: torch.Tensor) -> None:
    """One Adam step in place over f32 ``leaves`` on the card with their
    ``grads`` and moments ``mu``, ``nu`` (all contiguous, one shape a leaf),
    ``scalars`` the (3,) row ``[lr, bc1, bc2]``: bit for bit
    ``train/optim.py::_adam_f32``. Raises on anything else; no fallback."""
    dev = _check(leaves, grads, mu, nu, scalars)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for at in range(0, len(leaves), MAX_LEAVES):
        part = range(at, min(at + MAX_LEAVES, len(leaves)))
        ptrs = [(ctypes.c_void_p * len(part))(*(xs[k].data_ptr() for k in part)) for xs in (leaves, grads, mu, nu)]
        sizes = (ctypes.c_longlong * len(part))(*(leaves[k].numel() for k in part))
        err = lib.adam_step(*ptrs, sizes, len(part), scalars.data_ptr(), sm_count(dev), stream)
        check_launch(err, "adam")
        count("adam", least_bytes(sum(sizes)))
