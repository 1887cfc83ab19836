"""K2 and K3: the single-hidden-layer denoiser forward.

Counterpart of ``diffmm_tpu/ops/pallas/denoise_mlp.py``
(``fused_denoise_mlp``; kernels ``_layer1_kernel`` and ``_layer2_kernel``):

    K2: h   = tanh(x @ W1x + temb_proj)      (b1 folded into temb_proj)
    K3: out = h @ W2 + b2

in full f32. The hand kernels are ``csrc/denoise_mlp.cu``; its source note
gives their design and bound. :func:`denoise_forward_fused` is the
counterpart of ``denoise_forward_pallas``: the rebuild's reverse loop calls
it for every step and block.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diffmm_tpu_torch.models.denoise import timestep_embedding
from diffmm_tpu_torch.ops.kernels import check_launch, load_library, sm_count

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"denoise_layer1": 0, "denoise_layer2": 0}


def layer1_plain(x: torch.Tensor, w1x: torch.Tensor, temb_proj: torch.Tensor) -> torch.Tensor:
    """Plain K2: ``tanh(x @ w1x + temb_proj)``."""
    return torch.tanh(x @ w1x + temb_proj)


def layer2_plain(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain K3: ``h @ w2 + b2``."""
    return h @ w2 + b2


def _lib():
    lib = load_library("denoise_mlp")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.denoise_layer1, lib.denoise_layer2):
            fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
            fn.restype = i
        lib.denoise_splits.argtypes = [i, i, i, i]
        lib.denoise_splits.restype = i
        lib._typed = True
    return lib


@functools.cache
def _splits(m: int, n: int, k: int, device: torch.device) -> int:
    """The kernel's split-K count for an (M, K) x (K, N) product on this
    card (one ctypes call per shape)."""
    return _lib().denoise_splits(m, n, k, sm_count(device))


def _on_cuda(what: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one
    (the kernel runs); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def _check(what: str, name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: {name} must be f32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want {shape}")
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
    return t.contiguous()


def _launch(what: str, a: torch.Tensor, b: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``epilogue(a (M, K) @ b (K, N), e)`` by kernel ``what``, with the
    split-K scratch the kernel asks for."""
    lib = _lib()
    (m, k), n, dev = a.shape, b.shape[1], a.device
    splits = _splits(m, n, k, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((splits, m, n) if splits > 1 else (0,), dtype=torch.float32, device=dev)
    check_launch(
        getattr(lib, what)(
            a.data_ptr(), b.data_ptr(), e.data_ptr(), out.data_ptr(), part.data_ptr(),
            m, k, n, splits, torch.cuda.current_stream(dev).cuda_stream,
        ),
        what,
    )
    LAUNCHES[what] += 1
    return out


def denoise_layer1(x: torch.Tensor, w1x: torch.Tensor, temb_proj: torch.Tensor) -> torch.Tensor:
    """K2, ``tanh(x @ w1x + temb_proj)``: the hand kernel for CUDA tensors,
    the plain version for CPU tensors (only there). x (B, K), w1x (K, H),
    temb_proj (B, H) with b1 folded in, all f32."""
    if not _on_cuda("denoise_layer1", x):
        return layer1_plain(x, w1x, temb_proj)
    (B, K), H, dev = x.shape, w1x.shape[1], x.device
    return _launch(
        "denoise_layer1",
        _check("denoise_layer1", "x", x, (B, K), dev),
        _check("denoise_layer1", "w1x", w1x, (K, H), dev),
        _check("denoise_layer1", "temb_proj", temb_proj, (B, H), dev),
    )


def denoise_layer2(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K3, ``h @ w2 + b2``: the hand kernel for CUDA tensors, the plain
    version for CPU tensors (only there). h (B, H), w2 (H, N), b2 (N,), all
    f32."""
    if not _on_cuda("denoise_layer2", h):
        return layer2_plain(h, w2, b2)
    (B, H), N, dev = h.shape, w2.shape[1], h.device
    return _launch(
        "denoise_layer2",
        _check("denoise_layer2", "h", h, (B, H), dev),
        _check("denoise_layer2", "w2", w2, (H, N), dev),
        _check("denoise_layer2", "b2", b2, (N,), dev),
    )


def fused_denoise_mlp(x, w1x, temb_proj, w2, b2) -> torch.Tensor:
    """``tanh(x @ w1x + temb_proj) @ w2 + b2`` through K2 then K3 (the plain
    versions for CPU tensors)."""
    return denoise_layer2(denoise_layer1(x, w1x, temb_proj), w2, b2)


def denoise_forward_fused(params, x_t: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """The denoiser forward without modality conditioning, through K2/K3.

    Counterpart of ``denoise_forward_pallas`` with ``modal_feat=None``, the
    only form the rebuild reaches (``p_mean`` passes no modality features).
    The time embedding's projection ``t @ W1[I:] + b1`` is a (B, d_emb) x
    (d_emb, H) product computed here, outside the kernels."""
    if len(params["in_layers"]) != 1 or len(params["out_layers"]) != 1:
        raise NotImplementedError(
            "the denoise_mlp kernels take a single hidden layer "
            "(ROADMAP.md A, slice 3: training)"
        )
    emb = timestep_embedding(timesteps, params["emb"]["w"].shape[0])
    time_emb = emb @ params["emb"]["w"] + params["emb"]["b"]
    w1 = params["in_layers"][0]["w"]  # (I + d_emb, H)
    item_num = x_t.shape[1]
    temb_proj = time_emb @ w1[item_num:] + params["in_layers"][0]["b"]
    return fused_denoise_mlp(
        x_t, w1[:item_num], temb_proj,
        params["out_layers"][0]["w"], params["out_layers"][0]["b"],
    )
