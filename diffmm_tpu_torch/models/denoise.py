"""Denoiser MLP: parameters + functional forward.

Counterpart of ``diffmm_tpu/models/denoise.py`` (reference `Model.py:136-220`).
Parameters are a dict of plain tensors in the JAX package's layout: each
Linear is ``{"w": (d_in, d_out), "b": (d_out,)}`` and the forward computes
``x @ w + b``. Keeping ``(d_in, d_out)`` makes the layer-1 slice
``w[:I]`` the row-major (K, H) operand the denoise_mlp kernel reads.

Architecture (hidden widths ``H``, catalog ``I``): sinusoidal time
embedding -> Linear(d_emb, d_emb); optional modality gating; ``concat([x_t,
time_emb])`` through the in-layers with tanh, then the out-layers with tanh
between all but the last. Dropout is never applied, as in the reference.
"""

from __future__ import annotations

import math
from typing import Any

import torch

Params = dict[str, Any]


def _xavier_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    std = math.sqrt(2.0 / (shape[0] + shape[1]))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std


def _torch_linear_default(gen: torch.Generator, fan_in: int, shape, device) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2 * bound) - bound


def init_denoise_params(
    gen: torch.Generator, item_num: int, hidden_dims: list[int], time_emb_dim: int,
    latdim: int, device: torch.device | str = "cpu",
) -> Params:
    """One modality's denoiser, with the JAX package's distributions:
    xavier-normal weights, N(0, 0.001) biases, torch-default uniform gate.
    The in-stack walks the hidden widths reversed, the out-stack forward
    (reference `Main.py:97-98`)."""
    in_dims = [item_num + time_emb_dim] + list(reversed(hidden_dims))
    out_dims = list(hidden_dims) + [item_num]

    def layer(d_in, d_out):
        w = _xavier_normal(gen, (d_in, d_out), device)
        b = torch.randn((d_out,), generator=gen, device=device) * 0.001
        return {"w": w, "b": b}

    return {
        "in_layers": [layer(a, b) for a, b in zip(in_dims[:-1], in_dims[1:])],
        "out_layers": [layer(a, b) for a, b in zip(out_dims[:-1], out_dims[1:])],
        "emb": layer(time_emb_dim, time_emb_dim),
        "gate": {
            "w": _torch_linear_default(gen, latdim, (latdim, latdim), device),
            "b": _torch_linear_default(gen, latdim, (latdim,), device),
        },
    }


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Transformer sinusoidal time embedding (reference `Model.py:196-201`)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    angles = timesteps.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def denoise_forward(
    params: Params,
    x_t: torch.Tensor,
    timesteps: torch.Tensor,
    modal_feat: torch.Tensor | None = None,
) -> torch.Tensor:
    """Predict x0 from x_t (reference `Model.py:183-220`), in f32.

    ``modal_feat`` (I, latdim) enables the modality gating of diffusion
    training; reverse sampling passes None."""
    emb = timestep_embedding(timesteps, params["emb"]["w"].shape[0])
    time_emb = emb @ params["emb"]["w"] + params["emb"]["b"]
    if modal_feat is not None:
        projected = x_t @ modal_feat
        gate = torch.sigmoid(projected @ params["gate"]["w"] + params["gate"]["b"])
        x_t = x_t + (projected * gate) @ modal_feat.T
    h = torch.cat([x_t, time_emb], dim=-1)
    for layer in params["in_layers"]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    n_out = len(params["out_layers"])
    for i, layer in enumerate(params["out_layers"]):
        h = h @ layer["w"] + layer["b"]
        if i != n_out - 1:
            h = torch.tanh(h)
    return h
