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

The first in-layer's product over the concat is computed as its two parts,
``x_t @ W[:n] + time_emb @ W[n:] + b`` (n the x columns), so that on a
model axis (``group``) the x part can be one catalog shard's: x_t and the
x rows of W are then the rank's catalog range, the products over the
catalog (that part, and the gate's ``x_t @ modal_feat``) are summed over
the group before anything nonlinear, and the last out-layer (the rank's
catalog columns) gives the rank's columns of the output.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from diffmm_tpu_torch.parallel.collectives import AllReduceSum

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


def _linear(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """``x @ w + b`` in the type JAX promotes the operands to (f32 with
    bf16 weights widens the weights exactly, as ``jnp.matmul`` does; bf16
    with bf16 stays bf16, f32 accumulation on the card)."""
    w, b = layer["w"], layer["b"]
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt) + b


def catalog_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, a product over the rank's catalog shard, summed over the model
    axis ``group`` (autograd: :class:`~diffmm_tpu_torch.parallel.
    collectives.AllReduceSum`, in f32); ``x`` itself without a group."""
    if group is None:
        return x
    return AllReduceSum.apply(x.to(torch.float32), group).to(x.dtype)


def denoise_forward(
    params: Params,
    x_t: torch.Tensor,
    timesteps: torch.Tensor,
    modal_feat: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
    group=None,
) -> torch.Tensor:
    """Predict x0 from x_t (reference `Model.py:183-220`).

    ``modal_feat`` (I, latdim) enables the modality gating of diffusion
    training; reverse sampling passes None. ``compute_dtype`` (JAX
    ``compute_dtype``, e.g. bf16 for ``train.rebuild_compute="bf16"``)
    casts x_t, the time embedding and the features, so the MLP's products
    run in that type; the weights are not cast here (pass them in that type,
    cast once per rebuild), and the time embedding's projection stays in
    the weights' promoted type and is cast after it. Without it the forward
    runs in x_t's type, bf16 weights widened (``base.denoise_param_dtype=
    "bf16"``: gradients reach them rounded back to bf16, as JAX's do).

    ``group``: a model axis; x_t, ``modal_feat`` and the catalog-wide
    layers are then the rank's catalog shard (see the module note)."""
    emb = timestep_embedding(timesteps, params["emb"]["w"].shape[0])
    time_emb = _linear(emb, params["emb"])
    if compute_dtype is not None:
        x_t = x_t.to(compute_dtype)
        time_emb = time_emb.to(compute_dtype)
        if modal_feat is not None:
            modal_feat = modal_feat.to(compute_dtype)
    if modal_feat is not None:
        projected = catalog_sum(x_t @ modal_feat, group)
        gate = torch.sigmoid(_linear(projected, params["gate"]))
        x_t = x_t + (projected * gate) @ modal_feat.T
    first, *rest = params["in_layers"]
    w, n = first["w"], x_t.shape[-1]
    dt = torch.promote_types(x_t.dtype, w.dtype)
    h = torch.tanh(catalog_sum(x_t.to(dt) @ w[:n].to(dt), group)
                   + time_emb.to(dt) @ w[n:].to(dt) + first["b"])
    for layer in rest:
        h = torch.tanh(_linear(h, layer))
    n_out = len(params["out_layers"])
    for i, layer in enumerate(params["out_layers"]):
        h = _linear(h, layer)
        if i != n_out - 1:
            h = torch.tanh(h)
    return h
