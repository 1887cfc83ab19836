"""Gaussian diffusion schedule precompute.

Counterpart of ``diffmm_tpu/diffusion/schedule.py`` (reference
`Model.py:239-275`): every buffer is computed in float64 numpy on the host
and cast to f32 tensors once at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    """All (steps,) f32 buffers used by q-sample / reverse / loss weighting."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def steps(self) -> int:
        return self.betas.shape[0]


def get_betas(
    noise_scale: float, noise_min: float, noise_max: float, steps: int
) -> np.ndarray:
    """Linear alpha-bar betas (reference `Model.py:239-250`)."""
    start = noise_scale * noise_min
    end = noise_scale * noise_max
    variance = np.linspace(start, end, steps, dtype=np.float64)
    alpha_bar = 1.0 - variance
    betas = [1.0 - alpha_bar[0]]
    for i in range(1, steps):
        betas.append(min(1.0 - alpha_bar[i] / alpha_bar[i - 1], 0.999))
    return np.array(betas, dtype=np.float64)


def make_schedule(
    noise_scale: float,
    noise_min: float,
    noise_max: float,
    steps: int,
    beta_fixed: bool = True,
    device: torch.device | str = "cpu",
) -> DiffusionSchedule:
    """Precompute every diffusion buffer (reference `Model.py:252-275`)."""
    if noise_scale == 0:
        raise ValueError(
            "noise_scale=0 is unsupported: the reference skips schedule "
            "construction entirely and would crash on first q-sample "
            "(reference Model.py:232-237); no shipped config uses it."
        )
    betas = get_betas(noise_scale, noise_min, noise_max, steps)
    if beta_fixed:
        betas[0] = 1e-4  # reference Model.py:234-235

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # posterior_variance[0] == 0; the reference substitutes element [1]
    # before the log (`Model.py:270`)
    posterior_log_variance_clipped = np.log(
        np.concatenate([[posterior_variance[1]], posterior_variance[1:]])
    )
    posterior_mean_coef1 = betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_mean_coef2 = (
        (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
    )

    def as_f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    return DiffusionSchedule(
        betas=as_f32(betas),
        alphas_cumprod=as_f32(alphas_cumprod),
        alphas_cumprod_prev=as_f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=as_f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=as_f32(np.sqrt(1.0 - alphas_cumprod)),
        posterior_variance=as_f32(posterior_variance),
        posterior_log_variance_clipped=as_f32(posterior_log_variance_clipped),
        posterior_mean_coef1=as_f32(posterior_mean_coef1),
        posterior_mean_coef2=as_f32(posterior_mean_coef2),
    )


def snr(schedule: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio at timestep t (reference `Model.py:380-383`)."""
    ab = schedule.alphas_cumprod[t]
    return ab / (1.0 - ab + 1e-8)
