"""Gaussian diffusion: q-sample and the deterministic reverse generation.

Counterpart of ``diffmm_tpu/diffusion/gaussian.py`` (reference
`Model.py:222-378`). The denoiser is passed in functionally as
``(params, x_t, t) -> x0_hat``. ``training_losses`` comes with the training
slice.

Random draws come from an explicit ``torch.Generator``; they cannot match
JAX's threefry stream, so :func:`generate_view` also takes the raw standard
normal draw as ``noise``, which lets a test feed both packages one draw.
"""

from __future__ import annotations

from typing import Callable

import torch

from diffmm_tpu_torch.diffusion.schedule import DiffusionSchedule
from diffmm_tpu_torch.models.denoise import denoise_forward
from diffmm_tpu_torch.ops.losses import l2_normalize

DenoiseApply = Callable[..., torch.Tensor]


def _extract(buf: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Gather (steps,) schedule buffer at per-row timesteps -> (B, 1)."""
    return buf[t][:, None]


def q_sample(
    schedule: DiffusionSchedule,
    x0: torch.Tensor,
    t: torch.Tensor,
    raw: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Forward-noise x0 to x_t (reference `Model.py:324-341`) with the
    sign-normalised noise ``sign(x0) * row_l2_normalize(raw)``, the branch
    ``generate_view`` reaches; ``raw`` is the standard-normal draw, taken
    from ``generator`` when not given. (The plain-Gaussian branch of
    diffusion training comes with the training slice.)"""
    if raw is None:
        raw = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    noise = torch.sign(x0) * l2_normalize(raw, dim=1)
    x0_coef = _extract(schedule.sqrt_alphas_cumprod, t)
    noise_coef = _extract(schedule.sqrt_one_minus_alphas_cumprod, t)
    return x0_coef * x0 + noise_coef * noise


def p_mean(
    schedule: DiffusionSchedule,
    denoise_params,
    x_t: torch.Tensor,
    t: torch.Tensor,
    denoise_apply: DenoiseApply = denoise_forward,
) -> torch.Tensor:
    """Posterior mean of p(x_{t-1} | x_t) (reference `Model.py:357-378`); the
    denoiser runs without modality conditioning (`Model.py:365`)."""
    x0_hat = denoise_apply(denoise_params, x_t, t)
    c1 = _extract(schedule.posterior_mean_coef1, t)
    c2 = _extract(schedule.posterior_mean_coef2, t)
    return c1 * x0_hat + c2 * x_t


def generate_view(
    schedule: DiffusionSchedule,
    denoise_params,
    x_start: torch.Tensor,
    sampling_step: int,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    denoise_apply: DenoiseApply = denoise_forward,
) -> torch.Tensor:
    """Deterministic reverse diffusion (reference `Model.py:300-322`).

    ``sampling_step == 0`` starts from the clean row. Otherwise x_start is
    q-sampled to ``t = sampling_step - 1`` with the sign-normalised noise
    made from ``noise`` (the raw standard-normal draw, or one from
    ``generator``), then the full ``steps-1 .. 0`` posterior-mean loop runs
    (it always covers all steps, `Model.py:316`)."""
    batch = x_start.shape[0]
    dev = x_start.device
    if sampling_step == 0:
        x_t = x_start
    else:
        t0 = torch.full((batch,), sampling_step - 1, dtype=torch.long, device=dev)
        x_t = q_sample(schedule, x_start, t0, raw=noise, generator=generator)
    for i in range(schedule.steps - 1, -1, -1):
        t = torch.full((batch,), i, dtype=torch.long, device=dev)
        x_t = p_mean(schedule, denoise_params, x_t, t, denoise_apply)
    return x_t
