"""Gaussian diffusion: q-sample, the training loss and the deterministic
reverse generation.

Counterpart of ``diffmm_tpu/diffusion/gaussian.py`` (reference
`Model.py:222-428`). The denoiser is passed in functionally as
``(params, x_t, t[, modal_feat]) -> x0_hat``.

Random draws come from an explicit ``torch.Generator``; they cannot match
JAX's threefry stream, so :func:`generate_view` also takes the raw standard
normal draw as ``noise``, and :func:`training_losses` its timesteps and its
noise, which lets a test feed both packages one draw.
"""

from __future__ import annotations

from typing import Callable

import torch

from diffmm_tpu_torch.diffusion.schedule import DiffusionSchedule, snr
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
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Forward-noise x0 to x_t (reference `Model.py:324-341`).

    With ``noise`` given, the plain-Gaussian branch of diffusion training
    (`Model.py:400-401`): ``x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) noise``.
    Otherwise the sign-normalised noise ``sign(x0) * row_l2_normalize(raw)``
    of ``generate_view`` (`Model.py:313-314`), ``raw`` the standard-normal
    draw, taken from ``generator`` when not given."""
    if noise is None:
        if raw is None:
            raw = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        noise = torch.sign(x0) * l2_normalize(raw, dim=1)
    x0_coef = _extract(schedule.sqrt_alphas_cumprod, t)
    noise_coef = _extract(schedule.sqrt_one_minus_alphas_cumprod, t)
    return x0_coef * x0 + noise_coef * noise


def training_losses(
    schedule: DiffusionSchedule,
    denoise_params,
    x_start: torch.Tensor,
    i_embs: torch.Tensor,
    modal_feat: torch.Tensor,
    sim_weight: float,
    reg: float,
    t: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    denoise_apply: DenoiseApply = denoise_forward,
) -> torch.Tensor:
    """Per-row diffusion training loss (reference `Model.py:385-428`), (B,).

    Three terms, as in the JAX package:
      * SNR-weighted reconstruction ``w_t * mean_items((x0_hat - x0)^2)``
        with ``w_t = SNR(t-1) - SNR(t)`` and ``w_0 = 1`` (`Model.py:407-413`);
      * preference similarity ``1 - cos(x0_hat @ F, x0 @ E_i)``
        (`Model.py:416-418`), scaled by ``sim_weight``;
      * ``reg * ||E_i||^2`` scaled by ``reg`` again (the reference applies
        it twice, `Model.py:425`).

    ``i_embs`` is detached: the reference zeroes its gradient before the
    main model's step (`Main.py:375`). ``t`` (B,) and ``noise`` (B, I) are
    drawn from ``generator`` when not given (uniform steps, standard
    normal)."""
    batch = x_start.shape[0]
    dev = x_start.device
    if t is None:
        t = torch.randint(0, schedule.steps, (batch,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=dev, dtype=x_start.dtype)
    t = t.long()
    x_t = q_sample(schedule, x_start, t, noise=noise)
    x0_hat = denoise_apply(denoise_params, x_t, t, modal_feat)

    mse = torch.mean(torch.square(x0_hat - x_start), dim=-1)
    weight = snr(schedule, torch.clamp_min(t - 1, 0)) - snr(schedule, t)
    weight = torch.where(t == 0, torch.ones_like(weight), weight)
    reconstruction = weight * mse

    i_embs = i_embs.detach()
    user_modal = x0_hat @ modal_feat  # (B, latdim)
    user_id = x_start @ i_embs  # (B, latdim)
    cos = torch.sum(l2_normalize(user_modal, dim=-1) * l2_normalize(user_id, dim=-1), dim=-1)
    sim_loss = 1.0 - cos
    reg_loss = reg * torch.sum(torch.square(i_embs))
    return reconstruction + sim_loss * sim_weight + reg_loss * reg


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
