"""The port's diffusion schedule against an independent float64 port of
the reference math (reference `Model.py:239-275`), after
``tests/test_schedule.py``: every buffer, the SNR weights, and the refusal
of a zero noise scale. (``tests/test_torch_denoise.py`` holds the same
buffers against the JAX package's.)"""

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.diffusion.schedule import make_schedule, snr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors: beside the other test
    workers, several threads a process spin against each other (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_buffers(noise_scale, noise_min, noise_max, steps):
    """Reference get_betas + calculate_for_diffusion in float64 torch."""
    variance = np.linspace(noise_scale * noise_min, noise_scale * noise_max, steps, dtype=np.float64)
    alpha_bar = 1 - variance
    betas = [1 - alpha_bar[0]]
    for i in range(1, steps):
        betas.append(min(1 - alpha_bar[i] / alpha_bar[i - 1], 0.999))
    betas = torch.tensor(np.array(betas), dtype=torch.float64)
    betas[0] = 0.0001
    alphas = 1.0 - betas
    alphas_cumprod = torch.cumprod(alphas, dim=0)
    alphas_cumprod_prev = torch.cat([torch.tensor([1.0], dtype=torch.float64), alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    return {
        "betas": betas,
        "alphas_cumprod": alphas_cumprod,
        "alphas_cumprod_prev": alphas_cumprod_prev,
        "sqrt_alphas_cumprod": torch.sqrt(alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": torch.sqrt(1.0 - alphas_cumprod),
        "posterior_variance": posterior_variance,
        "posterior_log_variance_clipped": torch.log(torch.cat([posterior_variance[1:2], posterior_variance[1:]])),
        "posterior_mean_coef1": betas * torch.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        "posterior_mean_coef2": (1.0 - alphas_cumprod_prev) * torch.sqrt(alphas) / (1.0 - alphas_cumprod),
    }


@pytest.mark.parametrize("scale, steps", [(0.1, 5), (0.5, 5), (0.2, 5), (0.1, 40)])  # the shipped configs, long T
def test_schedule_matches_reference(scale, steps):
    got = make_schedule(scale, 0.0001, 0.02, steps)
    for name, want in _reference_buffers(scale, 0.0001, 0.02, steps).items():
        np.testing.assert_allclose(getattr(got, name).numpy(), want.numpy().astype(np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_snr_weights():
    got = make_schedule(0.1, 0.0001, 0.02, 5)
    ab = got.alphas_cumprod.numpy().astype(np.float64)
    t = np.arange(5)
    np.testing.assert_allclose(snr(got, torch.as_tensor(t)).numpy(), ab[t] / (1 - ab[t] + 1e-8), rtol=1e-4)


def test_zero_noise_scale_rejected():
    with pytest.raises(ValueError, match="noise_scale=0"):
        make_schedule(0.0, 0.0001, 0.02, 5)
