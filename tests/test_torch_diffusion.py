"""Port Gaussian diffusion (diffmm_tpu_torch/diffusion/gaussian.py) against
diffmm_tpu: q_sample on the sign-normalised noise branch, p_mean, and
generate_view at sampling_step=0 and with the raw noise draw injected (the
same jax.random.normal draw JAX's q_sample makes from its key).

Tolerance: f32 throughout, rtol 1e-5 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.diffusion import gaussian as jg
from diffmm_tpu.diffusion.schedule import make_schedule as j_sched
from diffmm_tpu.models import denoise as jd
from diffmm_tpu_torch.convert import denoise_params_from_jax
from diffmm_tpu_torch.diffusion import gaussian as tg
from diffmm_tpu_torch.diffusion.schedule import make_schedule as t_sched
from diffmm_tpu_torch.ops.losses import l2_normalize
from diffmm_tpu_torch.ops.kernels.denoise_mlp import denoise_forward_fused

RTOL, ATOL = 1e-5, 1e-5
SCHED = (0.5, 1e-4, 0.02, 5)


def _setup(rng, item_num=50, batch=9, hidden=(32,)):
    j = jd.init_denoise_params(jax.random.PRNGKey(4), item_num, list(hidden), 10, 8)
    t = denoise_params_from_jax(jax.device_get(j))
    x0 = (rng.random((batch, item_num)) < 0.2).astype(np.float32)
    return j, t, x0


def test_q_sample_sign_noise_branch(rng):
    x0 = (rng.random((6, 20)) < 0.3).astype(np.float32)
    t = np.array([0, 1, 2, 3, 4, 1])
    key = jax.random.PRNGKey(9)
    raw = np.array(jax.random.normal(key, x0.shape, dtype=jnp.float32))
    want = np.asarray(jg.q_sample(j_sched(*SCHED), jnp.asarray(x0), jnp.asarray(t), None, key=key))
    x0_t = torch.as_tensor(x0)
    # the sign-normalised noise as generate_view makes it from the raw draw
    noise = torch.sign(x0_t) * l2_normalize(torch.as_tensor(raw), dim=1)
    got = tg.q_sample(t_sched(*SCHED), x0_t, torch.as_tensor(t), noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_p_mean_matches(rng):
    j, t, x0 = _setup(rng)
    steps = np.arange(x0.shape[0]) % 5
    want = np.asarray(jg.p_mean(j_sched(*SCHED), j, jnp.asarray(x0), jnp.asarray(steps)))
    got = tg.p_mean(t_sched(*SCHED), t, torch.as_tensor(x0), torch.as_tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sampling_step", [0, 1, 3])
def test_generate_view_matches(rng, sampling_step):
    j, t, x0 = _setup(rng)
    key = jax.random.PRNGKey(21)
    raw = np.array(jax.random.normal(key, x0.shape, dtype=jnp.float32))
    want = np.asarray(jg.generate_view(j_sched(*SCHED), j, jnp.asarray(x0), sampling_step, key=key))
    got = tg.generate_view(t_sched(*SCHED), t, torch.as_tensor(x0), sampling_step,
                           noise=torch.as_tensor(raw)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the rebuild's denoiser: the fused forward (plain versions on the CPU)
    fused = tg.generate_view(t_sched(*SCHED), t, torch.as_tensor(x0), sampling_step,
                             noise=torch.as_tensor(raw), denoise_apply=denoise_forward_fused)
    np.testing.assert_allclose(fused.numpy(), want, rtol=RTOL, atol=ATOL)


def test_generate_view_draws_from_generator(rng):
    _, t, x0 = _setup(rng)
    sched = t_sched(*SCHED)
    a = tg.generate_view(sched, t, torch.as_tensor(x0), 2, generator=torch.Generator().manual_seed(1))
    b = tg.generate_view(sched, t, torch.as_tensor(x0), 2, generator=torch.Generator().manual_seed(1))
    c = tg.generate_view(sched, t, torch.as_tensor(x0), 0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
