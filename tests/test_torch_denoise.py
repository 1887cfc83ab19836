"""Port diffusion schedule, denoiser and the K2/K3 plain versions against
diffmm_tpu: make_schedule, timestep_embedding, denoise_forward (with and
without modality gating), K2 then K3 against JAX's fused_denoise_mlp in
interpret mode, and
denoise_forward_pallas in interpret mode, with JAX parameters carried over
by convert.params_from_jax.

Tolerance: all f32 — rtol 1e-5 (atol 1e-5 where values cross zero); the
schedule is f64 on the host on both sides and compares exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.diffusion import schedule as js
from diffmm_tpu.models import denoise as jd
from diffmm_tpu.ops.pallas.denoise_mlp import denoise_forward_pallas, fused_denoise_mlp as j_fused
from diffmm_tpu_torch.convert import denoise_params_from_jax
from diffmm_tpu_torch.diffusion import schedule as ts
from diffmm_tpu_torch.models import denoise as td
from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
    denoise_forward_fused,
    denoise_layer1,
    denoise_layer2,
    layer1_plain,
    layer2_plain,
)

RTOL, ATOL = 1e-5, 1e-5


@pytest.mark.parametrize("args", [(0.1, 1e-4, 0.02, 5), (0.5, 1e-4, 0.02, 5), (0.2, 1e-3, 0.05, 9)])
def test_schedule_matches(args):
    np.testing.assert_array_equal(ts.get_betas(*args), js.get_betas(*args))
    t, j = ts.make_schedule(*args), js.make_schedule(*args)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t.steps == j.steps
    with pytest.raises(ValueError):
        ts.make_schedule(0.0, 1e-4, 0.02, 5)


def test_timestep_embedding_matches():
    t = np.arange(9) % 5
    for dim in (10, 7):
        got = td.timestep_embedding(torch.as_tensor(t), dim).numpy()
        want = np.asarray(jd.timestep_embedding(jnp.asarray(t), dim))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _params(item_num, hidden, latdim, seed=0):
    j = jd.init_denoise_params(jax.random.PRNGKey(seed), item_num, hidden, 10, latdim)
    t = denoise_params_from_jax(jax.device_get(j))
    return j, t


@pytest.mark.parametrize("hidden", [[32], [24, 16]], ids=["one_hidden", "two_hidden"])
@pytest.mark.parametrize("with_modal", [False, True])
def test_denoise_forward_matches(rng, hidden, with_modal):
    item_num, latdim = 60, 8
    j, t = _params(item_num, hidden, latdim)
    x = rng.standard_normal((12, item_num)).astype(np.float32)
    steps = np.arange(12) % 5
    feat = rng.standard_normal((item_num, latdim)).astype(np.float32) if with_modal else None
    want = np.asarray(jd.denoise_forward(j, jnp.asarray(x), jnp.asarray(steps),
                                         None if feat is None else jnp.asarray(feat)))
    got = td.denoise_forward(t, torch.as_tensor(x), torch.as_tensor(steps),
                             None if feat is None else torch.as_tensor(feat)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_init_denoise_params_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    t = td.init_denoise_params(gen, 300, [64], 10, 16)
    j = jd.init_denoise_params(jax.random.PRNGKey(0), 300, [64], 10, 16)
    flat_t = jax.tree_util.tree_leaves(t, is_leaf=lambda a: isinstance(a, torch.Tensor))
    flat_j = jax.tree_util.tree_leaves(j)
    assert [tuple(a.shape) for a in flat_t] == [a.shape for a in flat_j]
    # same distributions: xavier-normal std of the wide layer within 5%
    w = t["in_layers"][0]["w"]
    assert abs(float(w.std()) / np.sqrt(2.0 / (310 + 64)) - 1) < 0.05


# B20 and ragged: deep enough for K2's gemm form; narrow: web scale's
# hidden width of 64 (K3's strip form on the card) at a catalog of 1,500
@pytest.mark.parametrize("shape", [(20, 300, 64), (7, 133, 48), (16, 1500, 64)], ids=["B20", "ragged", "narrow"])
def test_k2_k3_plain_match_fused_interpret(rng, shape):
    B, K, H = shape
    x = rng.standard_normal((B, K)).astype(np.float32)
    w1 = (rng.standard_normal((K, H)) * 0.05).astype(np.float32)
    tp = rng.standard_normal((B, H)).astype(np.float32) * 0.1
    w2 = (rng.standard_normal((H, K)) * 0.05).astype(np.float32)
    b2 = rng.standard_normal((K,)).astype(np.float32) * 0.01
    want = np.asarray(j_fused(*(jnp.asarray(a) for a in (x, w1, tp, w2, b2)), interpret=True))
    tt = [torch.as_tensor(a) for a in (x, w1, tp, w2, b2)]
    got = denoise_layer2(denoise_layer1(*tt[:3]), tt[3], tt[4]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    two_step = layer2_plain(layer1_plain(*tt[:3]), tt[3], tt[4]).numpy()
    np.testing.assert_array_equal(got, two_step)


def test_denoise_forward_fused_matches_pallas_interpret(rng):
    item_num = 133
    j, t = _params(item_num, [48], 8, seed=1)
    x = rng.standard_normal((7, item_num)).astype(np.float32)
    steps = np.arange(7) % 5
    want = np.asarray(denoise_forward_pallas(j, jnp.asarray(x), jnp.asarray(steps), interpret=True))
    got = denoise_forward_fused(t, torch.as_tensor(x), torch.as_tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError, match="single hidden layer"):
        denoise_forward_fused(_params(item_num, [16, 8], 8)[1], torch.as_tensor(x),
                              torch.as_tensor(steps))
