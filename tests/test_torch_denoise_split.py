"""K2/K3's 3xTF32 design on the CPU: the TF32 split, the prepared weight
layout, the design's accuracy argument, and the rebuild's prepared
denoiser against the JAX package's Pallas forward (interpret mode).

The split is checked against an independent rounding (float64 arithmetic,
no bit tricks) to nearest with ties away from zero at TF32's 11
significant bits, the rounding of the kernel's ``cvt.rna.tf32.f32``. The
accuracy test emulates the kernel's arithmetic: products of TF32 operands
are exact, the tensor cores add each 8-deep step into their accumulator
with truncation toward zero, and each 32-deep tile's sum is added to the
running f32 sum rounded to nearest. Its gate is the card's: max error
against float64 at most twice the plain f32 product's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.models import denoise as jd
from diffmm_tpu.ops.pallas.denoise_mlp import denoise_forward_pallas
from diffmm_tpu_torch.convert import denoise_params_from_jax
from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
    KT,
    NT,
    KernelWeight,
    PreparedDenoiser,
    denoise_forward_fused,
    denoise_layer1,
    denoise_layer2,
    prepare_denoiser,
    prepare_weight,
    tf32_split,
)


def tf32_reference(w: np.ndarray) -> np.ndarray:
    """f32 ``w`` rounded to 11 significant bits, to nearest, ties away from
    zero; below 2^-126 the f32 grid's 13 low bits are dropped the same way."""
    x = w.astype(np.float64)
    _, e = np.frexp(x)
    step = np.ldexp(1.0, np.maximum(e - 11, -136))
    return np.copysign(np.floor(np.abs(x) / step + 0.5) * step, x).astype(np.float32)


def _values(kind: str, rng) -> np.ndarray:
    n = 4096
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32) * 0.03
    if kind == "zeros":
        return np.array([0.0, -0.0] * (n // 2), dtype=np.float32)
    if kind == "subnormal":
        bits = rng.integers(1, 1 << 23, n, dtype=np.uint32) | (rng.integers(0, 2, n, dtype=np.uint32) << 31)
        return bits.view(np.float32)
    if kind == "large":
        # up to 1e38: every value's TF32 rounding stays finite
        return (rng.uniform(-1, 1, n) * 10.0 ** rng.uniform(20, 38, n)).astype(np.float32)
    # exact ties: the 13 dropped bits are 1000...0
    bits = (rng.integers(0, 1 << 10, n, dtype=np.uint32) << 13) | 0x1000
    bits |= rng.integers(0x30, 0x50, n, dtype=np.uint32) << 23
    bits |= rng.integers(0, 2, n, dtype=np.uint32) << 31
    return bits.view(np.float32)


@pytest.mark.parametrize("kind", ["normal", "zeros", "subnormal", "large", "ties"])
def test_tf32_split(rng, kind):
    w = _values(kind, rng)
    hi, lo = tf32_split(torch.as_tensor(w))
    hi_bits = hi.numpy().view(np.uint32)
    assert not (hi_bits & 0x1FFF).any()
    np.testing.assert_array_equal((hi + lo).numpy().view(np.uint32), w.view(np.uint32))
    np.testing.assert_array_equal(hi_bits, tf32_reference(w).view(np.uint32))
    # the kernel reads lo as TF32 too: |lo| is at most half a TF32 step of w
    assert (np.abs(lo.numpy().astype(np.float64)) <= np.abs(w.astype(np.float64)) * 2.0**-11 + 2.0**-137).all()


def _stored_position(k: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Where column k % 32 of row n sits in its 32-float slab row: the slab
    permutation c = 8 a + 2 s + b <- position p = 8 s + 4 b + a (each
    thread's fragment in consecutive columns), then the 128-byte swizzle of
    16-byte chunks by n % 8."""
    c = k % KT
    p = 8 * ((c % 8) // 2) + 4 * (c % 2) + c // 8
    return ((p // 4) ^ (n % 8)) * 4 + p % 4


@pytest.mark.parametrize("shape", [(70, 300), (17, 5), (64, 128), (33, 129)])
def test_prepared_layout(rng, shape):
    K, N = shape
    w = rng.standard_normal(shape).astype(np.float32)
    prep = prepare_weight(torch.as_tensor(w))
    kt, n_pad = -(-K // KT), -(-N // NT) * NT
    assert (prep.k, prep.n) == (K, N)
    assert tuple(prep.data.shape) == (2, kt, n_pad, KT) and prep.data.is_contiguous()
    data = prep.data.numpy()
    hi, lo = (t.numpy() for t in tf32_split(torch.as_tensor(w)))
    k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
    t = _stored_position(k, n)
    np.testing.assert_array_equal(data[0, k // KT, n, t], hi)  # transposed: (k, n) -> slab row n
    np.testing.assert_array_equal(data[1, k // KT, n, t], lo)
    # back to the JAX layout, bit for bit
    np.testing.assert_array_equal(data[0, k // KT, n, t] + data[1, k // KT, n, t], w)
    # everything else is the zero padding
    filled = np.zeros(data.shape[1:], dtype=bool)
    filled[k // KT, n, t] = True
    assert not data[:, ~filled].any()
    assert filled.sum() == K * N


def _rz_add(acc: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """f32 ``acc + add`` (add in f64) rounded toward zero."""
    s = acc.double() + add
    f = s.float()
    return torch.where(f.double().abs() > s.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _emulated_kernel(x: torch.Tensor, w: torch.Tensor, promote: bool) -> torch.Tensor:
    """x @ w as the kernel computes it: 3xTF32, each 32-deep tile's hi*lo
    and lo*hi products of its 8-deep steps first, then its hi*hi ones, each
    added to the tensor cores' accumulator with truncation; with
    ``promote``, each tile's sum then added to the running f32 sum,
    rounded."""
    trunc = lambda t: (t.view(torch.int32) & -0x2000).view(torch.float32)  # noqa: E731
    (hx, lx), (hw, lw) = tf32_split(x), tf32_split(w)
    # the tensor cores read lo's top 19 bits
    xh, xl, wh, wl = hx.double(), trunc(lx).double(), hw.double(), trunc(lw).double()
    total = torch.zeros((x.shape[0], w.shape[1]))
    tile = torch.zeros_like(total)
    for t0 in range(0, x.shape[1], KT):
        steps = [slice(k0, k0 + 8) for k0 in range(t0, min(t0 + KT, x.shape[1]), 8)]
        for s in steps:
            tile = _rz_add(tile, xh[:, s] @ wl[s])
            tile = _rz_add(tile, xl[:, s] @ wh[s])
        for s in steps:
            tile = _rz_add(tile, xh[:, s] @ wh[s])
        if promote:
            total, tile = total + tile, torch.zeros_like(tile)
    return total if promote else tile


def test_emulated_3xtf32_within_twice_the_f32_error():
    """At the rebuild's contraction depth (K 6,710) on B 64 x H 64."""
    rng = np.random.default_rng(0)
    B, K, H = 64, 6710, 64
    x = torch.as_tensor(rng.standard_normal((B, K)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((K, H)) * np.sqrt(2.0 / (K + H))).astype(np.float32))
    exact = x.double() @ w.double()
    err_f32 = float((x @ w - exact).abs().max())
    err_3x = float((_emulated_kernel(x, w, promote=True) - exact).abs().max())
    assert err_3x <= 2 * err_f32, (err_3x, err_f32)
    # why the kernel adds each tile's sum in f32: one truncating accumulator
    # over the whole contraction drifts past the card's tolerance (atol 5e-5)
    err_one_acc = float((_emulated_kernel(x, w, promote=False) - exact).abs().max())
    assert err_one_acc > 5e-5 > 10 * err_3x, (err_one_acc, err_3x)


def test_emulated_3xtf32_at_the_strip_depth():
    """At web scale's hidden width (K 64: two 32-deep slabs, the strip
    form's contraction; B 64 x N 512): the kernel's arithmetic, which both
    forms share, within twice the f32 product's error against float64."""
    rng = np.random.default_rng(1)
    B, K, N = 64, 64, 512
    x = torch.as_tensor(np.tanh(rng.standard_normal((B, K))).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((K, N)) * np.sqrt(2.0 / (K + N))).astype(np.float32))
    exact = x.double() @ w.double()
    err_f32 = float((x @ w - exact).abs().max())
    err_3x = float((_emulated_kernel(x, w, promote=True) - exact).abs().max())
    assert err_3x <= 2 * err_f32, (err_3x, err_f32)


def _params(item_num, hidden, seed):
    j = jd.init_denoise_params(jax.random.PRNGKey(seed), item_num, hidden, 10, 8)
    return j, denoise_params_from_jax(jax.device_get(j))


# 133 and 300 at hidden 48; 1,500, the narrow case, at web scale's hidden 64
@pytest.mark.parametrize("item_num", [133, 300, 1500])
def test_prepared_denoiser_matches_pallas_interpret(rng, item_num):
    j, t = _params(item_num, [64 if item_num == 1500 else 48], seed=2)
    prep = prepare_denoiser(t)
    assert isinstance(prep, PreparedDenoiser)
    # on the CPU the prepared form holds the plain weights
    assert torch.equal(prep.w1x, t["in_layers"][0]["w"][:item_num])
    assert torch.equal(prep.w2, t["out_layers"][0]["w"])
    x = rng.standard_normal((9, item_num)).astype(np.float32)
    steps = np.arange(9) % 5
    want = np.asarray(denoise_forward_pallas(j, jnp.asarray(x), jnp.asarray(steps), interpret=True))
    got = denoise_forward_fused(prep, torch.as_tensor(x), torch.as_tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, denoise_forward_fused(t, torch.as_tensor(x), torch.as_tensor(steps)).numpy())
    with pytest.raises(NotImplementedError, match="single hidden layer"):
        prepare_denoiser(_params(item_num, [16, 8], seed=2)[1])


def test_rebuild_block_tables_takes_prepared_denoisers_only():
    """A params dict would be put in the kernels' layout again at every
    step and block; the rebuild prepares each denoiser once."""
    from diffmm_tpu_torch.train.steps import rebuild_block_tables

    _, t = _params(40, [16], seed=3)
    with pytest.raises(TypeError, match="prepare_denoiser"):
        rebuild_block_tables(None, [prepare_denoiser(t), t], None, torch.zeros(2, dtype=torch.long), 40, 0, 5)


def test_cpu_wrappers_refuse_prepared_weights():
    """A KernelWeight is the card's layout; the CPU's plain versions take
    the JAX layout only."""
    x, tp = torch.zeros((2, 40)), torch.zeros((2, 16))
    w = prepare_weight(torch.zeros((40, 16)))
    assert isinstance(w, KernelWeight)
    with pytest.raises(ValueError, match="denoise_layer1: a prepared weight"):
        denoise_layer1(x, w, tp)
    with pytest.raises(ValueError, match="denoise_layer2: a prepared weight"):
        denoise_layer2(tp, prepare_weight(torch.zeros((16, 40))), torch.zeros(40))
