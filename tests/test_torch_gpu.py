"""The port's hand kernels on the card against their plain versions.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one (the decision is made in the fixture, never at import). Run them
on a machine with a card: ``python -m pytest tests/test_torch_gpu.py -q``.

Tolerances as in chip_smoke.py: K1 rtol 1e-5 / atol 1e-5 (exact products,
f32 sums in another order); K2/K3 rtol 1e-5 / atol 5e-5 (f32 sums of up to
thousands of products in another order than cuBLAS)."""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("shape", [(9308, 6710, 64), (333, 517, 16), (70, 50, 32), (129, 2049, 32)])
def test_spmm_dual_kernel_matches_plain(cuda, store, shape):
    from diffmm_tpu_torch.ops.kernels.spmm_dual import (
        LAUNCHES, dense_storage, spmm_dual, spmm_dual_plain,
    )

    U, I, d = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    dense = torch.rand((U, I), generator=gen, device=cuda) < 0.05
    mat = dense.to(store) if U % 2 else dense_storage(U, I, store, cuda).copy_(dense)
    z_u = torch.randn((U, d), generator=gen, device=cuda)
    z_i = torch.randn((I, d), generator=gen, device=cuda)
    before = LAUNCHES["spmm_dual"]
    yu, yi = spmm_dual(mat, z_u, z_i)
    pu, pi = spmm_dual_plain(mat, z_u, z_i)
    torch.cuda.synchronize()
    assert LAUNCHES["spmm_dual"] == before + 1
    torch.testing.assert_close(yu, pu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(yi, pi, rtol=1e-5, atol=1e-5)


# (B, K, H): the rebuild's shape (K2 split four ways, 8-byte loads), then
# ragged ones with 4-, 2- and 1-float loads, split and unsplit
@pytest.mark.parametrize(
    "shape", [(1024, 6710, 1024), (7, 133, 48), (300, 1000, 64), (200, 2100, 96), (129, 1030, 64)]
)
def test_denoise_kernels_match_plain(cuda, shape):
    from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
        LAUNCHES, fused_denoise_mlp, layer1_plain, layer2_plain,
    )

    B, K, H = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((B, K), generator=gen, device=cuda)
    w1 = torch.randn((K, H), generator=gen, device=cuda) * (2.0 / (K + H)) ** 0.5
    tp = torch.randn((B, H), generator=gen, device=cuda) * 0.1
    w2 = torch.randn((H, K), generator=gen, device=cuda) * (2.0 / (K + H)) ** 0.5
    b2 = torch.randn((K,), generator=gen, device=cuda) * 0.01
    before = dict(LAUNCHES)
    got = fused_denoise_mlp(x, w1, tp, w2, b2)
    want = layer2_plain(layer1_plain(x, w1, tp), w2, b2)
    torch.cuda.synchronize()
    assert LAUNCHES["denoise_layer1"] == before["denoise_layer1"] + 1
    assert LAUNCHES["denoise_layer2"] == before["denoise_layer2"] + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from diffmm_tpu_torch.ops.kernels.spmm_dual import spmm_dual

    with pytest.raises(ValueError, match="width"):
        spmm_dual(torch.zeros((4, 3), dtype=torch.int8, device=cuda),
                  torch.zeros((4, 128), device=cuda), torch.zeros((3, 128), device=cuda))
    with pytest.raises(TypeError):
        spmm_dual(torch.zeros((4, 3), device=cuda),
                  torch.zeros((4, 16), device=cuda), torch.zeros((3, 16), device=cuda))
