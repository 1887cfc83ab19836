"""The port's hand kernels on the card against their plain versions.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one (the decision is made in the fixture, never at import). Run them
on a machine with a card: ``python -m pytest tests/test_torch_gpu.py -q``.

Tolerances as in chip_smoke.py: K1 rtol 1e-5 / atol 1e-5 (exact products,
f32 sums in another order; its backward, the same call on the cotangents,
too); K2/K3 rtol 1e-5 / atol 5e-5 (3xTF32 products
summed in another order than cuBLAS's f32 ones), and a max error against
float64 at most twice the plain f32 product's; K4 |kernel - plain| <= 1e-6
* sum|msgs| + 1e-6 per output element (the kernel sums each segment
in edge order, the plain version's index_add_ in the order its atomics land;
a reordered f32 sum moves by a few eps = 1.2e-7 of the sum of its terms'
magnitudes, which a hub segment of thousands of edges makes large). The
sparse form's backward on the card against the CPU's: rtol 1e-5 / atol 1e-5
(the same messages, summed in another order)."""

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
    yu2, yi2 = spmm_dual(mat, z_u, z_i)
    assert torch.equal(yu, yu2) and torch.equal(yi, yi2)  # no atomics on values


# (U, I): I under one block's 384 columns; U of one 128-row strip or less;
# I one column past 8 blocks (9 column blocks, so cluster groups); three
# blocks; U and I one past a strip and a block; 53 column blocks (several
# cluster groups, one row block); the tiktok shape
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("shape", [(100, 100), (128, 384), (70, 3073), (1000, 1100), (129, 385),
                                   (300, 20000), (9308, 6710)])
def test_spmm_dual_ragged_plans(cuda, store, d, shape):
    from diffmm_tpu_torch.ops.kernels.spmm_dual import dense_storage, plan, spmm_dual, spmm_dual_plain

    U, I = shape
    gen = torch.Generator(device=cuda).manual_seed(4)
    mat = dense_storage(U, I, store, cuda).copy_(torch.rand((U, I), generator=gen, device=cuda) < 0.1)
    z_u = torch.randn((U, d), generator=gen, device=cuda)
    z_i = torch.randn((I, d), generator=gen, device=cuda)
    got = spmm_dual(mat, z_u, z_i)
    again = spmm_dual(mat, z_u, z_i)
    want = spmm_dual_plain(mat, z_u, z_i)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert torch.equal(g, a)
    p = plan(U, I, d, "int8" if store == torch.int8 else "bf16", cuda)
    assert p.col_blocks % p.cluster == 0 and p.col_blocks * p.items >= I
    assert p.row_blocks * p.rows >= U and p.rows % 128 == 0


@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_spmm_dual_wide_catalog_in_chunks(cuda, store):
    """I past one wave of blocks: column chunks, each one launch."""
    from diffmm_tpu_torch.ops.kernels.spmm_dual import (
        LAUNCHES, dense_storage, max_items, spmm_dual, spmm_dual_plain)

    U, d = 200, 32
    I = max_items(d, "int8" if store == torch.int8 else "bf16", cuda) + 1000
    gen = torch.Generator(device=cuda).manual_seed(8)
    mat = dense_storage(U, I, store, cuda).copy_(torch.rand((U, I), generator=gen, device=cuda) < 0.05)
    z_u = torch.randn((U, d), generator=gen, device=cuda)
    z_i = torch.randn((I, d), generator=gen, device=cuda)
    before = LAUNCHES["spmm_dual"]
    got = spmm_dual(mat, z_u, z_i)
    assert LAUNCHES["spmm_dual"] == before + 2
    again = spmm_dual(mat, z_u, z_i)
    for g, a, w in zip(got, again, spmm_dual_plain(mat, z_u, z_i)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert torch.equal(g, a)


# K1 at the main paths' shapes: tiktok's (9,308 x 6,710) block in every storage
# and width, the model-axis shard's (9,308 x 3,355) columns, the dense demo's
# (60,000 x 15,000) rank block; each against the plain version, bitwise across
# launches, int4 bitwise int8 on the same cells (the plan does not depend on
# the storage)
def _k1_inputs(cuda, U, I, d, seed, density=0.001):
    from diffmm_tpu_torch.ops.kernels.spmm_dual import dense_storage, pack_int4

    gen = torch.Generator(device=cuda).manual_seed(seed)
    mask = torch.rand((U, I), generator=gen, device=cuda) < density
    mats = {store: dense_storage(U, I, store, cuda).copy_(pack_int4(mask) if store == torch.uint8 else mask)
            for store in (torch.int8, torch.bfloat16, torch.uint8)}
    z_u = torch.randn((U, d), generator=gen, device=cuda)
    z_i = torch.randn((I, d), generator=gen, device=cuda)
    return mats, z_u, z_i


@pytest.mark.parametrize("d", [16, 32, 64])
def test_spmm_dual_tiktok_shape_every_storage(cuda, d):
    from diffmm_tpu_torch.ops.kernels.spmm_dual import LAUNCHES, plan, spmm_dual, spmm_dual_plain

    U, I = 9308, 6710
    mats, z_u, z_i = _k1_inputs(cuda, U, I, d, seed=31)
    got = {}
    for store, mat in mats.items():
        before = LAUNCHES["spmm_dual"]
        got[store] = spmm_dual(mat, z_u, z_i)
        again = spmm_dual(mat, z_u, z_i)
        assert LAUNCHES["spmm_dual"] == before + 2
        for g, a, w in zip(got[store], again, spmm_dual_plain(mat, z_u, z_i)):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
            assert torch.equal(g, a)
    assert all(torch.equal(a, b) for a, b in zip(got[torch.uint8], got[torch.int8]))
    assert _layout(plan(U, I, d, "int4", cuda)) == _layout(plan(U, I, d, "int8", cuda))


@pytest.mark.parametrize("store", [torch.int8, torch.uint8], ids=["int8", "int4"])
def test_spmm_dual_model_axis_shard(cuda, store):
    """The model axis's (9,308 x 3,355) block, built in place from the whole
    edges as the mesh Coach builds it, forward and backward (one launch each)."""
    from diffmm_tpu_torch.ops.graph import build_dense_bi_adj_device
    from diffmm_tpu_torch.ops.kernels.spmm_dual import LAUNCHES, SpmmDual, spmm_dual, spmm_dual_plain

    U, I, d = 9308, 6710, 64
    gen = torch.Generator(device=cuda).manual_seed(32)
    edges = (torch.rand((U, I), generator=gen, device=cuda) < 0.001).nonzero()
    rows, cols = edges[:, 0].to(torch.int32), edges[:, 1].to(torch.int32)
    mat = build_dense_bi_adj_device(rows, cols, U, I, store, cols=(I // 2, I)).mat
    z_u = torch.randn((U, d), generator=gen, device=cuda, requires_grad=True)
    z_i = torch.randn((I - I // 2, d), generator=gen, device=cuda, requires_grad=True)
    got, again = spmm_dual(mat, z_u.detach(), z_i.detach()), spmm_dual(mat, z_u.detach(), z_i.detach())
    for g, a, w in zip(got, again, spmm_dual_plain(mat, z_u.detach(), z_i.detach())):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert torch.equal(g, a)
    g_u, g_i = torch.randn_like(z_u), torch.randn_like(z_i)
    outs = SpmmDual.apply(mat, z_u, z_i)
    before = LAUNCHES["spmm_dual"]
    grads = torch.autograd.grad(outs, (z_u, z_i), (g_u, g_i))
    assert LAUNCHES["spmm_dual"] == before + 1
    for g, w in zip(grads, spmm_dual_plain(mat, g_u, g_i)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_spmm_dual_dense_demo_block(cuda):
    """The dense demo's rank block: columns [15,000, 30,000) of a 60,000 x
    30,000 catalog at density 0.0015, int8, d 64."""
    from diffmm_tpu_torch.ops.graph import build_dense_bi_adj_device
    from diffmm_tpu_torch.ops.kernels.spmm_dual import LAUNCHES, spmm_dual, spmm_dual_plain

    U, I, d = 60_000, 30_000, 64
    gen = torch.Generator(device=cuda).manual_seed(33)
    flat = torch.unique(torch.randint(0, U * I, (int(U * I * 0.0015),), generator=gen, device=cuda))
    mat = build_dense_bi_adj_device((flat // I).to(torch.int32), (flat % I).to(torch.int32), U, I, torch.int8,
                                    cols=(I // 2, I)).mat
    del flat
    z_u = torch.randn((U, d), generator=gen, device=cuda)
    z_i = torch.randn((I - I // 2, d), generator=gen, device=cuda)
    before = LAUNCHES["spmm_dual"]
    got = spmm_dual(mat, z_u, z_i)
    assert LAUNCHES["spmm_dual"] == before + 1
    again = spmm_dual(mat, z_u, z_i)
    for g, a, w in zip(got, again, spmm_dual_plain(mat, z_u, z_i)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert torch.equal(g, a)


@pytest.mark.parametrize("store", [torch.int8, torch.uint8], ids=["int8", "int4"])
def test_spmm_dual_repeats_bitwise(cuda, store):
    """Fifty launches on the same inputs at tiktok's shape give the same bits:
    the cross-block sums take a fixed order, and every block's writes are
    seen by the grid before they are summed."""
    from diffmm_tpu_torch.ops.kernels.spmm_dual import spmm_dual

    mats, z_u, z_i = _k1_inputs(cuda, 9308, 6710, 64, seed=34)
    first = spmm_dual(mats[store], z_u, z_i)
    for _ in range(50):
        assert all(torch.equal(a, b) for a, b in zip(spmm_dual(mats[store], z_u, z_i), first))


# U and I off every multiple of the tiles (128 rows, 64 columns) and of the
# column blocks, packed int4 among them; a catalog wider than one launch
@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16, torch.uint8], ids=["int8", "bf16", "int4"])
@pytest.mark.parametrize("shape", [(1, 1), (127, 63), (257, 4097), (1001, 385), (4093, 2311)])
def test_spmm_dual_ragged_every_storage(cuda, store, shape):
    from diffmm_tpu_torch.ops.kernels.spmm_dual import dense_storage, pack_int4, spmm_dual, spmm_dual_plain

    U, I = shape
    gen = torch.Generator(device=cuda).manual_seed(35)
    mask = torch.rand((U, I), generator=gen, device=cuda) < 0.1
    mat = dense_storage(U, I, store, cuda).copy_(pack_int4(mask) if store == torch.uint8 else mask)
    z_u = torch.randn((U, 32), generator=gen, device=cuda)
    z_i = torch.randn((I, 32), generator=gen, device=cuda)
    got, again = spmm_dual(mat, z_u, z_i), spmm_dual(mat, z_u, z_i)
    for g, a, w in zip(got, again, spmm_dual_plain(mat, z_u, z_i)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert torch.equal(g, a)


def test_spmm_dual_wide_catalog_int4_in_chunks(cuda):
    """Packed int4 past one launch's columns: two launches, each chunk
    starting on a byte."""
    from diffmm_tpu_torch.ops.kernels.spmm_dual import (
        LAUNCHES, dense_storage, max_items, pack_int4, spmm_dual, spmm_dual_plain)

    U, d = 200, 32
    I = max_items(d, "int4", cuda) + 1001
    gen = torch.Generator(device=cuda).manual_seed(36)
    mask = torch.rand((U, I), generator=gen, device=cuda) < 0.05
    mat = dense_storage(U, I, torch.uint8, cuda).copy_(pack_int4(mask))
    z_u = torch.randn((U, d), generator=gen, device=cuda)
    z_i = torch.randn((I, d), generator=gen, device=cuda)
    before = LAUNCHES["spmm_dual"]
    got = spmm_dual(mat, z_u, z_i)
    assert LAUNCHES["spmm_dual"] == before + 2
    for g, w in zip(got, spmm_dual_plain(mat, z_u, z_i)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_spmm_dual_int8_values_are_exact(cuda):
    """Any int8 value of M, not only 0/1, converts exactly to bf16."""
    from diffmm_tpu_torch.ops.kernels.spmm_dual import dense_storage, spmm_dual, spmm_dual_plain

    U, I, d = 256, 512, 32
    gen = torch.Generator(device=cuda).manual_seed(5)
    mat = dense_storage(U, I, torch.int8, cuda)
    mat.copy_(torch.randint(-128, 128, (U, I), generator=gen, device=cuda, dtype=torch.int32))
    z_u = torch.randn((U, d), generator=gen, device=cuda)
    z_i = torch.randn((I, d), generator=gen, device=cuda)
    for g, w in zip(spmm_dual(mat, z_u, z_i), spmm_dual_plain(mat, z_u, z_i)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-2)


def _f64_gate(got, plain, exact) -> tuple[float, float]:
    """Max error against float64 of the kernel and of the plain f32 version;
    the kernel's may be at most twice the plain one's (plus 1e-7, about an
    ulp of the outputs, for shapes where both are exact)."""
    err_k = float((got.double() - exact).abs().max())
    err_p = float((plain.double() - exact).abs().max())
    assert err_k <= 2 * err_p + 1e-7, (err_k, err_p)
    return err_k, err_p


# (B, K, H): the rebuild's shapes at tiktok's and yelp's catalogs (K2 split
# two ways, K3 in 104-wide tiles at 6,710 and 128-wide unsplit ones at
# 20,000), paths B/D's batch 256, then ragged ones:
# B not a multiple of 64, K not a multiple of 32 (4-, 2- and 1-float loads
# of x, K 17 under one tile), N odd and under one tile, and N 250, whose
# last 104-wide tile holds 48 rows of the padded weight
@pytest.mark.parametrize(
    "shape",
    [(1024, 6710, 1024), (1024, 20000, 1024), (256, 6710, 1024), (7, 133, 48), (300, 1000, 64),
     (200, 2100, 96), (129, 1030, 64), (100, 17, 33), (65, 20000, 77), (130, 250, 64)],
)
def test_denoise_kernels_match_plain(cuda, shape):
    from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
        LAUNCHES, denoise_layer1, denoise_layer2, layer1_plain, layer2_plain,
        prepare_weight,
    )

    B, K, H = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((B, K), generator=gen, device=cuda)
    w1 = torch.randn((K, H), generator=gen, device=cuda) * (2.0 / (K + H)) ** 0.5
    tp = torch.randn((B, H), generator=gen, device=cuda) * 0.1
    w2 = torch.randn((H, K), generator=gen, device=cuda) * (2.0 / (K + H)) ** 0.5
    b2 = torch.randn((K,), generator=gen, device=cuda) * 0.01
    before = dict(LAUNCHES)
    got = denoise_layer2(denoise_layer1(x, w1, tp), w2, b2)  # weights prepared per call
    want = layer2_plain(layer1_plain(x, w1, tp), w2, b2)
    torch.cuda.synchronize()
    assert LAUNCHES["denoise_layer1"] == before["denoise_layer1"] + 1
    assert LAUNCHES["denoise_layer2"] == before["denoise_layer2"] + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)

    # each kernel on prepared weights, as the rebuild runs it: the plain
    # version's tolerance, the same bits on a second launch, the f64 gate
    w1p, w2p = prepare_weight(w1), prepare_weight(w2)
    h = denoise_layer1(x, w1p, tp)
    out = denoise_layer2(h, w2p, b2)
    h_plain, out_plain = layer1_plain(x, w1, tp), layer2_plain(h, w2, b2)
    torch.testing.assert_close(h, h_plain, rtol=1e-5, atol=5e-5)
    torch.testing.assert_close(out, out_plain, rtol=1e-5, atol=5e-5)
    assert torch.equal(h, denoise_layer1(x, w1p, tp))
    assert torch.equal(out, denoise_layer2(h, w2p, b2))
    _f64_gate(h, h_plain, torch.tanh(x.double() @ w1.double() + tp.double()))
    _f64_gate(out, out_plain, h.double() @ w2.double() + b2.double())


@pytest.mark.parametrize("shape", [(512, 64, 100000), (128, 64, 50000)], ids=["S", "S_sparse_demo_shard"])
def test_denoise_layer2_strip_form_at_web_scale(cuda, shape):
    """K3 at path S's shapes (B, H 64, N): the web-scale rebuild and the
    sparse demo's rank block, which take the strip form. Against the plain
    version within TOL, the f64 gate, the same bits on a second launch and
    the same bits as the gemm form (the same arithmetic, step for step)."""
    from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
        LAUNCHES, denoise_form, denoise_layer2, layer2_plain, prepare_weight,
    )

    B, H, N = shape
    assert denoise_form(H) == "strip"
    gen = torch.Generator(device=cuda).manual_seed(16)
    h = torch.tanh(torch.randn((B, H), generator=gen, device=cuda))
    w2 = torch.randn((H, N), generator=gen, device=cuda) * (2.0 / (H + N)) ** 0.5
    b2 = torch.randn((N,), generator=gen, device=cuda) * 0.001
    w2p = prepare_weight(w2)
    before = LAUNCHES["denoise_layer2"]
    out = denoise_layer2(h, w2p, b2)
    assert LAUNCHES["denoise_layer2"] == before + 1
    plain = layer2_plain(h, w2, b2)
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=5e-5)
    assert torch.equal(out, denoise_layer2(h, w2p, b2))
    assert torch.equal(out, denoise_layer2(h, w2p, b2, form="gemm"))
    _f64_gate(out, plain, h.double() @ w2.double() + b2.double())


# (B, K, N) with K at most 64 (the strip form): several strips and row
# tiles; B under one warpgroup's 64 rows; N % 4 != 0 (vector stores with a
# scalar head and tail a row) and N % 4 == 0 (bulk copies); K odd (A's
# 1-float loads) and K 32 and under (one slab); one strip's columns cut
# short
@pytest.mark.parametrize(
    "shape",
    [(7, 48, 133), (300, 64, 1000), (129, 64, 1030), (100, 33, 17), (130, 64, 250), (1000, 17, 3000),
     (257, 32, 4099), (64, 63, 513), (513, 64, 20000)],
)
def test_strip_form_matches_gemm_form(cuda, shape):
    """Each entry in the strip form against the gemm form on the same
    inputs, bitwise, and against its plain version within TOL; A also from
    a base 4 bytes past a 16-byte boundary (its 1-float loads)."""
    from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
        LAUNCHES, denoise_form, denoise_layer1, denoise_layer1_partial, denoise_layer2, layer1_plain,
        layer1_partial_plain, layer2_plain, prepare_weight,
    )

    B, K, N = shape
    assert denoise_form(K) == "strip"
    gen = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn((B, K), generator=gen, device=cuda)
    shifted = torch.empty(B * K + 1, device=cuda)[1:].view(B, K).copy_(x)
    w = torch.randn((K, N), generator=gen, device=cuda) * (2.0 / (K + N)) ** 0.5
    tp = torch.randn((B, N), generator=gen, device=cuda) * 0.1
    b = torch.randn((N,), generator=gen, device=cuda) * 0.01
    wp = prepare_weight(w)
    cases = (
        ("denoise_layer1", lambda a, f: denoise_layer1(a, wp, tp, f), layer1_plain(x, w, tp)),
        ("denoise_layer1_partial", lambda a, f: denoise_layer1_partial(a, wp, f), layer1_partial_plain(x, w)),
        ("denoise_layer2", lambda a, f: denoise_layer2(a, wp, b, f), layer2_plain(x, w, b)),
    )
    for name, kern, plain in cases:
        before = LAUNCHES[name]
        got = kern(x, None)
        assert LAUNCHES[name] == before + 1
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=5e-5)
        assert torch.equal(got, kern(x, "gemm")), name
        assert torch.equal(got, kern(shifted, None)), name


@pytest.mark.parametrize("K", [3355, 6710, 63])
def test_denoise_loads_at_any_alignment(cuda, K):
    """A's rows at every 4-byte offset from a 16-byte boundary (K 3,355: a
    1x2 mesh's shard of tiktok's catalog, odd; 6,710: the whole catalog;
    63: the strip form): the 1- and 2-float loads read the same floats as
    the wider ones, so every offset gives the same bits, in both forms."""
    from diffmm_tpu_torch.ops.kernels.denoise_mlp import denoise_layer1_partial, prepare_weight

    B, H = 300, 96
    gen = torch.Generator(device=cuda).manual_seed(18)
    x = torch.randn((B, K), generator=gen, device=cuda)
    wp = prepare_weight(torch.randn((K, H), generator=gen, device=cuda) * (2.0 / (K + H)) ** 0.5)
    want = denoise_layer1_partial(x, wp)
    for off in (1, 2, 3):
        moved = torch.empty(B * K + off, device=cuda)[off:].view(B, K).copy_(x)
        assert torch.equal(denoise_layer1_partial(moved, wp), want), off


def test_denoise_wrappers_reject_bad_prepared_weights(cuda):
    from diffmm_tpu_torch.ops.kernels.denoise_mlp import KernelWeight, denoise_layer1, prepare_weight

    x, tp = torch.randn((8, 70), device=cuda), torch.randn((8, 40), device=cuda)
    good = prepare_weight(torch.randn((70, 40), device=cuda))
    d = good.data
    with pytest.raises(TypeError, match="f32"):
        denoise_layer1(x, KernelWeight(d.double(), 70, 40), tp)
    with pytest.raises(ValueError, match="shape"):
        denoise_layer1(x, KernelWeight(d[:, :, :64], 70, 40), tp)
    with pytest.raises(ValueError, match="prepared for"):
        denoise_layer1(x, prepare_weight(torch.randn((71, 40), device=cuda)), tp)
    with pytest.raises(ValueError, match="layout"):
        strided = torch.zeros((*d.shape[:3], 2 * d.shape[3]), device=cuda)[..., ::2]
        denoise_layer1(x, KernelWeight(strided, 70, 40), tp)
    with pytest.raises(ValueError, match="is on cpu"):
        denoise_layer1(x, prepare_weight(torch.randn((70, 40))), tp)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from diffmm_tpu_torch.ops.kernels.spmm_dual import spmm_dual

    with pytest.raises(ValueError, match="width"):
        spmm_dual(torch.zeros((4, 3), dtype=torch.int8, device=cuda),
                  torch.zeros((4, 128), device=cuda), torch.zeros((3, 128), device=cuda))
    with pytest.raises(TypeError):
        spmm_dual(torch.zeros((4, 3), device=cuda),
                  torch.zeros((4, 16), device=cuda), torch.zeros((3, 16), device=cuda))


def segsum_close(got, want, msgs, offsets) -> bool:
    """K4's tolerance: the f32 summation order only, scaled by the sum of
    the magnitudes of each output's terms."""
    from diffmm_tpu_torch.ops.kernels.segsum import segsum_plain

    return bool(((got - want).abs() <= 1e-6 * segsum_plain(msgs.abs(), offsets) + 1e-6).all())


# (n, nnz, d, skew): the yelp-shape user and item directions and the stacked
# width, then ragged widths that take 1, 2 and 2 column tiles of the kernel
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape", [(38403, 307200, 64, 1.0), (20000, 307200, 64, 2.0), (38403, 307200, 128, 1.0),
              (50, 1000, 16, 2.0), (333, 4000, 300, 1.0), (7, 513, 257, 1.0)]
)
def test_segsum_kernel_matches_plain(cuda, dtype, shape):
    from chip_smoke import sorted_segment_ids
    from diffmm_tpu_torch.ops.kernels.segsum import LAUNCHES, segment_offsets, segsum, segsum_plain

    n, nnz, d, skew = shape
    gen = torch.Generator(device=cuda).manual_seed(2)
    ids = sorted_segment_ids(gen, n, nnz, 20, skew, cuda)
    msgs = torch.randn((nnz, d), generator=gen, device=cuda).to(dtype)
    msgs[-20:] = float("nan")  # the pads are never read
    offsets = segment_offsets(ids, n)
    before = LAUNCHES["segsum_unfused"]
    got = segsum(msgs, offsets)
    again = segsum(msgs, offsets)
    want = segsum_plain(msgs, offsets)
    torch.cuda.synchronize()
    assert LAUNCHES["segsum_unfused"] == before + 2  # the unfused entry counts apart
    assert torch.equal(got, again)  # no atomics: the same bits every run
    assert segsum_close(got, want, msgs, offsets), float((got - want).abs().max())
    empty = offsets.diff() == 0
    assert not got[empty].any()


def _offsets_of(counts, device):
    return torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(torch.tensor(counts), 0)]).to(device)


# segment edge counts (kernel pieces are 256 edges): one segment of every
# edge; segments straddling piece boundaries; fewer edges than a piece;
# runs of empty segments, at the start, inside, on piece boundaries and at
# the end; path C's rebuilt item layout (one hub of 38,389 of 307,200 edges)
@pytest.mark.parametrize("case", ["one_segment", "straddle", "under_a_piece", "empty_runs", "item_hub"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 300])
def test_segsum_split_cases(cuda, case, dtype, d):
    from diffmm_tpu_torch.ops.kernels.segsum import segsum, segsum_plain

    gen = torch.Generator().manual_seed(6)
    if case == "one_segment":
        counts = [3000]
    elif case == "straddle":
        counts = [100, 300, 256, 1, 511, 2, 254, 600, 7]
    elif case == "under_a_piece":
        counts = [3, 0, 50, 1, 0]
    elif case == "empty_runs":
        counts = [0, 0, 256, 0, 0, 0, 256, 0, 5, 0, 251, 0, 0, 300] + [0] * 10
    else:
        rest = torch.multinomial(torch.ones(19999), 307200 - 20 - 38389, replacement=True, generator=gen)
        counts = [38389] + torch.bincount(rest, minlength=19999).tolist()
    pads = 20
    offsets = _offsets_of(counts, cuda)
    nnz = int(offsets[-1]) + pads
    msgs = torch.randn((nnz, d), generator=gen).to(dtype).to(cuda)
    msgs[nnz - pads:] = float("nan")  # the pads are never read
    got = segsum(msgs, offsets)
    again = segsum(msgs, offsets)
    want = segsum_plain(msgs, offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert segsum_close(got, want, msgs, offsets), float((got - want).abs().max())
    assert not got[offsets.diff() == 0].any()


def test_segsum_rejects_what_the_kernel_does_not_take(cuda):
    from diffmm_tpu_torch.ops.kernels.segsum import segsum

    with pytest.raises(TypeError):
        segsum(torch.zeros((4, 8), dtype=torch.int32, device=cuda), torch.zeros(3, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="offsets"):
        segsum(torch.zeros((4, 8), device=cuda), torch.zeros(3, dtype=torch.int32, device=cuda))


def test_segsum_cuts_offsets_to_the_messages(cuda):
    """Boundaries outside [0, nnz] read no row outside msgs, on the card
    as in the plain version."""
    from diffmm_tpu_torch.ops.kernels.segsum import segsum, segsum_plain

    msgs = torch.randn((6, 40), device=cuda)
    offsets = torch.tensor([-3, 2, 2, 5, 9], dtype=torch.int64, device=cuda)
    got = segsum(msgs, offsets)
    want = torch.stack([msgs[0:2].sum(0), torch.zeros(40, device=cuda), msgs[2:5].sum(0), msgs[5:6].sum(0)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(segsum_plain(msgs, offsets), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- K4 fused
# segsum_gather: the rows each edge names, summed per segment in one launch;
# at F's shapes (yelp, 307,200 edges, d 64) against its plain version within
# K4's rule, bitwise the unfused route it replaces (index_select, then the
# unfused K4 on the messages) and bitwise across two calls.


def _unfused_route(tables, srcs, offsets):
    """index_select of each modality's rows (a zero row for an index past
    the table), side by side, then K4 on the (nnz, M·d) messages."""
    from diffmm_tpu_torch.ops.kernels.segsum import segsum

    R, d = tables.shape[1:]
    msgs = [torch.cat([t, t.new_zeros((1, d))]).index_select(0, s.clamp(0, R)) for t, s in zip(tables, srcs)]
    return segsum(torch.cat(msgs, dim=1), offsets)


def _fused_case(cuda, case, dtype, gen):
    """(table, src, offsets) of one K4 case at F's shapes: the user and item
    directions, a rebuilt graph's item hub, two modalities stacked, and a
    backward's cotangent whose indices past the table read zero rows."""
    from chip_smoke import hub_segment_ids, sorted_segment_ids
    from diffmm_tpu_torch.ops.kernels.segsum import segment_offsets

    U, I, nnz = 38403, 20000, 307200
    n, R, M = {"user": (U, I, 1), "item": (I, U, 1), "item_hub": (I, U, 1), "stacked": (U, I, 2),
               "zero_rows": (I, U, 3)}[case]
    ids = (hub_segment_ids(gen, n, nnz, 20, 38389, cuda) if case == "item_hub"
           else sorted_segment_ids(gen, n, nnz, 20, 2.0 if case == "item" else 1.0, cuda))
    offsets = segment_offsets(ids, n)
    srcs = [torch.randint(0, R, (nnz,), generator=gen, device=cuda).to(torch.int32) for _ in range(M)]
    if case == "zero_rows":  # a tenth of the edges name the row past the table, or further
        for s in srcs:
            s[::10] = R + torch.randint(0, 3, (s[::10].shape[0],), generator=gen, device=cuda).to(torch.int32)
    for s in srcs:
        s[-20:] = R  # the pads
    tables = torch.randn((M, R, 64), generator=gen, device=cuda).to(dtype)
    return tables, srcs, offsets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["user", "item", "item_hub", "stacked", "zero_rows"])
def test_segsum_gather_matches_plain_and_the_unfused_route(cuda, case, dtype):
    from diffmm_tpu_torch.ops.kernels.segsum import LAUNCHES, segsum_gather, segsum_gather_plain

    gen = torch.Generator(device=cuda).manual_seed(11)
    tables, srcs, offsets = _fused_case(cuda, case, dtype, gen)
    table, src = (tables[0], srcs[0]) if len(srcs) == 1 else (tables, srcs)
    before = dict(LAUNCHES)
    got = segsum_gather(table, src, offsets)
    again = segsum_gather(table, src, offsets)
    assert {k: v - before[k] for k, v in LAUNCHES.items()} == {"segsum": 2, "segsum_unfused": 0}
    want = segsum_gather_plain(table, src, offsets)
    scale = segsum_gather_plain(table.abs(), src, offsets)
    unfused = _unfused_route(tables, srcs, offsets)
    torch.cuda.synchronize()
    assert got.shape == (offsets.numel() - 1, len(srcs) * 64) and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-6 * scale + 1e-6).all()), float((got - want).abs().max())
    assert torch.equal(got, again)
    assert torch.equal(got, unfused)
    assert not got[offsets.diff() == 0].any()


# widths of one to eight columns a lane, a table whose address allows only
# one-element loads, and ragged widths
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,M,shift", [(8, 1, 0), (16, 3, 0), (64, 4, 0), (64, 1, 1), (130, 2, 0),
                                       (257, 1, 0), (300, 2, 0), (4096, 1, 0)])
def test_segsum_gather_widths(cuda, dtype, d, M, shift):
    from chip_smoke import sorted_segment_ids
    from diffmm_tpu_torch.ops.kernels.segsum import segment_offsets, segsum_gather, segsum_gather_plain

    gen = torch.Generator(device=cuda).manual_seed(12)
    n, R, nnz = 333, 517, 4000
    offsets = segment_offsets(sorted_segment_ids(gen, n, nnz, 7, 2.0, cuda), n)
    srcs = [torch.randint(0, R + 3, (nnz,), generator=gen, device=cuda).to(torch.int32) for _ in range(M)]
    flat = torch.randn((M * R * d + shift,), generator=gen, device=cuda).to(dtype)
    tables = flat[shift:].view(M, R, d)
    table, src = (tables[0], srcs[0]) if M == 1 else (tables, srcs)
    got = segsum_gather(table, src, offsets)
    again = segsum_gather(table, src, offsets)
    want = segsum_gather_plain(table, src, offsets)
    scale = segsum_gather_plain(table.abs(), src, offsets)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-6 * scale + 1e-6).all())
    assert torch.equal(got, again)
    assert torch.equal(got, _unfused_route(tables, srcs, offsets))


def test_segsum_gather_refuses_what_the_kernel_does_not_take(cuda):
    from diffmm_tpu_torch.ops.kernels.segsum import MAX_MODAL, segsum_gather

    table = torch.zeros((4, 8), device=cuda)
    offsets = torch.tensor([0, 3, 6], device=cuda)
    src = torch.zeros(6, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        segsum_gather(table, src.long(), offsets)
    with pytest.raises(ValueError, match="one device"):
        segsum_gather(table.cpu(), src, offsets)
    with pytest.raises(ValueError, match="one device"):
        segsum_gather(table, src, offsets.cpu())
    with pytest.raises(ValueError, match="offsets"):
        segsum_gather(table, src, offsets.to(torch.int32))
    M = MAX_MODAL + 1
    with pytest.raises(ValueError, match=f"1 to {MAX_MODAL}"):
        segsum_gather(torch.zeros((M, 4, 8), device=cuda), [src] * M, offsets)


def test_sparse_form_gathers_no_messages_on_the_card(cuda, monkeypatch):
    """Forward and backward of both sparse propagations (and a loss gather's
    backward) on the card: K4 launches only through the fused entry, and no
    index_select of per-edge messages runs."""
    from diffmm_tpu_torch.ops import gather as og
    from diffmm_tpu_torch.ops.graph import spmm_bi, spmm_bi_modal_stacked
    from diffmm_tpu_torch.ops.kernels.segsum import LAUNCHES

    main, modal = _sparse_graphs(cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    leaves = [torch.randn(s, generator=gen, device=cuda).requires_grad_()
              for s in ((500, 64), (300, 64), (300, 64), (300, 64))]
    idx = torch.randint(0, 500, (64,), generator=gen, device=cuda).to(torch.int32)
    plan = og.gather_plan(idx, 500)
    selected = []
    real = torch.Tensor.index_select

    def spy(self, dim, index):
        selected.append(tuple(self.shape))
        return real(self, dim, index)

    before = dict(LAUNCHES)
    monkeypatch.setattr(torch.Tensor, "index_select", spy)
    outs = (*spmm_bi(main, leaves[0], leaves[1]), *spmm_bi_modal_stacked(modal, leaves[0], leaves[2:]))
    loss = sum((y * y).sum() for y in outs)
    torch.autograd.backward(loss)
    monkeypatch.undo()
    (g,) = torch.autograd.grad(og.gather(leaves[0], idx, plan).sum(), leaves[0])
    torch.cuda.synchronize()
    assert not selected, selected
    # 2 + 1 stacked + 2 item directions forward, 2 + 2 + 1 backward, 1 gather backward
    assert {k: v - before[k] for k, v in LAUNCHES.items()} == {"segsum": 11, "segsum_unfused": 0}
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_sparse_propagation_on_the_card_matches_the_cpu(cuda, compute):
    from diffmm_tpu_torch.ops.graph import build_bi_adj_device, spmm_bi, spmm_bi_modal_stacked

    U, I, d, nnz, M = 500, 300, 64, 4000, 2
    gen = torch.Generator().manual_seed(3)
    flat = torch.sort(torch.randperm(U * I, generator=gen)[:nnz]).values
    rows = torch.cat([flat // I, torch.full((16,), U)]).to(torch.int32)
    cols = [torch.cat([torch.randint(0, I // 2, (nnz,), generator=gen), torch.full((16,), I)]).to(torch.int32)
            for _ in range(M)]
    x_u = torch.randn((U, d), generator=gen)
    feats = [torch.randn((I, d), generator=gen) for _ in range(M)]
    outs = {}
    for dev in ("cpu", cuda):
        adjs = [build_bi_adj_device(rows.to(dev), c.to(dev), U, I) for c in cols]
        outs[str(dev)] = [t.cpu() for t in (
            *spmm_bi(adjs[0], x_u.to(dev), feats[0].to(dev), compute),
            *spmm_bi_modal_stacked(adjs, x_u.to(dev), [f.to(dev) for f in feats], compute),
        )]
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# K1's backward: autograd through SpmmDual launches the same kernel with the
# cotangents in place of z (one launch a backward call)
@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("shape", [(9308, 6710, 64), (333, 517, 16), (129, 2049, 32)])
def test_spmm_dual_backward_matches_plain(cuda, store, shape):
    from diffmm_tpu_torch.ops.kernels.spmm_dual import (
        LAUNCHES, SpmmDual, dense_storage, spmm_dual_plain,
    )

    U, I, d = shape
    gen = torch.Generator(device=cuda).manual_seed(4)
    mat = dense_storage(U, I, store, cuda).copy_(torch.rand((U, I), generator=gen, device=cuda) < 0.05)
    z_u = torch.randn((U, d), generator=gen, device=cuda, requires_grad=True)
    z_i = torch.randn((I, d), generator=gen, device=cuda, requires_grad=True)
    g_u = torch.randn((U, d), generator=gen, device=cuda)
    g_i = torch.randn((I, d), generator=gen, device=cuda)
    outs = SpmmDual.apply(mat, z_u, z_i)
    before = LAUNCHES["spmm_dual"]
    got = torch.autograd.grad(outs, (z_u, z_i), (g_u, g_i), retain_graph=True)
    again = torch.autograd.grad(outs, (z_u, z_i), (g_u, g_i), retain_graph=True)
    torch.cuda.synchronize()
    assert LAUNCHES["spmm_dual"] == before + 2
    want = spmm_dual_plain(mat, g_u, g_i)  # (M @ g_i, Mᵀ @ g_u)
    for a, b, c in zip(got, want, again):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        assert torch.equal(a, c)


def test_spmm_dual_backward_takes_odd_cotangents(cuda):
    """A cotangent that arrives non-contiguous, or as zeros for an output the
    loss does not use, goes through the kernel like any other."""
    from diffmm_tpu_torch.ops.kernels.spmm_dual import SpmmDual, dense_storage, spmm_dual_plain

    U, I, d = 300, 700, 32
    gen = torch.Generator(device=cuda).manual_seed(5)
    mat = dense_storage(U, I, torch.int8, cuda).copy_(torch.rand((U, I), generator=gen, device=cuda) < 0.1)
    z_u = torch.randn((U, d), generator=gen, device=cuda, requires_grad=True)
    z_i = torch.randn((I, d), generator=gen, device=cuda, requires_grad=True)
    y_u, y_i = SpmmDual.apply(mat, z_u, z_i)
    w = torch.randn((d, U), generator=gen, device=cuda)
    (y_u * w.T).sum().backward()  # a transposed cotangent; y_i unused
    want_u, want_i = spmm_dual_plain(mat, w.T.contiguous(), torch.zeros((I, d), device=cuda))
    torch.testing.assert_close(z_u.grad, want_u, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(z_i.grad, want_i, rtol=1e-5, atol=1e-5)


def _sparse_graphs(device, U=500, I=300, nnz=4000, M=2):
    from diffmm_tpu_torch.ops.graph import build_bi_adj_device

    gen = torch.Generator().manual_seed(3)
    flat = torch.sort(torch.randperm(U * I, generator=gen)[:nnz]).values
    rows = torch.cat([flat // I, torch.full((16,), U)]).to(torch.int32)
    main = torch.cat([flat % I, torch.full((16,), I)]).to(torch.int32)
    cols = [torch.cat([torch.randint(0, I // 2, (nnz,), generator=gen), torch.full((16,), I)]).to(torch.int32)
            for _ in range(M)]
    cols[0][: nnz // 2] = 7  # a hub of 2,000 edges in the first modality
    return (build_bi_adj_device(rows.to(device), main.to(device), U, I),
            [build_bi_adj_device(rows.to(device), c.to(device), U, I) for c in cols])


# K4 in the backward of the sparse form's three Functions: the card's
# gradients against the CPU's (plain versions), the K4 launches a backward
# call, bits repeated
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_sparse_backward_on_the_card_matches_the_cpu(cuda, compute):
    from diffmm_tpu_torch.ops.graph import spmm_bi, spmm_bi_modal_stacked
    from diffmm_tpu_torch.ops.kernels.segsum import LAUNCHES

    U, I, d, M = 500, 300, 64, 2
    gen = torch.Generator().manual_seed(8)
    x_u, x_i = torch.randn((U, d), generator=gen), torch.randn((I, d), generator=gen)
    feats = [torch.randn((I, d), generator=gen) for _ in range(M)]
    g = [torch.randn(s, generator=gen) for s in ((U, d), (I, d), (M, U, d), (M, I, d))]
    grads = {}
    for dev in ("cpu", cuda):
        main, modal = _sparse_graphs(dev)
        leaves = [t.to(dev).requires_grad_() for t in (x_u, x_i, *feats)]
        outs = (*spmm_bi(main, leaves[0], leaves[1], compute),
                *spmm_bi_modal_stacked(modal, leaves[0], leaves[2:], compute))
        cots = [t.to(dev) for t in g]
        before = LAUNCHES["segsum"]
        got = torch.autograd.grad(outs, leaves, cots, retain_graph=True)
        launched = LAUNCHES["segsum"] - before
        if dev != "cpu":
            # 2 for spmm_bi, M for the stacked user direction, 1 wide for the
            # item directions
            assert launched == 2 + M + 1
            again = torch.autograd.grad(outs, leaves, cots)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
        grads[str(dev)] = [t.cpu() for t in got]
    for a, b in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_backward_launches_on_the_current_stream(cuda):
    """Forward and backward of both forms on a side stream give the bits of
    the default stream's run: every launch takes the current stream."""
    from diffmm_tpu_torch.ops.graph import build_dense_bi_adj_device, spmm_bi

    main, _ = _sparse_graphs(cuda)
    dense = build_dense_bi_adj_device(main.ui_rows, main.ui_cols, 500, 300)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x_u = torch.randn((500, 64), generator=gen, device=cuda)
    x_i = torch.randn((300, 64), generator=gen, device=cuda)

    def run():
        leaves = [x_u.clone().requires_grad_(), x_i.clone().requires_grad_()]
        loss = sum((y * y).sum() for adj in (main, dense) for y in spmm_bi(adj, *leaves))
        loss.backward()
        return [t.grad for t in leaves]

    want = run()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------- training
# C1 (ROADMAP.md): the joint step's loss gathers reduce their gradients with
# K4, so a step repeats bit for bit; the phases' captured CUDA graphs replay
# the eager steps bit for bit; a fused chunk equals its single epochs.


def test_gather_backward_is_k4_and_repeats(cuda):
    """The gather's backward: one K4 launch, equal to segsum_plain on the
    same sorted cotangent (K4's tolerance), bitwise across two calls."""
    from diffmm_tpu_torch.ops.gather import gather, gather_plan
    from diffmm_tpu_torch.ops.kernels.segsum import LAUNCHES, segsum_plain

    gen = torch.Generator(device=cuda).manual_seed(3)
    table = torch.randn((9308, 64), generator=gen, device=cuda).requires_grad_()
    idx = torch.randint(0, 9308, (1024,), generator=gen, device=cuda).to(torch.int32)
    idx[:300] = 17  # a segment longer than one 256-edge piece
    g = torch.randn((1024, 64), generator=gen, device=cuda)
    plan = gather_plan(idx, 9308)
    out = gather(table, idx, plan)
    before = LAUNCHES["segsum"]
    got = torch.autograd.grad(out, table, g, retain_graph=True)[0]
    again = torch.autograd.grad(out, table, g)[0]
    assert LAUNCHES["segsum"] - before == 2
    want = segsum_plain(g[plan.perm], plan.offsets)
    scale = segsum_plain(g[plan.perm].abs(), plan.offsets)
    assert torch.equal(got, again)
    assert bool(((got - want).abs() <= 1e-6 * scale + 1e-6).all())
    assert torch.equal(out, table.detach()[idx.long()])


def _tiny_coach(cuda, form, **train):
    from diffmm_tpu_torch.config import Config
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.train.coach import Coach

    cfg = Config()
    cfg.base.seed, cfg.base.latdim, cfg.base.denoise_dim = 7, 16, "[64]"
    cfg.train.batch, cfg.train.test_batch, cfg.train.graph_form = 64, 64, form
    for key, value in train.items():
        setattr(cfg.train, key, value)
    host = make_synthetic_host_data(cfg, user_num=300, item_num=200, density=0.05, seed=5)
    return Coach(cfg, host, device=cuda)


def _snapshot(coach):
    from diffmm_tpu_torch.utils.checkpoint import rng_state_to_json, to_host

    return to_host(coach._ckpt_arrays()), {
        "gcn_count": coach.gcn_opt_state.count, "dn_counts": [s.count for s in coach.dn_opt_states],
        "np_rng": rng_state_to_json(coach.np_rng), "best_snapshot_epoch": -1,
    }


def _state(coach):
    from diffmm_tpu_torch.train.optim import tree_leaves

    out = tree_leaves(coach.gcn_params) + tree_leaves(coach.dn_params)
    for s in (coach.gcn_opt_state, *coach.dn_opt_states):
        out += s.mu + s.nu
    return [t.clone() for t in out] + [coach.generator.get_state()]


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_joint_block_repeats_bitwise(cuda, form):
    from diffmm_tpu_torch.ops.kernels import launch_counts
    from diffmm_tpu_torch.train import steps

    coach = _tiny_coach(cuda, form)
    coach.rebuild_graphs()
    arrays, aux = _snapshot(coach)
    gen = torch.Generator(device=cuda).manual_seed(1)
    block = [torch.randint(0, n, (64,), generator=gen, device=cuda).to(torch.int32)
             for n in (300, 200, 200)]
    runs = []
    for _ in range(2):
        coach._load_state(arrays, aux)
        before = launch_counts()
        metrics = steps.joint_block(coach.gcn_params, coach.gcn_opt_state, coach.data.adj,
                                    coach.modal_adjs, coach.data.raw_feats, *block, 1e-3, coach.hp(),
                                    coach.config.base.cl_method, generator=coach.generator)
        torch.cuda.synchronize()
        runs.append([metrics, *_state(coach)])
        launched = launch_counts()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    # 19 K4 launches of the loss gathers (M = 3), and the propagations', all fused
    want = {"segsum": 19 + (0 if form == "dense" else 2 * 12), "spmm_dual": 2 * 7 if form == "dense" else 0,
            "segsum_unfused": 0}
    assert {k: launched[k] - before[k] for k in want} == want


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_graph_replay_equals_eager(cuda, form):
    """After two epochs (every phase captured), one block of each phase
    replayed from its graph against the same step run eagerly, from one
    saved state: parameters, Adam moments, generator and the phase's
    accumulators or tables, bitwise."""
    coach = _tiny_coach(cuda, form)
    coach.total_epochs = 3
    for epoch in range(2):
        coach.train_epoch(epoch)
    arrays, aux = _snapshot(coach)
    for phase in ("joint", "diffusion", "rebuild"):
        graph = coach.graphs.find(phase)[0]
        assert graph.replays > 0
        inputs = [x.clone() for x in graph.inputs]
        results = []
        outputs = [b for key, b in coach.graphs._buffers.items()
                   if key[0] in ("diffusion_acc", "joint_acc", "rebuild_table")]
        for run in (graph, graph.step):
            coach._load_state(arrays, aux)
            for buf in outputs:
                buf.zero_()
            run(*inputs)
            torch.cuda.synchronize()
            results.append(_state(coach) + [b.clone() for b in outputs])
        assert all(torch.equal(a, b) for a, b in zip(*results)), phase


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_fused_chunk_equals_single_epochs_on_the_card(cuda, form):
    from diffmm_tpu_torch.train.optim import tree_leaves

    single = _tiny_coach(cuda, form, tstEpoch=1)
    fused = _tiny_coach(cuda, form, tstEpoch=1)
    single.total_epochs = fused.total_epochs = 2
    want, want_eval = [], []
    for epoch in range(2):
        want.append(single.train_epoch(epoch))
        want_eval.append(single.test_epoch())
    got, got_eval, _ = fused.train_epochs_fused(0, 2, "test")
    assert got == want and got_eval == want_eval
    assert torch.equal(single.generator.get_state(), fused.generator.get_state())
    for a, b in zip(tree_leaves(single.gcn_params) + single.edge_buffers,
                    tree_leaves(fused.gcn_params) + fused.edge_buffers):
        assert torch.equal(a, b)


def test_capture_failure_raises(cuda):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, nothing falls back to eager."""
    from diffmm_tpu_torch.train.graphs import BlockGraph

    gen = torch.Generator(device=cuda).manual_seed(0)
    acc = []
    graph = BlockGraph(lambda x: acc.append(float(x.sum())), gen, torch.cuda.Stream(cuda))
    with pytest.raises(RuntimeError):
        graph(torch.ones(4, device=cuda))
    assert graph.graph is None


# ---------------------------------------------------------------- int4, KNN, HTTP
def _layout(p):
    return (p.cluster, p.col_blocks, p.row_blocks, p.rows, p.groups)


# (U, I): odd I under one block; I under one block; U of one 128-row strip;
# U and I one past a strip and a block; odd I past 8 blocks; the tiktok shape
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("shape", [(100, 101), (300, 200), (128, 385), (129, 385), (70, 3073),
                                   (9308, 6710)])
def test_spmm_dual_int4_matches_plain_and_int8(cuda, d, shape):
    """K1 on packed int4 M: within TOL of the plain version, bitwise across
    launches, bitwise against the int8 launch on the same cells where the
    two plans agree (the same bf16 tiles and sums), forward and backward
    (``SpmmDual``)."""
    from diffmm_tpu_torch.ops.kernels.spmm_dual import (
        LAUNCHES, SpmmDual, dense_storage, pack_int4, plan, spmm_dual, spmm_dual_plain)

    U, I = shape
    gen = torch.Generator(device=cuda).manual_seed(12)
    mask = torch.rand((U, I), generator=gen, device=cuda) < 0.08
    m4 = dense_storage(U, I, torch.uint8, cuda).copy_(pack_int4(mask))
    m8 = dense_storage(U, I, torch.int8, cuda).copy_(mask)
    z_u = torch.randn((U, d), generator=gen, device=cuda)
    z_i = torch.randn((I, d), generator=gen, device=cuda)
    before = LAUNCHES["spmm_dual"]
    got, again = spmm_dual(m4, z_u, z_i), spmm_dual(m4, z_u, z_i)
    assert LAUNCHES["spmm_dual"] == before + 2
    want = spmm_dual_plain(m4, z_u, z_i)
    by8 = spmm_dual(m8, z_u, z_i)
    same_plan = _layout(plan(U, I, d, "int4", cuda)) == _layout(plan(U, I, d, "int8", cuda))
    torch.cuda.synchronize()
    for g, a, w, e in zip(got, again, want, by8):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert torch.equal(g, a)
        if same_plan:
            assert torch.equal(g, e)
    zu, zi = z_u.clone().requires_grad_(), z_i.clone().requires_grad_()
    g_u = torch.randn((U, d), generator=gen, device=cuda)
    g_i = torch.randn((I, d), generator=gen, device=cuda)
    grads = torch.autograd.grad(SpmmDual.apply(m4, zu, zi), (zu, zi), (g_u, g_i))
    for g, w in zip(grads, spmm_dual_plain(m4, g_u, g_i)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_spmm_dual_int4_values_are_exact(cuda):
    """Any signed int4 value of M, not only 0/1, converts exactly to bf16."""
    from diffmm_tpu_torch.ops.kernels.spmm_dual import dense_storage, pack_int4, spmm_dual, spmm_dual_plain

    U, I, d = 256, 513, 32
    gen = torch.Generator(device=cuda).manual_seed(6)
    cells = torch.randint(-8, 8, (U, I), generator=gen, device=cuda, dtype=torch.int32)
    mat = dense_storage(U, I, torch.uint8, cuda).copy_(pack_int4(cells))
    z_u = torch.randn((U, d), generator=gen, device=cuda)
    z_i = torch.randn((I, d), generator=gen, device=cuda)
    for g, w in zip(spmm_dual(mat, z_u, z_i), spmm_dual_plain(mat, z_u, z_i)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-2)


def test_int4_refill_inside_a_captured_graph(cuda):
    """``set_edge_buffers`` refills a packed int4 block in place on a Coach
    whose joint step is captured: the same pointer, and a replay of the step
    equals the eager step bitwise on the new graphs."""
    coach = _tiny_coach(cuda, "dense", dense_store="int4")
    coach.total_epochs = 3
    for epoch in range(2):
        coach.train_epoch(epoch)
    adj = coach.modal_adjs[0]
    ptr = adj.mat.data_ptr()
    coach.rebuild_graphs()  # a new graph, into the same storage
    assert coach.modal_adjs[0] is adj and adj.mat.data_ptr() == ptr and adj.mat.dtype == torch.uint8
    arrays, aux = _snapshot(coach)
    graph = coach.graphs.find("joint")[0]
    inputs = [x.clone() for x in graph.inputs]
    acc = [b for key, b in coach.graphs._buffers.items() if key[0] == "joint_acc"]
    results = []
    for run in (graph, graph.step):
        coach._load_state(arrays, aux)
        for b in acc:
            b.zero_()
        run(*inputs)
        torch.cuda.synchronize()
        results.append(_state(coach) + [b.clone() for b in acc])
    assert all(torch.equal(a, b) for a, b in zip(*results))


def test_knn_edges_on_the_card_match_plain(cuda):
    """The KNN graphs on the card (K4 prototypes) against the same function
    on the CPU (plain segment sums): prototypes within K4's rule, each
    user's top-k set equal outside similarity ties of 1e-5."""
    from diffmm_tpu_torch.ops.knn import knn_edges, knn_prototypes
    from diffmm_tpu_torch.ops.losses import l2_normalize

    coach = _tiny_coach(cuda, "dense")
    rows, cols = coach.data.train_rows, coach.data.train_cols
    U, topk = coach.host.user_num, 10
    for feats in coach.data.raw_feats:
        got = knn_prototypes(rows, cols, feats, U)
        want = knn_prototypes(rows.cpu(), cols.cpu(), feats.cpu(), U)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
        _, g_cols = knn_edges(rows, cols, feats, U, topk)
        _, w_cols = knn_edges(rows.cpu(), cols.cpu(), feats.cpu(), U, topk)
        sim = l2_normalize(want, dim=1) @ l2_normalize(feats.cpu(), dim=1).T
        kth = torch.topk(sim, topk, dim=1).values[:, -1]
        for u, (a, b) in enumerate(zip(g_cols.cpu().view(U, topk).tolist(), w_cols.view(U, topk).tolist())):
            for item in set(a) ^ set(b):
                assert abs(float(sim[u, item] - kth[u])) <= 1e-5, (u, item)


def test_http_server_on_the_card(cuda, tmp_path):
    """The HTTP front end over an index on the card: every answer equals a
    direct ``recommend`` (ids and scores bitwise), each request on its own
    handler thread."""
    import json
    import threading
    import urllib.request

    from diffmm_tpu_torch.eval import serve_http, serving

    coach = _tiny_coach(cuda, "dense")
    coach.train_epoch(0)
    path = str(tmp_path / "idx.npz")
    serving.save_index(serving.build_index(coach), path)
    index = serving.load_index(path)
    assert index.u_final.is_cuda
    srv = serve_http.make_server(index, "127.0.0.1", 0, warmup_ks=[20])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    for user in range(0, 300, 37):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/recommend?user={user}&k=20") as r:
            body = json.loads(r.read())
        ids, scores = serving.recommend(index, torch.tensor([user], device=cuda), 20)
        assert body["items"] == ids[0].tolist() and body["scores"] == scores[0].tolist()
    srv.shutdown()
    srv.server_close()
    thread.join()


# ------------------------------------------------------------------ the mesh
# On the card the mesh runs in spawned ranks (parallel/launch.py): NCCL at
# world size 1 (the one card), gloo for two ranks that share it. Each rank
# function below is module-level, so the spawned process finds it here.
def _mesh_config(form):
    from diffmm_tpu_torch.config import Config

    cfg = Config()
    cfg.base.seed = 7
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.train.batch = 64
    cfg.train.test_batch = 64
    cfg.train.graph_form = form
    cfg.hyper.steps = 5
    return cfg


def _mesh_coach(form, mesh, **kwargs):
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.train.coach import Coach

    cfg = _mesh_config(form)
    host = make_synthetic_host_data(cfg, user_num=300, item_num=200, seed=3)
    return Coach(cfg, host, device=torch.device("cuda", torch.cuda.current_device()), mesh=mesh, **kwargs)


def _coach_state(coach):
    from diffmm_tpu_torch.train.optim import tree_leaves

    out = tree_leaves(coach.gcn_params) + tree_leaves(coach.dn_params) + list(coach.edge_buffers)
    for s in (coach.gcn_opt_state, *coach.dn_opt_states):
        out += s.mu + s.nu
    return [t.detach().cpu() for t in out]


def _mesh_form_bitwise():
    """World size 1 under NCCL: K4's mesh form and the three Functions on a
    mesh, forward and backward, against the unsharded calls."""
    import torch.distributed as dist

    from diffmm_tpu_torch.ops.graph import spmm_bi, spmm_bi_modal_stacked
    from diffmm_tpu_torch.ops.kernels.segsum import segsum_gather
    from diffmm_tpu_torch.parallel import make_mesh
    from diffmm_tpu_torch.parallel.segsum import sharded_segsum_gather
    from diffmm_tpu_torch.parallel.sharding import edge_shard

    coach = _mesh_coach("sparse", None)
    coach.rebuild_graphs()
    shard = edge_shard(make_mesh(1, 1))
    adj, modal = coach.data.adj, coach.modal_adjs
    gen = torch.Generator(device=coach.device).manual_seed(3)
    z = torch.randn((adj.item_num, 16), generator=gen, device=coach.device)
    nnz = adj.ui_cols.shape[0]
    out = {"forward": torch.equal(sharded_segsum_gather(z, adj.ui_cols, adj.ui_offsets, 0, nnz, dist.group.WORLD),
                                  segsum_gather(z, adj.ui_cols, adj.ui_offsets))}
    grads = []
    for sh in (None, shard):
        a = adj._replace(shard=sh)
        ms = [m._replace(shard=sh) for m in modal]
        ms = [ms[0]] + [m._replace(ui_rows=ms[0].ui_rows) for m in ms[1:]]
        x_u = coach.gcn_params["u_embs"].detach().clone().requires_grad_()
        x_i = coach.gcn_params["i_embs"].detach().clone().requires_grad_()
        y_u, y_i = spmm_bi(a, x_u, x_i)
        m_u, m_i = spmm_bi_modal_stacked(ms, x_u, [x_i] * len(ms))
        ((y_u ** 2).sum() + (y_i ** 3).sum() + (m_u ** 2).sum() + m_i.sum()).backward()
        torch.cuda.synchronize()
        grads.append([y_u, y_i, m_u, m_i, x_u.grad, x_i.grad])
    out["functions"] = all(torch.equal(p, q) for p, q in zip(*grads))
    return out


def test_mesh_form_at_world_size_one_is_bitwise_unsharded(cuda):
    from diffmm_tpu_torch.parallel.launch import run_ranks

    (out,) = run_ranks(_mesh_form_bitwise, 1, backend="nccl")
    assert out == {"forward": True, "functions": True}


def _captured_vs_eager():
    """A mesh Coach under NCCL (its steps captured, the all-reduces inside)
    against the same Coach's steps run eagerly: an epoch's losses, its
    eval and its state, bitwise."""
    from diffmm_tpu_torch.parallel import make_mesh
    from diffmm_tpu_torch.train.graphs import GraphCache

    mesh = make_mesh(1, 1)
    out = {}
    for form in ("dense", "sparse"):
        runs = []
        for capture in (True, False):
            coach = _mesh_coach(form, mesh)
            if not capture:
                coach.graphs = GraphCache(coach.device, coach.generator, capture=False)
            result = coach.train_epoch(0)
            runs.append((result, coach.test_epoch(), _coach_state(coach),
                         sum(g.replays for g in coach.graphs.graphs.values())))
        (r0, e0, s0, replays), (r1, e1, s1, eager_replays) = runs
        out[form] = (r0 == r1, e0 == e1, all(torch.equal(a, b) for a, b in zip(s0, s1)),
                     replays > 0 and eager_replays == 0)
    return out


def test_captured_mesh_steps_are_bitwise_the_eager_ones(cuda):
    from diffmm_tpu_torch.parallel.launch import run_ranks

    (out,) = run_ranks(_captured_vs_eager, 1, backend="nccl")
    assert out == {"dense": (True,) * 4, "sparse": (True,) * 4}


def _two_ranks_on_one_card():
    import hashlib

    from diffmm_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    mesh = make_mesh()
    out = {}
    for form in ("dense", "sparse"):
        coach = _mesh_coach(form, mesh)
        result = coach.train_epoch(0)
        digest = hashlib.sha256(b"".join(t.numpy().tobytes() for t in _coach_state(coach))).hexdigest()
        out[form] = (result, coach.test_epoch(), digest, coach.capture_steps)
    return out


def test_two_gloo_ranks_on_the_card_hold_equal_parameters(cuda):
    """Two ranks on the one card under gloo (eager steps): after an epoch
    their parameters, moments and edge buffers are bitwise equal, and the
    losses and metrics are within rel 2e-3 / abs 1e-5 of one rank's
    (tests/test_parallel.py:76-79)."""
    from diffmm_tpu_torch.parallel.launch import run_ranks

    rank0, rank1 = run_ranks(_two_ranks_on_one_card, 2, backend="gloo")
    for form in ("dense", "sparse"):
        assert rank0[form] == rank1[form]
        assert rank0[form][3] is False
        one = _mesh_coach(form, None)
        want = (one.train_epoch(0), one.test_epoch())
        for got, ref in zip(rank0[form][:2], want):
            for k in ref:
                assert got[k] == pytest.approx(ref[k], rel=2e-3, abs=1e-5), (form, k)


# ------------------------------------------------------------ model axis
@pytest.mark.parametrize("store", [torch.int8, torch.uint8], ids=["int8", "int4"])
def test_spmm_dual_on_a_catalog_shard_matches_plain(cuda, store):
    """K1 on each half of tiktok's catalog (9,308 x 3,355, d 64), built in
    place from the whole edges (``build_dense_bi_adj_device(cols=...)``):
    forward and backward against the plain version on the same shard, and
    the two shards' user sums against the whole block's."""
    from diffmm_tpu_torch.ops.graph import build_dense_bi_adj_device
    from diffmm_tpu_torch.ops.kernels.spmm_dual import LAUNCHES, SpmmDual, spmm_dual, spmm_dual_plain

    U, I, d = 9308, 6710, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    edges = (torch.rand((U, I), generator=gen, device=cuda) < 0.001).nonzero()
    rows, cols = edges[:, 0].to(torch.int32), edges[:, 1].to(torch.int32)
    z_u = torch.randn((U, d), generator=gen, device=cuda)
    z_i = torch.randn((I, d), generator=gen, device=cuda)
    whole = build_dense_bi_adj_device(rows, cols, U, I, store).mat
    y_u_whole, _ = spmm_dual(whole, z_u, z_i)
    y_u_sum = torch.zeros_like(y_u_whole)
    for lo, hi in ((0, I // 2), (I // 2, I)):
        mat = build_dense_bi_adj_device(rows, cols, U, I, store, cols=(lo, hi)).mat
        before = LAUNCHES["spmm_dual"]
        y_u, y_i = spmm_dual(mat, z_u, z_i[lo:hi])
        assert LAUNCHES["spmm_dual"] == before + 1
        p_u, p_i = spmm_dual_plain(mat, z_u, z_i[lo:hi])
        torch.testing.assert_close(y_u, p_u, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(y_i, p_i, rtol=1e-5, atol=1e-5)
        y_u_sum += y_u
        zu, zi = z_u.clone().requires_grad_(), z_i[lo:hi].clone().requires_grad_()
        g_u, g_i = torch.randn_like(y_u), torch.randn_like(y_i)
        torch.autograd.backward(SpmmDual.apply(mat, zu, zi), (g_u, g_i))
        q_u, q_i = spmm_dual_plain(mat, g_u, g_i)
        torch.testing.assert_close(zu.grad, q_u, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(zi.grad, q_i, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y_u_sum, y_u_whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1024, 3355, 1024), (1024, 10000, 1024), (256, 3355, 1024), (7, 133, 48)])
def test_denoise_partial_and_column_shards_match_plain(cuda, shape):
    """K2's partial product (the ``kNone`` epilogue) on a catalog shard of K
    rows, and K3 on a shard of N = K columns (tiktok's half, 3,355, odd;
    yelp's half, 10,000): against the plain products, the same bits on a
    second launch, the f64 gate; two halves' partials summed then tanh
    against K2 over the whole catalog."""
    from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
        LAUNCHES, denoise_layer1, denoise_layer1_partial, denoise_layer2, layer1_partial_plain,
        layer2_plain, prepare_weight,
    )

    B, K, H = shape
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((B, 2 * K), generator=gen, device=cuda)
    w1 = torch.randn((2 * K, H), generator=gen, device=cuda) * (2.0 / (2 * K + H)) ** 0.5
    tp = torch.randn((B, H), generator=gen, device=cuda) * 0.1
    w2 = torch.randn((H, 2 * K), generator=gen, device=cuda) * (2.0 / (2 * K + H)) ** 0.5
    b2 = torch.randn((2 * K,), generator=gen, device=cuda) * 0.01
    parts = []
    for lo, hi in ((0, K), (K, 2 * K)):
        xs, w1s = x[:, lo:hi].contiguous(), w1[lo:hi]
        before = dict(LAUNCHES)
        s = denoise_layer1_partial(xs, prepare_weight(w1s))
        assert LAUNCHES["denoise_layer1_partial"] == before["denoise_layer1_partial"] + 1
        plain = layer1_partial_plain(xs, w1s)
        torch.testing.assert_close(s, plain, rtol=1e-5, atol=5e-5)
        assert torch.equal(s, denoise_layer1_partial(xs, prepare_weight(w1s)))
        _f64_gate(s, plain, xs.double() @ w1s.double())
        parts.append(s)
        h = torch.tanh(s + tp)
        out = denoise_layer2(h, prepare_weight(w2[:, lo:hi].contiguous()), b2[lo:hi])
        out_plain = layer2_plain(h, w2[:, lo:hi], b2[lo:hi])
        torch.testing.assert_close(out, out_plain, rtol=1e-5, atol=5e-5)
        _f64_gate(out, out_plain, h.double() @ w2[:, lo:hi].double() + b2[lo:hi].double())
    whole = denoise_layer1(x, prepare_weight(w1), tp)
    torch.testing.assert_close(torch.tanh(parts[0] + parts[1] + tp), whole, rtol=1e-5, atol=5e-5)


def _model_axis_on_one_card():
    import hashlib

    from diffmm_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    mesh = make_mesh(model_parallel=2)
    out = {}
    for form in ("dense", "sparse"):
        coach = _mesh_coach(form, mesh)
        result = coach.train_epoch(0)
        whole = coach._whole(coach.gcn_params, coach.dn_params)
        state = [t.detach().cpu() for t in
                 [whole["gcn_params"]["i_embs"], *[p["out_layers"][-1]["w"] for p in whole["dn_params"]]]]
        digest = hashlib.sha256(b"".join(t.numpy().tobytes() for t in state)).hexdigest()
        out[form] = (result, coach.test_epoch(), digest, tuple(coach.gcn_params["i_embs"].shape))
    return out


def test_model_axis_two_gloo_ranks_on_the_card(cuda):
    """A 1x2 mesh on the one card under gloo: each rank holds half of the
    catalog's rows, the ranks' whole state is bitwise equal after an
    epoch, and the losses and metrics are within rel 2e-3 / abs 1e-5 of one
    device's."""
    from diffmm_tpu_torch.parallel.launch import run_ranks

    rank0, rank1 = run_ranks(_model_axis_on_one_card, 2, backend="gloo")
    for form in ("dense", "sparse"):
        assert rank0[form] == rank1[form]
        assert rank0[form][3] == (100, 16)
        one = _mesh_coach(form, None)
        want = (one.train_epoch(0), one.test_epoch())
        for got, ref in zip(rank0[form][:2], want):
            for k in ref:
                assert got[k] == pytest.approx(ref[k], rel=2e-3, abs=1e-5), (form, k)


def test_a_dropped_graph_cannot_end_a_later_capture(cuda):
    """A captured graph dropped in a reference cycle (a reset or discarded
    Coach's) is freed only by Python's cyclic collector; were it freed
    inside a later graph's capture (a step's Python allocations reach the
    collector's threshold), its destruction would end that capture.
    ``BlockGraph`` collects the garbage before it captures."""
    import gc

    from diffmm_tpu_torch.train.graphs import BlockGraph

    x = torch.zeros(4, device=cuda)
    stream = torch.cuda.Stream(cuda)
    old = BlockGraph(lambda v: x.add_(v), torch.Generator(device=cuda), stream)
    for _ in range(2):  # the eager step and its capture, then a replay
        old(torch.ones(4, device=cuda))
    held = [old]
    del old

    def step(v):
        [[i] for i in range(1000)]  # Python allocations past the collector's threshold
        if held:  # the eager run's end: the old graph becomes garbage, in a cycle
            cycle = {"graph": held.pop()}
            cycle["cycle"] = cycle
        x.mul_(v)

    thresholds = gc.get_threshold()
    gc.set_threshold(100, 1, 1)
    try:
        new = BlockGraph(step, torch.Generator(device=cuda), stream)
        for _ in range(2):
            new(torch.full((4,), 2.0, device=cuda))
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full((4,), 8.0, device=cuda))
