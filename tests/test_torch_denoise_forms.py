"""K2/K3's two kernel forms on the CPU: the rule that picks one by shape,
the strip form's grid, and the wrappers' ``form`` argument.

The rule (``denoise_form``) is a function of the contraction depth alone:
the strip form at 64 deep or less (K3 at web scale's hidden width, where
the output's store sets the time), the gemm form deeper (K2 over the
catalog, K3 at the shipped hidden width of 1,024). The card's tests
(``tests/test_torch_gpu.py``) hold the two forms bitwise against each
other and against the plain versions; here no kernel runs."""

import pytest
import torch

from diffmm_tpu_torch.ops.kernels.denoise_mlp import (
    FORMS,
    STRIP_MAX_K,
    denoise_form,
    denoise_layer1,
    denoise_layer1_partial,
    denoise_layer2,
    layer1_plain,
    layer2_plain,
    strip_blocks,
)


# (B, K, N) of each entry: K3 at path S's shapes (the web-scale rebuild,
# hidden 64, and the sparse demo's rank block) and at the ragged small
# shapes of the card's tests take the strip form; K2 and K3 at hidden
# 1,024 (the card tests' rebuild and model-axis shapes) and K2 over any
# catalog keep the gemm form
@pytest.mark.parametrize(
    "entry, shape, want",
    [
        ("denoise_layer2", (512, 64, 100000), "strip"),
        ("denoise_layer2", (128, 64, 50000), "strip"),
        ("denoise_layer2", (7, 48, 133), "strip"),
        ("denoise_layer2", (300, 64, 1000), "strip"),
        ("denoise_layer2", (100, 33, 17), "strip"),
        ("denoise_layer2", (130, 64, 250), "strip"),
        ("denoise_layer1", (100, 17, 33), "strip"),
        ("denoise_layer1", (1024, 6710, 1024), "gemm"),
        ("denoise_layer2", (1024, 1024, 6710), "gemm"),
        ("denoise_layer1", (1024, 20000, 1024), "gemm"),
        ("denoise_layer2", (1024, 1024, 20000), "gemm"),
        ("denoise_layer1", (256, 6710, 1024), "gemm"),
        ("denoise_layer2", (256, 1024, 6710), "gemm"),
        ("denoise_layer1_partial", (1024, 3355, 1024), "gemm"),
        ("denoise_layer2", (1024, 1024, 3355), "gemm"),
        ("denoise_layer1_partial", (1024, 10000, 1024), "gemm"),
        ("denoise_layer2", (1024, 1024, 10000), "gemm"),
        ("denoise_layer1", (512, 100000, 64), "gemm"),
        ("denoise_layer1_partial", (128, 50000, 64), "gemm"),
        ("denoise_layer2", (65, 77, 20000), "gemm"),
    ],
)
def test_form_by_contraction_depth(entry, shape, want):
    B, K, N = shape
    assert denoise_form(K) == want
    assert (K <= STRIP_MAX_K) == (want == "strip")


# (m, n, n_sm, blocks): one block an SM where the units (128-column strip,
# 128-row tile) outnumber the SMs, one a unit where they do not
@pytest.mark.parametrize(
    "m, n, n_sm, want",
    [(512, 100000, 132, 132), (128, 50000, 132, 132), (7, 133, 132, 2), (300, 1000, 132, 24),
     (1024, 1000, 132, 64), (1, 1, 132, 1)],
)
def test_strip_blocks(m, n, n_sm, want):
    assert strip_blocks(m, n, n_sm) == want


def test_form_argument_is_checked_on_the_cpu():
    """The CPU runs the plain versions whatever the form, and refuses a form
    the card would refuse: an unknown one, or the strip form past 64 deep."""
    gen = torch.Generator().manual_seed(0)
    x, w1, tp = (torch.randn(s, generator=gen) for s in ((5, 40), (40, 24), (5, 24)))
    h, w2, b2 = torch.tanh(tp), torch.randn((24, 40), generator=gen), torch.randn(40, generator=gen)
    for form in (None, *FORMS):
        assert torch.equal(denoise_layer1(x, w1, tp, form), layer1_plain(x, w1, tp))
        assert torch.equal(denoise_layer1_partial(x, w1, form), x @ w1)
        assert torch.equal(denoise_layer2(h, w2, b2, form), layer2_plain(h, w2, b2))
    with pytest.raises(ValueError, match="no 'wide' form"):
        denoise_layer2(h, w2, b2, "wide")
    deep = torch.randn((5, STRIP_MAX_K + 1), generator=gen)
    with pytest.raises(ValueError, match="no 'strip' form for a contraction 65 deep"):
        denoise_layer1_partial(deep, torch.randn((STRIP_MAX_K + 1, 8), generator=gen), "strip")
