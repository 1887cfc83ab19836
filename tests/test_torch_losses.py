"""The port's losses (diffmm_tpu_torch/ops/losses.py) against
diffmm_tpu/ops/losses.py on the same inputs: BPR (1e-5 epsilon), in-batch
InfoNCE with duplicate indices kept, L2 regularisation; values and
gradients. f32 on both sides, sums in another order: rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.ops import losses as jl
from diffmm_tpu_torch.ops import losses as tl

RTOL, ATOL = 1e-5, 1e-6


def _grads(t_fn, j_fn, arrays):
    want_v, want_g = jax.value_and_grad(j_fn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    got_v = t_fn(*leaves)
    got_g = torch.autograd.grad(got_v, leaves)
    np.testing.assert_allclose(got_v.item(), float(want_v), rtol=RTOL, atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_bpr_loss_matches(rng):
    u, p, n = (rng.standard_normal((12, 8)).astype(np.float32) * 2 for _ in range(3))
    _grads(tl.bpr_loss, jl.bpr_loss, [u, p, n])


def test_bpr_loss_keeps_the_epsilon():
    """A hopeless pair (sigmoid 0) costs -log(1e-5), not infinity."""
    u = torch.tensor([[100.0]])
    got = tl.bpr_loss(u, torch.tensor([[-1.0]]), torch.tensor([[1.0]]))
    assert got.item() == pytest.approx(-np.log(1e-5), rel=1e-6)


@pytest.mark.parametrize("temperature", [0.2, 0.5])
def test_info_nce_matches_with_duplicates(rng, temperature):
    v1 = rng.standard_normal((20, 8)).astype(np.float32)
    v2 = rng.standard_normal((20, 8)).astype(np.float32)
    idx = np.array([3, 7, 3, 0, 19, 7, 12], dtype=np.int32)  # duplicates kept
    _grads(lambda a, b: tl.info_nce(a, b, torch.as_tensor(idx), temperature),
           lambda a, b: jl.info_nce(a, b, jnp.asarray(idx), temperature), [v1, v2])


def test_l2_reg_loss_matches(rng):
    a = rng.standard_normal((9, 4)).astype(np.float32)
    b = rng.standard_normal((5, 4)).astype(np.float32)
    _grads(lambda x, y: tl.l2_reg_loss(1e-3, [x, y]), lambda x, y: jl.l2_reg_loss(1e-3, [x, y]), [a, b])
