"""The port's K4-backed row gather (diffmm_tpu_torch/ops/gather.py) against
``jnp.take``'s VJP, the gather of the JAX package's losses and joint step.

Held: the forward exactly (a gather moves values); the table's cotangent
with duplicate indices (their rows summed) and unused rows (zeros), within
f32 reduction order: rtol 1e-6, atol 1e-6 (a duplicate's rows summed in
the stable sort's order here, in XLA's scatter order there). Also: one plan
shared by several gathers, a joint step's K4 calls per form and CL method
(BPR 3, the cross-layer CL 2 x 2, the modal CL 2 x 2 per modality or per
modality pair, beside the sparse form's propagations), and a plan over the
wrong row count refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu_torch.ops import gather as tg
from diffmm_tpu_torch.ops.kernels import segsum as sg

TOL = dict(rtol=1e-6, atol=1e-6)


def _jax_take_vjp(table, idx, cot):
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0), jnp.asarray(table))
    return np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("n,b,d", [(9, 20, 4), (50, 16, 16), (7, 1, 3), (300, 64, 64)])
def test_gather_gradient_matches_take_vjp(rng, n, b, d):
    table = rng.standard_normal((n, d)).astype(np.float32)
    # indices from the lower half only: duplicates, and rows nothing names
    idx = rng.integers(0, max(1, n // 2), b).astype(np.int32)
    cot = rng.standard_normal((b, d)).astype(np.float32)
    t = torch.tensor(table, requires_grad=True)
    out = tg.gather(t, torch.as_tensor(idx))
    np.testing.assert_array_equal(out.detach().numpy(), table[idx])
    (got,) = torch.autograd.grad(out, t, torch.as_tensor(cot))
    want = _jax_take_vjp(table, idx, cot)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    unused = np.setdiff1d(np.arange(n), idx)
    assert not got.numpy()[unused].any()


def test_plan_orders_indices_stably(rng):
    idx = torch.as_tensor(np.array([3, 1, 3, 0, 1, 3], dtype=np.int32))
    plan = tg.gather_plan(idx, 5)
    assert plan.perm.tolist() == [3, 1, 4, 0, 2, 5]
    assert plan.offsets.tolist() == [0, 1, 3, 3, 6, 6]


def test_one_plan_serves_several_gathers(rng):
    a = torch.tensor(rng.standard_normal((12, 5)).astype(np.float32), requires_grad=True)
    b = torch.tensor(rng.standard_normal((12, 5)).astype(np.float32), requires_grad=True)
    idx = torch.as_tensor(rng.integers(0, 12, 30).astype(np.int32))
    plan = tg.gather_plan(idx, 12)
    loss = (tg.gather(a, idx, plan) * tg.gather(b, idx, plan)).sum()
    ga, gb = torch.autograd.grad(loss, (a, b))
    want_a, want_b = jax.grad(lambda x, y: jnp.sum(x.take(jnp.asarray(idx.numpy()), axis=0)
                                                   * y.take(jnp.asarray(idx.numpy()), axis=0)),
                              argnums=(0, 1))(jnp.asarray(a.detach().numpy()),
                                              jnp.asarray(b.detach().numpy()))
    np.testing.assert_allclose(ga.numpy(), np.asarray(want_a), **TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(want_b), **TOL)


def test_plan_of_another_table_is_refused():
    idx = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="plan covers 4 rows"):
        tg.gather(torch.zeros((5, 2)), idx, tg.gather_plan(idx, 4))


@pytest.mark.parametrize("form,cl_method,want", [("dense", 0, 3 + 4 + 4 * 3), ("dense", 1, 3 + 4 + 4 * 3),
                                                  ("sparse", 0, 3 + 4 + 4 * 3 + 2 * (3 + 9))])
def test_joint_step_reduces_every_gather_with_k4(monkeypatch, form, cl_method, want):
    """Every loss gather of a joint step goes through K4 (its plain version
    here), no autograd of index_select: with M = 3 modalities, 19 gathers a
    step (C(3, 2) = 3 pairs under cl_method 1), and the sparse form's
    2 x (M + 9) propagation launches."""
    from diffmm_tpu_torch.config import Config
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.train import steps
    from diffmm_tpu_torch.train.coach import Coach

    calls = []
    plain = sg.segsum_plain
    monkeypatch.setattr(sg, "segsum_plain", lambda m, o: calls.append(m.shape) or plain(m, o))
    cfg = Config()
    cfg.base.latdim, cfg.base.denoise_dim, cfg.base.cl_method = 16, "[32]", cl_method
    cfg.train.batch, cfg.train.graph_form = 16, form
    host = make_synthetic_host_data(cfg, user_num=50, item_num=40, seed=3)
    coach = Coach(cfg, host, device="cpu")
    coach.rebuild_graphs()
    calls.clear()
    block = torch.arange(16, dtype=torch.int32)
    steps.joint_block(coach.gcn_params, coach.gcn_opt_state, coach.data.adj, coach.modal_adjs,
                      coach.data.raw_feats, block, block, block, 1e-3, coach.hp(), cl_method)
    assert len(calls) == want
