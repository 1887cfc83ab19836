"""The port's optimizer (diffmm_tpu_torch/train/optim.py) against
diffmm_tpu/train/optim.py: Adam against ``optax.scale_by_adam(0.9, 0.999,
1e-8)`` plus ``p - lr * update`` over three steps at two learning rates,
from a fresh state and from a JAX state at step 2 carried over by
convert.adam_state_from_jax; f32 on both sides, elementwise operations in
the same order but for fused multiply-adds: rtol 1e-6, atol 1e-6.
``cosine_lr`` is compared exactly (the same float64 formula).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.train import optim as jo
from diffmm_tpu_torch.convert import adam_state_from_jax, tree_to
from diffmm_tpu_torch.train import optim as to

TOL = dict(rtol=1e-6, atol=1e-6)


def _params(rng):
    """A GCN-shaped tree: dicts (in unsorted key order) and a list."""
    return {
        "u_embs": rng.standard_normal((7, 4)).astype(np.float32),
        "i_embs": rng.standard_normal((5, 4)).astype(np.float32),
        "modal_proj": [{"w": rng.standard_normal((3, 4)).astype(np.float32),
                        "b": rng.standard_normal(4).astype(np.float32)} for _ in range(2)],
        "modal_weight": np.full(2, 0.5, np.float32),
    }


def _grads(rng, params):
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.1).astype(np.float32), params)


def _assert_tree_close(t_tree, j_tree):
    for t, j in zip(to.tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("lr", [1e-3, 0.05])
def test_adam_matches_optax(rng, lr):
    params = _params(rng)
    tx = jo.make_adam()
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    t_params = tree_to(params, "cpu")
    t_state = to.adam_init(t_params)
    for _ in range(3):
        grads = _grads(rng, params)
        j_params, j_state = jo.adam_update(tx, jax.tree.map(jnp.asarray, grads), j_state, j_params,
                                           jnp.float32(lr))
        to.adam_update(t_params, to.tree_leaves(tree_to(grads, "cpu")), t_state, lr)
        _assert_tree_close(t_params, j_params)
    assert t_state.count == int(j_state.count) == 3
    _assert_tree_close(t_state.mu, j_state.mu)
    _assert_tree_close(t_state.nu, j_state.nu)


def test_adam_continues_from_a_jax_state(rng):
    params = _params(rng)
    tx = jo.make_adam()
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    for _ in range(2):
        j_params, j_state = jo.adam_update(tx, jax.tree.map(jnp.asarray, _grads(rng, params)),
                                           j_state, j_params, jnp.float32(1e-2))
    t_params = tree_to(jax.device_get(j_params), "cpu")
    t_state = adam_state_from_jax(jax.device_get(j_state))
    assert t_state.count == 2
    grads = _grads(rng, params)
    j_params, j_state = jo.adam_update(tx, jax.tree.map(jnp.asarray, grads), j_state, j_params,
                                       jnp.float32(1e-2))
    to.adam_update(t_params, to.tree_leaves(tree_to(grads, "cpu")), t_state, 1e-2)
    _assert_tree_close(t_params, j_params)


def test_tree_leaves_follow_jax_order(rng):
    params = _params(rng)
    got = [t.shape for t in to.tree_leaves(tree_to(params, "cpu"))]
    want = [tuple(a.shape) for a in jax.tree_util.tree_leaves(params)]
    assert got == [torch.Size(s) for s in want]


@pytest.mark.parametrize("total", [0, 1, 3, 50])
def test_cosine_lr_matches_exactly(total):
    for epoch in range(max(total, 1) + 1):
        assert to.cosine_lr(epoch, 1e-3, total) == jo.cosine_lr(epoch, 1e-3, total)
