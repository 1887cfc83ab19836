"""The port's diffusion training (diffmm_tpu_torch/diffusion/gaussian.py::
training_losses, train/steps.py::diffusion_block) against diffmm_tpu's.

The JAX functions draw their timesteps and noise from a key; the port takes
the same draws injected (``jax.random.split`` of the key per modality, then
``randint`` and ``normal`` from the two halves of each, as
``training_losses`` draws them). Parameters come from the
port's Coach and a first step's moments (carried into the port by
convert.adam_state_from_jax): the state is one step in (count 1), so every
Adam update is a smooth function of its gradient.

Tolerances: f32 on both sides, sums in another order. The updated
parameters of a diffusion_block: rtol 1e-4 / atol 1e-5. Losses and
gradients: rtol 2e-4, the gradients with an atol of 1e-5 of each leaf's
largest entry (the SNR weights reach 1e4, and sums of such terms cancel).
The JAX functions are jitted, and XLA folds the SNR's
``1 - ab + 1e-8`` into ``(1 + 1e-8) - ab``, where 1 + 1e-8 rounds to 1 in
f32; that moves each SNR weight by 1e-8 / (1 - ab), up to 1e-4 relative
at t = 0 (measured: the jitted block's losses differ from the same code
run eagerly by 1.05e-4 to 1.14e-4 relative, and the port matches the eager
run to 1e-6). A diffusion_block's update is normalised by the detached
total loss, so its parameters do not see it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffmm_tpu.config import Config as JConfig
from diffmm_tpu.data.synthetic import make_synthetic_host_data as j_synth
from diffmm_tpu.diffusion import gaussian as jg
from diffmm_tpu.diffusion.schedule import make_schedule as j_sched
from diffmm_tpu.models import denoise as jd
from diffmm_tpu.data.loader import to_device as j_to_device
from diffmm_tpu.train.steps import make_train_steps
from diffmm_tpu_torch.config import Config as TConfig
from diffmm_tpu_torch.convert import adam_state_from_jax
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data as t_synth
from diffmm_tpu_torch.diffusion import gaussian as tg
from diffmm_tpu_torch.diffusion.schedule import make_schedule as t_sched
from diffmm_tpu_torch.models.gcn import project_features
from diffmm_tpu_torch.train import steps as ts
from diffmm_tpu_torch.train.coach import Coach as TCoach
from diffmm_tpu_torch.train.optim import AdamState, tree_leaves, tree_map

SCHED = (0.1, 1e-4, 0.02, 5)


def _draws(key, batch, item_num):
    """The (t, noise) JAX training_losses draws from ``key``."""
    t_key, n_key = jax.random.split(key)
    t = jax.random.randint(t_key, (batch,), 0, SCHED[3])
    noise = jax.random.normal(n_key, (batch, item_num), dtype=jnp.float32)
    return np.array(t), np.array(noise)


def test_q_sample_plain_gaussian_branch(rng):
    x0 = (rng.random((6, 20)) < 0.3).astype(np.float32)
    t = np.array([0, 1, 2, 3, 4, 1])
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    want = np.asarray(jg.q_sample(j_sched(*SCHED), jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    got = tg.q_sample(t_sched(*SCHED), torch.as_tensor(x0), torch.as_tensor(t),
                      noise=torch.as_tensor(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sim_weight,reg", [(0.1, 1e-5), (1.0, 0.3)])
def test_training_losses_value_and_grads(rng, sim_weight, reg):
    B, I, d = 9, 50, 8
    j_params = jd.init_denoise_params(jax.random.PRNGKey(4), I, [32], 10, d)
    x0 = (rng.random((B, I)) < 0.2).astype(np.float32)
    i_embs = rng.standard_normal((I, d)).astype(np.float32)
    feat = rng.standard_normal((I, d)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    t, noise = _draws(key, B, I)
    assert (t == 0).any() and (t > 0).any()  # both branches of the SNR weight

    def j_loss(p):
        return jnp.sum(jg.training_losses(j_sched(*SCHED), p, jnp.asarray(x0), jnp.asarray(i_embs),
                                          jnp.asarray(feat), key, sim_weight, reg))

    want, want_g = jax.jit(jax.value_and_grad(j_loss))(j_params)
    params = jax.tree.map(lambda p: torch.tensor(np.asarray(p), requires_grad=True),
                          jax.device_get(j_params))
    per_row = tg.training_losses(t_sched(*SCHED), params, torch.as_tensor(x0), torch.as_tensor(i_embs),
                                 torch.as_tensor(feat), sim_weight, reg, t=torch.as_tensor(t),
                                 noise=torch.as_tensor(noise))
    assert per_row.shape == (B,)
    got = per_row.sum()
    leaves = tree_leaves(params)
    got_g = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-4)
    for g, w in zip(got_g, jax.tree_util.tree_leaves(want_g)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=1e-5 * np.abs(w).max())


def _setup(form):
    """The port's Coach on a synthetic 50 x 40 dataset, and the JAX step
    functions and device data for the same dataset and store."""
    cfgs = []
    for cls in (JConfig, TConfig):
        cfg = cls()
        cfg.base.seed = 7
        cfg.base.latdim = 16
        cfg.base.denoise_dim = "[32]"
        cfg.train.batch = 16
        cfg.train.graph_form = form
        cfgs.append(cfg)
    t_coach = TCoach(cfgs[1], t_synth(cfgs[1], user_num=50, item_num=40, seed=3), device="cpu")
    host = j_synth(cfgs[0], user_num=50, item_num=40, seed=3)
    j_data = j_to_device(host, train_store=t_coach.train_store_form)
    j_steps = make_train_steps(cfgs[0], j_sched(*SCHED), t_coach.n_modal, host.k_max, item_num=host.item_num)
    return t_coach, j_data, j_steps


def _adam_state(rng, params):
    """An optax Adam state one step in (count 1): the moments a first
    gradient g leaves, mu = 0.1 g and nu = 0.001 g^2."""
    g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.01, params)
    return optax.ScaleByAdamState(count=np.int32(1), mu=jax.tree.map(lambda a: 0.1 * a, g),
                                  nu=jax.tree.map(lambda a: 0.001 * a * a, g))


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_diffusion_block_matches(rng, form):
    """One diffusion_block from the same parameters and Adam state (the
    dense form's (U, I) store or the sparse form's CSR store)."""
    t_coach, j_data, j_steps = _setup(form)
    host, batch, M = t_coach.host, 16, t_coach.n_modal
    users = rng.permutation(host.user_num)[:batch].astype(np.int32)
    weights = (np.arange(batch) < 13).astype(np.float32)  # a short block
    gcn = tree_map(lambda p: p.numpy().copy(), t_coach.gcn_params)
    dn = [tree_map(lambda p: p.numpy().copy(), p) for p in t_coach.dn_params]
    states = [_adam_state(rng, p) for p in dn]
    t_coach.load_params(gcn, dn, dn_opt_states=[adam_state_from_jax(s) for s in states])

    key, lr, hp = jax.random.PRNGKey(2), 1e-3, t_coach.hp()
    j_dn, _, j_losses = j_steps.diffusion_step(
        dn, states, gcn, j_data.raw_feats, j_data.train_store, jnp.asarray(users), jnp.asarray(weights),
        key, jnp.float32(lr), {k: jnp.float32(v) for k, v in hp.items()},
    )
    draws = [_draws(k, batch, host.item_num) for k in jax.random.split(key, M)]
    t = torch.as_tensor(np.stack([d[0] for d in draws]))
    noise = torch.as_tensor(np.stack([d[1] for d in draws]))
    feats = project_features(t_coach.gcn_params, t_coach.data.raw_feats)
    t_losses = ts.diffusion_block(
        t_coach.schedule, t_coach.dn_params, t_coach.dn_opt_states, feats,
        t_coach.gcn_params["i_embs"], t_coach.data.train_store, torch.as_tensor(users),
        torch.as_tensor(weights), lr, hp, host.item_num, t=t, noise=noise,
    )
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=2e-4, atol=1e-5)
    for m in range(M):
        for got, want in zip(tree_leaves(t_coach.dn_params[m]),
                             jax.tree_util.tree_leaves(j_dn[m])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert all(s.count == 2 for s in t_coach.dn_opt_states)


def test_diffusion_epoch_accumulator_quirk(monkeypatch):
    """acc = (acc + losses) / max(sum(losses), 1e-12) per block."""
    seq = [torch.tensor([1.0, 3.0]), torch.tensor([2.0, 2.0]), torch.tensor([0.0, 0.0])]
    it = iter(seq)
    monkeypatch.setattr(ts, "diffusion_block", lambda *a, **k: next(it))
    acc = ts.diffusion_epoch(None, [{}, {}], [AdamState(0, [], []), AdamState(0, [], [])],
                             {"modal_proj": [], "i_embs": None}, [], None,
                             torch.zeros((3, 4), dtype=torch.int32), torch.ones((3, 4)), 1e-3, {}, 5)
    want = torch.zeros(2)
    for losses in seq:
        want = (want + losses) / max(float(losses.sum()), 1e-12)
    torch.testing.assert_close(acc, want, rtol=0, atol=0)


def test_diffusion_accumulator_overflows_as_jax(monkeypatch):
    """The reference's accounting (``Main.py:174-185``) multiplies the
    accumulator by 1 / sum(losses) a block, so where the blocks' losses sum
    below 1 it overflows f32 to inf over enough blocks, as it does in the
    web-scale epoch (``chip_smoke.py`` path S, 391 blocks); sums near 2e-4,
    as here, overflow within 40. The JAX package's own ``diffusion_epoch`` (its
    scan, ``diffmm_tpu/train/steps.py:249``) is driven with the same block
    losses: its row gather made to hand each row its block's index and its
    ``training_losses`` to give that block's loss of the modality it is
    called for. Both accumulators are bitwise equal after 3 blocks (finite)
    and after 40 (inf)."""
    import diffmm_tpu.train.steps as js

    t_coach, j_data, j_steps = _setup("dense")
    M, B = t_coach.n_modal, 2  # two rows of one value: their mean is the value, exactly
    seq = (np.linspace(1.2e-4, 0.9e-4, M, dtype=np.float32)[None, :]
           * (1 + 0.01 * np.arange(40, dtype=np.float32))[:, None]).astype(np.float32)
    table, traced = jnp.asarray(seq), []

    def block_losses(schedule, params, x0, *args, **kwargs):
        m = len(traced) % M  # _modal_losses calls it once a modality, in order
        traced.append(m)
        return table[x0[:, 0].astype(jnp.int32), m]

    monkeypatch.setattr(js, "gather_rows", lambda store, users, item_num: users[:, None].astype(jnp.float32))
    monkeypatch.setattr(js, "training_losses", block_losses)
    gcn = tree_map(lambda p: p.numpy().copy(), t_coach.gcn_params)
    dn = [tree_map(lambda p: p.numpy().copy(), p) for p in t_coach.dn_params]
    hp = {k: jnp.float32(v) for k, v in t_coach.hp().items()}
    for n in (3, 40):
        states = [_adam_state(np.random.default_rng(0), p) for p in dn]
        users = jnp.repeat(jnp.arange(n, dtype=jnp.int32)[:, None], B, axis=1)
        _, _, j_acc = j_steps.diffusion_epoch(dn, states, gcn, j_data.raw_feats, j_data.train_store, users,
                                              jnp.ones((n, B), jnp.float32), jax.random.split(jax.random.PRNGKey(0), n),
                                              jnp.float32(1e-3), hp)
        it = iter(torch.as_tensor(seq[:n]))
        monkeypatch.setattr(ts, "diffusion_block", lambda *a, **k: next(it))
        acc = ts.diffusion_epoch(None, [{}] * M, [AdamState(0, [], []) for _ in range(M)],
                                 {"modal_proj": [], "i_embs": None}, [], None,
                                 torch.zeros((n, 4), dtype=torch.int32), torch.ones((n, 4)), 1e-3, {}, 5)
        assert traced and len(traced) % M == 0  # the JAX scan went through the block losses above
        assert bool(torch.isinf(acc).all()) == (n == 40) and np.isinf(np.asarray(j_acc)).all() == (n == 40)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
