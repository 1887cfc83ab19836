"""The execution knobs that the port used to refuse, against the JAX package
on the CPU: ``train.rebuild_compute="bf16"``, a denoiser with more than one
hidden layer, ``base.denoise_param_dtype="bf16"`` and
``train.donate_buffers``.

Tolerances:
* the bf16 rebuild: the denoiser's outputs within rtol 2e-2, atol 1e-2
  (bf16 operands keep 8 bits: each product rounds its inputs to 2^-9
  relative, and the two packages round the same values at other places,
  XLA keeping some intermediates in f32); the top-k edges equal outside a
  tie band of that width around each user's k-th score;
* a [32, 32] denoiser's rebuild: the f32 ``TOL`` of the port (rtol 1e-5,
  atol 5e-5), edges equal outside a tie band of 1e-4 (as
  ``tests/test_torch_slice.py``);
* bf16 parameters: carried over from JAX bitwise; after one diffusion block
  and its Adam step each parameter within one bf16 ulp of the JAX one, plus
  1/32 of the JAX step, plus 1e-5. The step runs op by op in bf16 on both
  sides (``train/optim.py``; alone, on the same gradients, it gives the JAX
  package's moments bit for bit), but the gradients are f32 sums in
  another order, so the step's chain of bf16 roundings (the gradient, both
  moments, the square root, the ratio: five on each side, each up to 2^-9
  relative) can move it by up to ten such halves, 2% (1/32 bounds it);
  where a gradient cancels to near zero its last bits move the ratio in
  any precision, which the f32 parity test's atol of 1e-5 (1% of the
  learning rate, ``tests/test_torch_train_diffusion.py``) covers. Measured:
  at most 1.4% of a step. The losses within rtol 1e-2;
* ``donate_buffers`` on and off: the same epoch bitwise (after
  ``tests/test_donation.py:42``: the port updates in place either way);
* a checkpoint of bf16 denoisers and moments: bitwise, and the resumed
  epoch equal to the uninterrupted one.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffmm_tpu.config import Config as JConfig
from diffmm_tpu.data.synthetic import make_synthetic_host_data as j_synth
from diffmm_tpu.diffusion import gaussian as jg
from diffmm_tpu.models import denoise as jd
from diffmm_tpu.ops.topk import topk_table as j_topk_table
from diffmm_tpu.train.coach import Coach as JCoach
from diffmm_tpu_torch.config import Config as TConfig
from diffmm_tpu_torch.convert import adam_state_from_jax, params_from_jax
from diffmm_tpu_torch.data.membership import gather_rows
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data as t_synth
from diffmm_tpu_torch.diffusion import gaussian as tg
from diffmm_tpu_torch.models.gcn import project_features
from diffmm_tpu_torch.ops.topk import catalog_topk
from diffmm_tpu_torch.train import steps as ts
from diffmm_tpu_torch.train.coach import Coach as TCoach
from diffmm_tpu_torch.train.optim import tree_leaves

BF16_TOL = (2e-2, 1e-2)
F32_TOL = (1e-5, 5e-5)


def _pair(U=50, I=40, **settings):
    """A JAX Coach and the port's Coach on the same synthetic data with the
    JAX Coach's parameters, ``settings`` ({"section.key": value}) on both."""
    cfgs = []
    for cls in (JConfig, TConfig):
        cfg = cls()
        cfg.base.seed = 7
        cfg.base.latdim = 16
        cfg.base.denoise_dim = "[32]"
        cfg.train.batch = 16
        cfg.train.test_batch = 8
        cfg.train.graph_form = "dense"
        cfg.hyper.steps = 5
        cfg.hyper.sampling_step = 0
        for name, value in settings.items():
            section, key = name.split(".")
            setattr(getattr(cfg, section), key, value)
        cfgs.append(cfg)
    j_coach = JCoach(cfgs[0], j_synth(copy.deepcopy(cfgs[0]), user_num=U, item_num=I, seed=3))
    t_coach = TCoach(cfgs[1], t_synth(copy.deepcopy(cfgs[1]), user_num=U, item_num=I, seed=3),
                     device="cpu")
    t_coach.load_params(*params_from_jax(jax.device_get(j_coach.gcn_params),
                                         jax.device_get(j_coach.dn_params)))
    return j_coach, t_coach


def _assert_tables_match(got, want, scores, tol):
    """Per row, the two top-k sets differ only at items whose score lies
    within ``tol`` (rtol, atol) of the row's k-th score."""
    k = got.shape[1]
    rtol, atol = tol
    for u in range(got.shape[0]):
        kth = np.sort(scores[u])[::-1][k - 1]
        for item in set(got[u]) ^ set(want[u]):
            assert abs(scores[u, item] - kth) <= rtol * abs(kth) + atol, (u, item)


def _assert_edges_match(t_coach, t_bufs, j_bufs, band):
    """Edge buffers equal user by user, outside ``band`` around the k-th
    denoised score (the port's scores)."""
    host = t_coach.host
    denoisers, apply = ts.rebuild_forward(t_coach.dn_params, t_coach.config.train.rebuild_compute)
    x0 = gather_rows(t_coach.data.train_store, torch.arange(host.user_num), host.item_num)
    for m, (tb, jb) in enumerate(zip(t_bufs, j_bufs)):
        tb, jb = tb.numpy(), np.asarray(jb)
        np.testing.assert_array_equal(tb[host.nnz:], jb[host.nnz:])  # sentinel pads
        if np.array_equal(tb, jb):
            continue
        scores = tg.generate_view(t_coach.schedule, denoisers[m], x0, 0, denoise_apply=apply).numpy()
        for u in range(host.user_num):
            lo, k = host.csr_offsets[u], host.user_degrees[u]
            kth = np.sort(scores[u])[::-1][k - 1]
            for item in set(tb[lo:lo + k]) ^ set(jb[lo:lo + k]):
                assert abs(scores[u, item] - kth) <= band[0] * abs(kth) + band[1], (m, u, item)


def _j_rebuild(j_coach):
    return j_coach.steps.rebuild_epoch(
        j_coach.dn_params, j_coach.data.train_store, j_coach._reb_blocks_device(),
        jax.random.split(jax.random.PRNGKey(0), j_coach.n_reb_blocks), jnp.int32(0),
        *j_coach.csr_gather_layout, j_coach.host.item_num,
    )


def _j_rebuild_apply(compute):
    """The JAX package's rebuild forward (``diffmm_tpu/train/steps.py:
    142-168``): bf16 params and activations, the output back in f32."""
    if compute == "f32":
        return jd.denoise_forward
    return lambda p, x, t, f: jd.denoise_forward(p, x, t, f, compute_dtype=jnp.bfloat16).astype(
        jnp.float32)


@pytest.mark.parametrize("compute,dims,tol", [("bf16", "[32]", BF16_TOL), ("f32", "[32, 32]", F32_TOL),
                                              ("bf16", "[32, 16]", BF16_TOL)],
                         ids=["bf16", "deep_f32", "deep_bf16"])
def test_reverse_view_matches_jax_with_the_same_noise(rng, compute, dims, tol):
    """The rebuild's reverse diffusion of one block from a noised start
    (sampling_step 2, the raw normal draw injected), its denoiser as
    ``rebuild_forward`` chooses it: outputs within ``tol``, the top-k tables
    equal outside a band of that width."""
    j_coach, t_coach = _pair(**{"train.rebuild_compute": compute, "base.denoise_dim": dims})
    host = t_coach.host
    users = np.arange(16, dtype=np.int32)
    x0 = gather_rows(t_coach.data.train_store, torch.as_tensor(users), host.item_num)
    key = jax.random.PRNGKey(5)
    raw = np.array(jax.random.normal(key, tuple(x0.shape), dtype=jnp.float32))
    cast = (lambda p: jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)) if compute == "bf16" else (
        lambda p: p)
    denoisers, apply = ts.rebuild_forward(t_coach.dn_params, compute)
    assert apply is (ts._bf16_apply if compute == "bf16" else tg.denoise_forward)
    j_apply = _j_rebuild_apply(compute)
    for m in range(t_coach.n_modal):
        want = jg.generate_view(j_coach.schedule, cast(j_coach.dn_params[m]), jnp.asarray(x0.numpy()), 2,
                                key=key, denoise_apply=j_apply)
        got = tg.generate_view(t_coach.schedule, denoisers[m], x0, 2, noise=torch.as_tensor(raw),
                               denoise_apply=apply)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol[0], atol=tol[1])
        k = 6
        _assert_tables_match(catalog_topk(got, k).numpy(), np.asarray(j_topk_table(want, k, "exact")),
                             got.numpy(), tol)


@pytest.mark.parametrize("compute,dims,band", [("bf16", "[32]", BF16_TOL), ("f32", "[32, 32]", (1e-4, 1e-4))],
                         ids=["bf16", "deep_f32"])
def test_rebuild_epoch_matches_jax(compute, dims, band):
    """The whole phase-2 rebuild (``Coach.rebuild_graphs`` against the JAX
    ``rebuild_epoch``) under each knob: edge buffers equal outside the band."""
    j_coach, t_coach = _pair(**{"train.rebuild_compute": compute, "base.denoise_dim": dims})
    _assert_edges_match(t_coach, t_coach.rebuild_graphs(), _j_rebuild(j_coach), band)


def test_bf16_params_carry_over_bitwise():
    j_coach, t_coach = _pair(**{"base.denoise_param_dtype": "bf16"})
    for j_dn, t_dn in zip(jax.device_get(j_coach.dn_params), t_coach.dn_params):
        for want, got in zip(jax.tree_util.tree_leaves(j_dn), tree_leaves(t_dn)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          np.asarray(want).view(np.int16))
    assert all(m.dtype == torch.bfloat16 for s in t_coach.dn_opt_states for m in s.mu + s.nu)
    # the GCN stays f32, as in the JAX package
    assert all(p.dtype == torch.float32 for p in tree_leaves(t_coach.gcn_params))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significant bits), the smallest normal's
    at zero."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_bf16_diffusion_block_and_adam_match_jax(rng):
    """One diffusion block and its Adam step on bf16 denoisers, from an Adam
    state one step in (bf16 moments, as optax keeps them), the draws
    injected."""
    from diffmm_tpu.data.loader import to_device as j_to_device
    from diffmm_tpu.diffusion.schedule import make_schedule as j_sched
    from diffmm_tpu.train.steps import make_train_steps

    j_coach, t_coach = _pair(**{"base.denoise_param_dtype": "bf16"})
    host, batch, M = t_coach.host, 16, t_coach.n_modal
    users = rng.permutation(host.user_num)[:batch].astype(np.int32)
    weights = (np.arange(batch) < 13).astype(np.float32)
    dn = jax.device_get(j_coach.dn_params)
    gcn = jax.device_get(j_coach.gcn_params)

    def state(p):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.01).astype(a.dtype), p)
        return optax.ScaleByAdamState(count=np.int32(1), mu=jax.tree.map(lambda a: 0.1 * a, g),
                                      nu=jax.tree.map(lambda a: 0.001 * a * a, g))

    states = [state(p) for p in dn]
    t_coach.load_params(*params_from_jax(gcn, dn), dn_opt_states=[adam_state_from_jax(s) for s in states])
    assert all(m.dtype == torch.bfloat16 for s in t_coach.dn_opt_states for m in s.mu)

    sched = (0.1, 1e-4, 0.02, 5)
    j_steps = make_train_steps(j_coach.config, j_sched(*sched), M, host.k_max, item_num=host.item_num)
    j_data = j_to_device(j_coach.host, train_store="dense")
    key, lr, hp = jax.random.PRNGKey(2), 1e-3, t_coach.hp()
    j_dn, _, j_losses = j_steps.diffusion_step(
        dn, states, gcn, j_data.raw_feats, j_data.train_store, jnp.asarray(users), jnp.asarray(weights),
        key, jnp.float32(lr), {k: jnp.float32(v) for k, v in hp.items()},
    )
    draws = []
    for k in jax.random.split(key, M):
        t_key, n_key = jax.random.split(k)
        draws.append((np.array(jax.random.randint(t_key, (batch,), 0, sched[3])),
                      np.array(jax.random.normal(n_key, (batch, host.item_num), dtype=jnp.float32))))
    feats = project_features(t_coach.gcn_params, t_coach.data.raw_feats)
    t_losses = ts.diffusion_block(
        t_coach.schedule, t_coach.dn_params, t_coach.dn_opt_states, feats, t_coach.gcn_params["i_embs"],
        t_coach.data.train_store, torch.as_tensor(users), torch.as_tensor(weights), lr, hp,
        host.item_num, t=torch.as_tensor(np.stack([d[0] for d in draws])),
        noise=torch.as_tensor(np.stack([d[1] for d in draws])),
    )
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-2)
    for m in range(M):
        for got, want, old in zip(tree_leaves(t_coach.dn_params[m]), jax.tree_util.tree_leaves(j_dn[m]), jax.tree_util.tree_leaves(dn[m])):
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
            step = np.abs(want - np.asarray(old, dtype=np.float32))
            bound = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + step / 32 + 1e-5
            assert (np.abs(got - want) <= bound).all(), float((np.abs(got - want) / bound).max())
    assert all(s.count == 2 for s in t_coach.dn_opt_states)


def test_bf16_params_epoch_runs_and_keeps_its_types():
    """A whole epoch on bf16 denoisers: the types hold through the
    diffusion phase, Adam and the rebuild (K2/K3's plain versions on the
    widened weights here)."""
    _, t_coach = _pair(**{"base.denoise_param_dtype": "bf16"})
    losses = t_coach.train_epoch(0)
    assert all(np.isfinite(v) for v in losses.values())
    assert all(p.dtype == torch.bfloat16 for dn in t_coach.dn_params for p in tree_leaves(dn))
    denoisers, apply = ts.rebuild_forward(t_coach.dn_params, "f32")
    assert apply is ts.denoise_forward_fused and denoisers[0].w1x.dtype == torch.float32


def test_donate_buffers_changes_nothing():
    """After ``tests/test_donation.py::test_donation_is_a_pure_memory_knob``:
    the port updates its state in place either way, so an epoch with the
    knob on and off is the same, bit for bit."""
    runs = []
    for donate in (True, False):
        cfg = TConfig()
        cfg.base.seed, cfg.base.latdim, cfg.base.denoise_dim = 7, 16, "[32]"
        cfg.train.batch, cfg.train.test_batch, cfg.train.donate_buffers = 16, 8, donate
        coach = TCoach(cfg, t_synth(copy.deepcopy(cfg), user_num=50, item_num=40, seed=3), device="cpu")
        losses = [coach.train_epoch(e) for e in range(2)]
        runs.append((losses, tree_leaves(coach.gcn_params) + tree_leaves(coach.dn_params)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_bf16_checkpoint_round_trips_bitwise(tmp_path):
    """bf16 denoisers and their bf16 Adam moments survive a checkpoint bit
    for bit (``torch.save`` keeps the type), and the resumed epoch equals
    the uninterrupted one."""
    def coach(ckpt=None):
        cfg = TConfig()
        cfg.base.seed, cfg.base.latdim, cfg.base.denoise_dim = 7, 16, "[32]"
        cfg.base.denoise_param_dtype = "bf16"
        cfg.train.batch, cfg.train.test_batch = 16, 8
        c = TCoach(cfg, t_synth(copy.deepcopy(cfg), user_num=50, item_num=40, seed=3), device="cpu",
                   checkpoint_dir=ckpt)
        c.total_epochs = 2
        return c

    first, twin = coach(str(tmp_path)), coach()
    first.train_epoch(0)
    twin.train_epoch(0)
    first.save_checkpoint(0, {})
    again = coach(str(tmp_path))
    assert again.restore_checkpoint()["epoch"] == 0
    saved = tree_leaves(first.dn_params) + [m for s in first.dn_opt_states for m in s.mu + s.nu]
    restored = tree_leaves(again.dn_params) + [m for s in again.dn_opt_states for m in s.mu + s.nu]
    assert all(a.dtype == b.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(saved, restored))
    assert again.train_epoch(1) == twin.train_epoch(1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again.dn_params), tree_leaves(twin.dn_params)))
