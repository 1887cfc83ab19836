"""One joint-training step of the port (diffmm_tpu_torch/train/steps.py::
joint_block) against diffmm_tpu's ``joint_step`` (``_joint_block``), on both
graph forms and both ``cl_method``s.

The same data (a synthetic 50 x 40 dataset, the port's rebuilt modality
graphs on both sides), parameters, Adam state (one step in: count 1, so
each update is a smooth function of its gradient) and batch go to both;
the cross-layer CL noise is the JAX step's own draw, the six uniforms of
``jax.random.split(key, 6)``, injected into the port. The JAX step runs its
default route (XLA scatter on the sparse form, two bf16 XLA matmuls on the
dense form).

The sparse form also runs with bf16 messages (``train.segsum_compute="bf16"``,
the JAX bench's sparse setting), the JAX step built from a config with
that setting as ``make_train_steps`` reads it: both sides round each
propagation's input table (and, in the backward, its cotangent) to bf16 and
sum in f32.

Tolerances: the sparse form with f32 messages is f32 throughout, the same
messages summed in another order: losses and updated parameters rtol 1e-4
/ atol 1e-5. With bf16 messages an input that differs in its last f32 bits
(the sums' order) may round to the neighbouring bf16 value on one side:
the bf16 tolerance, rtol 1e-2 / atol 1e-3, and each parameter's update
within a tenth of the step size (lr) of the JAX update. The
dense form rounds z to bf16 on both sides, but the backwards round
different operands (JAX rounds each product's sum, K1's VJP the
cotangent), and 1-ulp differences in the degree scales can flip a
rounding: losses and parameters at the bf16 tolerance, rtol 1e-2 / atol
1e-3, and each parameter's update within a tenth of the step size (lr)
of the JAX update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffmm_tpu.config import Config as JConfig
from diffmm_tpu.data.loader import to_device as j_to_device
from diffmm_tpu.data.synthetic import make_synthetic_host_data as j_synth
from diffmm_tpu.diffusion.schedule import make_schedule as j_sched
from diffmm_tpu.ops import graph as jg
from diffmm_tpu.train.steps import make_train_steps
from diffmm_tpu_torch.config import Config as TConfig
from diffmm_tpu_torch.convert import adam_state_from_jax
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data as t_synth
from diffmm_tpu_torch.train import steps as ts
from diffmm_tpu_torch.train.coach import Coach as TCoach
from diffmm_tpu_torch.train.optim import tree_leaves, tree_map

U, I, B, LR = 50, 40, 16, 1e-3


def _setup(form, cl_method, compute="f32"):
    cfgs = []
    for cls in (JConfig, TConfig):
        cfg = cls()
        cfg.base.seed = 7
        cfg.base.latdim = 16
        cfg.base.denoise_dim = "[32]"
        cfg.base.cl_method = cl_method
        cfg.train.batch = B
        cfg.train.graph_form = form
        cfg.train.segsum_compute = compute
        cfg.hyper.sampling_step = 0
        cfgs.append(cfg)
    t_coach = TCoach(cfgs[1], t_synth(cfgs[1], user_num=U, item_num=I, seed=3), device="cpu")
    bufs = [b.numpy() for b in t_coach.rebuild_graphs()]
    host = j_synth(cfgs[0], user_num=U, item_num=I, seed=3)
    data = j_to_device(host, with_sparse_adj=form == "sparse", train_store=t_coach.train_store_form)
    rows = data.train_rows
    if form == "dense":
        def build(c):
            return jg.build_dense_bi_adj_device(rows, c, U, I, store_dtype=jnp.int8)
    else:
        def build(c):
            return jg.build_bi_adj_device(rows, c, U, I)
    adj = build(data.train_cols) if form == "dense" else data.adj
    modal_adjs = tuple(build(jnp.asarray(b)) for b in bufs)
    steps = make_train_steps(cfgs[0], j_sched(0.1, 1e-4, 0.02, 5), t_coach.n_modal, host.k_max,
                             item_num=I)
    return t_coach, steps, adj, modal_adjs, data, bufs


def _adam_state(rng, params):
    """An optax Adam state one step in: the moments a first gradient g
    leaves, mu = 0.1 g and nu = 0.001 g^2."""
    g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.01, params)
    return optax.ScaleByAdamState(count=np.int32(1), mu=jax.tree.map(lambda a: 0.1 * a, g),
                                  nu=jax.tree.map(lambda a: 0.001 * a * a, g))


def _cl_noise(key, d):
    """The six uniforms the JAX cross-layer CL draws: (U, d) for the user
    layers, (I, d) for the item layers."""
    keys = jax.random.split(key, 6)
    return [torch.as_tensor(np.array(jax.random.uniform(k, (U if j % 2 == 0 else I, d))))
            for j, k in enumerate(keys)]


@pytest.mark.parametrize("cl_method", [0, 1])
@pytest.mark.parametrize("form", ["sparse", "dense", "sparse-bf16"])
def test_joint_block_matches(rng, form, cl_method):
    form, _, compute = form.partition("-")
    compute = compute or "f32"
    t_coach, steps, adj, modal_adjs, data, bufs = _setup(form, cl_method, compute)
    gcn = tree_map(lambda p: p.numpy().copy(), t_coach.gcn_params)
    state = _adam_state(rng, gcn)
    t_coach.load_params(gcn, [tree_map(lambda p: p.numpy().copy(), p) for p in t_coach.dn_params],
                        gcn_opt_state=adam_state_from_jax(state))
    t_coach.modal_adjs = [t_coach._make_adj(t_coach.data.train_rows, torch.as_tensor(b)) for b in bufs]
    host = t_coach.host
    pick = rng.integers(0, host.nnz, B)
    users = host.train_rows[pick].astype(np.int32)
    pos = host.train_cols[pick].astype(np.int32)
    neg = rng.integers(0, I, B).astype(np.int32)
    hp = t_coach.hp()
    key = jax.random.PRNGKey(4)

    j_params, _, j_metrics = steps.joint_step(
        gcn, state, adj, modal_adjs, data.raw_feats, jnp.asarray(users), jnp.asarray(pos),
        jnp.asarray(neg), key, jnp.float32(LR), {k: jnp.float32(v) for k, v in hp.items()},
    )
    t_metrics = ts.joint_block(
        t_coach.gcn_params, t_coach.gcn_opt_state, t_coach.data.adj, t_coach.modal_adjs,
        t_coach.data.raw_feats, torch.as_tensor(users), torch.as_tensor(pos), torch.as_tensor(neg),
        LR, hp, cl_method, compute, cl_noise=_cl_noise(key, 16),
    )
    assert t_coach.gcn_opt_state.count == 2
    bf16 = form == "dense" or compute == "bf16"
    tol = dict(rtol=1e-2, atol=1e-3) if bf16 else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_metrics.numpy(), np.asarray(j_metrics), **tol)
    for before, got, want in zip(tree_leaves(gcn), tree_leaves(t_coach.gcn_params),
                                 jax.tree_util.tree_leaves(j_params)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got, want, **tol)
        if bf16:
            np.testing.assert_allclose(got - before, want - before, rtol=0, atol=0.1 * LR)
