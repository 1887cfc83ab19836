"""The whole slice against the JAX package: a tiny synthetic dense-form JAX
Coach and the port's Coach with its parameters carried by
convert.params_from_jax run the phase-2 rebuild (``coach.steps.rebuild_epoch``
as ``train_epoch`` calls it, sampling_step=0), the GCN forward and the
ranking eval.

Asserted:
* the edge buffers are equal, user by user, outside a tie band: an item may
  differ only where its denoised score is within 1e-4 of the user's
  k-th score (f32 sums in another order can swap near-ties);
* the final embeddings agree within the bf16 tolerance (rtol 1e-2, atol
  1e-3: the propagation rounds z to bf16 on both sides);
* the metrics are equal (rtol 1e-6) when the port ranks the JAX embeddings.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.config import Config as JConfig
from diffmm_tpu.data.synthetic import make_synthetic_host_data as j_synth
from diffmm_tpu.train.coach import Coach as JCoach
from diffmm_tpu_torch.config import Config as TConfig
from diffmm_tpu_torch.convert import params_from_jax
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data as t_synth
from diffmm_tpu_torch.data.membership import gather_rows
from diffmm_tpu_torch.diffusion.gaussian import generate_view
from diffmm_tpu_torch.train.coach import Coach as TCoach

TIE_BAND = 1e-4


def _configs(order):
    cfgs = []
    for cls in (JConfig, TConfig):
        cfg = cls()
        cfg.base.seed = 7
        cfg.base.latdim = 16
        cfg.base.denoise_dim = "[32]"
        cfg.train.batch = 16
        cfg.train.test_batch = 8
        cfg.train.graph_form = "dense"
        cfg.train.rebuild_order = order
        cfg.hyper.steps = 5
        cfg.hyper.sampling_step = 0
        cfgs.append(cfg)
    return cfgs


def _assert_edges_match(t_coach, t_bufs, j_bufs):
    host = t_coach.host
    users = torch.arange(host.user_num)
    x0 = gather_rows(t_coach.data.train_store, users, host.item_num)
    for m, (tb, jb) in enumerate(zip(t_bufs, j_bufs)):
        tb, jb = tb.numpy(), np.asarray(jb)
        if np.array_equal(tb, jb):
            continue
        scores = generate_view(t_coach.schedule, t_coach.dn_params[m], x0, 0).numpy()
        for u in range(host.user_num):
            lo, k = host.csr_offsets[u], host.user_degrees[u]
            a, b = set(tb[lo:lo + k]), set(jb[lo:lo + k])
            kth = np.sort(scores[u])[::-1][k - 1]
            for item in a ^ b:
                assert abs(scores[u, item] - kth) <= TIE_BAND * max(1.0, abs(kth)), (m, u, item)
        np.testing.assert_array_equal(tb[host.nnz:], jb[host.nnz:])  # sentinel pads


@pytest.mark.parametrize(
    "order,shape",
    [("identity", (50, 40, 0.06)), ("degree", (70, 90, 0.25))],
    ids=["identity", "degree_two_buckets"],
)
def test_rebuild_forward_eval_match_jax(order, shape):
    jcfg, tcfg = _configs(order)
    U, I, density = shape
    j_host = j_synth(jcfg, user_num=U, item_num=I, density=density, seed=3)
    t_host = t_synth(tcfg, user_num=U, item_num=I, density=density, seed=3)
    j_coach = JCoach(jcfg, j_host)
    t_coach = TCoach(tcfg, t_host, device="cpu")
    t_coach.load_params(*params_from_jax(jax.device_get(j_coach.gcn_params),
                                         jax.device_get(j_coach.dn_params)))
    if order == "degree":
        assert len(t_coach.rebuild_widths) == 2  # the two-bucket plan
        assert t_coach.rebuild_widths == j_coach.rebuild_plan.widths

    j_bufs = j_coach.steps.rebuild_epoch(
        j_coach.dn_params, j_coach.data.train_store, j_coach._reb_blocks_device(),
        jax.random.split(jax.random.PRNGKey(0), j_coach.n_reb_blocks), jnp.int32(0),
        *j_coach.csr_gather_layout, j_host.item_num,
    )
    t_bufs = t_coach.rebuild_graphs()
    _assert_edges_match(t_coach, t_bufs, j_bufs)

    # forward and eval on the same graphs (the JAX buffers) on both sides
    j_coach.edge_buffers = list(j_bufs)
    j_coach.modal_adjs = [j_coach._make_adj(j_coach.data.train_rows, b) for b in j_bufs]
    t_coach.edge_buffers = [torch.as_tensor(np.asarray(b)) for b in j_bufs]
    t_coach.modal_adjs = [t_coach._make_adj(t_coach.data.train_rows, b)
                          for b in t_coach.edge_buffers]
    ju, ji = j_coach.steps.gcn_forward(j_coach.gcn_params, j_coach.data.adj,
                                       tuple(j_coach.modal_adjs), j_coach.data.raw_feats,
                                       j_coach._hp())
    tu, ti = t_coach.forward()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-2, atol=1e-3)

    want = j_coach.test_epoch()
    got = t_coach.test_epoch(embeddings=(torch.as_tensor(np.asarray(ju)),
                                         torch.as_tensor(np.asarray(ji))))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


def test_coach_rejects_what_the_slice_cannot_run():
    """Unknown spellings raise; ``dense_store="int4"``, once refused here,
    builds the packed blocks (tests/test_torch_int4.py holds them)."""
    _, tcfg = _configs("identity")
    host = t_synth(copy.deepcopy(tcfg), user_num=20, item_num=15, seed=1)
    for section, key, value, exc in (
        ("train", "segsum_compute", "f16", ValueError),
        ("train", "train_store", "coo", ValueError),
        ("train", "dense_store", "int2", ValueError),
        ("train", "rebuild_order", "random", ValueError),
        ("train", "graph_form", "bogus", ValueError),
    ):
        cfg = copy.deepcopy(tcfg)
        setattr(getattr(cfg, section), key, value)
        with pytest.raises(exc):
            TCoach(cfg, host, device="cpu")
    cfg = copy.deepcopy(tcfg)
    cfg.train.dense_store = "int4"
    coach = TCoach(cfg, host, device="cpu")
    assert coach.data.adj.mat.dtype == torch.uint8 and coach.data.adj.mat.shape == (20, 8)
