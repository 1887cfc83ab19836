"""The KNN modality-graph ablation (``hyper.use_knn_adj``) in the port
against the JAX package: ``ops/knn.py`` (after ``tests/test_knn.py``) and
a KNN Coach's joint phase on both graph forms.

Tolerances:
* prototypes: K4's rule, |port - JAX| <= 1e-6 * sum|terms| + 1e-6 per
  element (the sum of a user's features in another order), the terms here
  the user's gathered features over its count;
* edges: each user's top-k set equal to the JAX one, except for items whose
  similarity lies within 1e-6 of the user's k-th (a tie there may resolve
  either way);
* the joint phase over the KNN graphs, the same permutation and negatives,
  ``noise_degree`` 0 (the cross-layer CL's noise then adds exact zeros, so
  no draw needs injecting): the sparse form f32 (rtol 1e-4, atol 1e-5),
  the dense form, whose user-item block goes through K1's bf16 rounding,
  at the bf16 tolerance (rtol 1e-2, atol 1e-3), as ``tests/test_torch_joint.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.config import Config as JConfig
from diffmm_tpu.data.synthetic import make_synthetic_host_data as j_synth
from diffmm_tpu.ops.knn import knn_edges as j_knn_edges
from diffmm_tpu.ops.losses import l2_normalize as j_l2
from diffmm_tpu.train.coach import Coach as JCoach
from diffmm_tpu_torch.config import Config as TConfig
from diffmm_tpu_torch.convert import params_from_jax
from diffmm_tpu_torch.data.loader import to_device as t_to_device
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data as t_synth
from diffmm_tpu_torch.ops.graph import BiAdj, DenseBiAdj
from diffmm_tpu_torch.ops.knn import knn_edges, knn_prototypes
from diffmm_tpu_torch.train.coach import Coach as TCoach
from diffmm_tpu_torch.train.optim import tree_leaves

U, I, B = 50, 40, 16


def _configs(form="dense", **settings):
    cfgs = []
    for cls in (JConfig, TConfig):
        cfg = cls()
        cfg.base.seed = 7
        cfg.base.latdim = 16
        cfg.base.denoise_dim = "[32]"
        cfg.train.batch = B
        cfg.train.test_batch = 8
        cfg.train.graph_form = form
        cfg.hyper.use_knn_adj = True
        cfg.hyper.knn_topk = 5
        for name, value in settings.items():
            section, key = name.split(".")
            setattr(getattr(cfg, section), key, value)
        cfgs.append(cfg)
    return cfgs


def _assert_knn_sets(got, want, sim, topk, band=1e-6):
    got, want = got.reshape(-1, topk), want.reshape(-1, topk)
    for u in range(got.shape[0]):
        kth = np.sort(sim[u])[::-1][topk - 1]
        for item in set(got[u]) ^ set(want[u]):
            assert abs(sim[u, item] - kth) <= band, (u, item)


@pytest.mark.parametrize("padded", [False, True], ids=["host_edges", "padded_device_edges"])
@pytest.mark.parametrize("m", [0, 1, 2])
def test_knn_edges_match_jax(padded, m):
    """Prototypes within K4's rule and top-k edges equal outside ties, on
    each modality's features (after tests/test_knn.py:27, :51: the device
    edges end in sentinel pads, which must not reach a prototype)."""
    jcfg, tcfg = _configs()
    j_host = j_synth(jcfg, user_num=U, item_num=I, seed=3)
    t_host = t_synth(tcfg, user_num=U, item_num=I, seed=3)
    feats = np.asarray(t_host.raw_feats[m], dtype=np.float32)
    if padded:
        data = t_to_device(t_host, "cpu")
        rows, cols = data.train_rows, data.train_cols
        assert int(rows[-1]) == U  # the pads are there
    else:
        rows, cols = torch.as_tensor(t_host.train_rows), torch.as_tensor(t_host.train_cols)
    topk = 5

    proto = knn_prototypes(rows, cols, torch.as_tensor(feats), U).numpy()
    r, c = t_host.train_rows, t_host.train_cols
    terms = jax.ops.segment_sum(jnp.abs(jnp.asarray(feats)[c]), jnp.asarray(r), num_segments=U)
    counts = np.maximum(np.bincount(r, minlength=U), 1)[:, None]
    want_sum = jax.ops.segment_sum(jnp.asarray(feats)[c], jnp.asarray(r), num_segments=U)
    want_proto = np.asarray(want_sum) / counts
    assert (np.abs(proto - want_proto) <= 1e-6 * np.asarray(terms) / counts + 1e-6).all()

    got_rows, got_cols = knn_edges(rows, cols, torch.as_tensor(feats), U, topk)
    j_rows, j_cols = j_knn_edges(jnp.asarray(np.asarray(rows)), jnp.asarray(np.asarray(cols)),
                                 jnp.asarray(np.asarray(j_host.raw_feats[m])), U, topk)
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(got_rows.numpy(), np.repeat(np.arange(U), topk))
    sim = np.asarray(j_l2(jnp.asarray(want_proto), axis=1) @ j_l2(jnp.asarray(feats), axis=1).T)
    _assert_knn_sets(got_cols.numpy(), np.asarray(j_cols), sim, topk)


def _pair(form):
    jcfg, tcfg = _configs(form, **{"hyper.noise_degree": 0.0})
    j_coach = JCoach(jcfg, j_synth(copy.deepcopy(jcfg), user_num=U, item_num=I, seed=3))
    t_coach = TCoach(tcfg, t_synth(copy.deepcopy(tcfg), user_num=U, item_num=I, seed=3), device="cpu")
    t_coach.load_params(*params_from_jax(jax.device_get(j_coach.gcn_params),
                                         jax.device_get(j_coach.dn_params)))
    return j_coach, t_coach


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_knn_joint_phase_matches_jax(rng, form):
    """A KNN Coach's joint phase (after tests/test_knn.py:64) from the JAX
    Coach's parameters over the same KNN graphs, interaction permutation
    and negatives: the (4,) loss sums and the GCN parameters."""
    j_coach, t_coach = _pair(form)
    j_coach.modal_adjs = j_coach._knn_adjs()
    t_coach.modal_adjs = t_coach._knn_adjs()
    assert all(isinstance(a, BiAdj) for a in t_coach.modal_adjs)
    assert isinstance(t_coach.data.adj, DenseBiAdj) == (form == "dense")
    for ja, ta in zip(j_coach.modal_adjs, t_coach.modal_adjs):
        np.testing.assert_array_equal(ta.ui_rows.numpy(), np.asarray(ja.ui_rows))
        if not np.array_equal(ta.ui_cols.numpy(), np.asarray(ja.ui_cols)):
            pytest.fail("KNN graphs differ (no ties expected at this seed)")
    host = t_coach.host
    perm = rng.permutation(host.nnz).astype(np.int32)
    n_blocks = -(-host.nnz // B)
    perm = perm[np.arange(n_blocks * B) % host.nnz]
    negs = rng.integers(0, I, size=t_coach.data.train_rows.shape[0]).astype(np.int32)
    lr, hp = 1e-3, t_coach.hp()

    data = j_coach.data
    take = lambda a: a.take(jnp.asarray(perm)).reshape(n_blocks, B)  # noqa: E731
    j_params, _, j_acc = j_coach.steps.joint_epoch(
        j_coach.gcn_params, j_coach.gcn_opt_state, data.adj, tuple(j_coach.modal_adjs), data.raw_feats,
        take(data.train_rows), take(data.train_cols), take(jnp.asarray(negs)),
        jax.random.split(jax.random.PRNGKey(1), n_blocks), jnp.float32(lr),
        {k: jnp.float32(v) for k, v in hp.items()},
    )
    t_acc = t_coach._joint_phase(torch.as_tensor(perm), torch.as_tensor(negs), lr, hp)
    tol = dict(rtol=1e-4, atol=1e-5) if form == "sparse" else dict(rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc), **tol)
    for got, want in zip(tree_leaves(t_coach.gcn_params), jax.tree_util.tree_leaves(j_params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_knn_coach_epochs_best_state_and_resume(tmp_path, form):
    """The KNN Coach's branches (JAX coach.py:837-840, 999-1002, 1220,
    1303-1307, 1330-1332, 1419-1421): the graphs are built once and kept,
    no rebuild phase runs, ``rebuild_graphs`` and ``train_epochs_fused``
    refuse, ``epoch_scan`` falls back to single epochs, the best snapshot
    holds no edge buffers, and a restore into a new Coach rebuilds the KNN
    graphs and resumes exactly."""
    _, tcfg = _configs(form, **{"train.epoch_scan": 2, "train.tstEpoch": 1})
    host = t_synth(copy.deepcopy(tcfg), user_num=U, item_num=I, seed=3)
    coach = TCoach(copy.deepcopy(tcfg), host, device="cpu", checkpoint_dir=str(tmp_path))
    assert coach._chunk_size(0, 4) == 1
    with pytest.raises(ValueError, match="use_knn_adj"):
        coach.rebuild_graphs()
    with pytest.raises(ValueError, match="use_knn_adj"):
        coach.train_epochs_fused(0, 2)
    best = coach.run(epochs=1)
    assert np.isfinite(best["Recall"])
    first = coach.modal_adjs
    coach.train_epoch(1)
    assert "rebuild" not in coach.timer.totals and "joint" in coach.timer.totals
    assert coach.modal_adjs is first and coach.edge_buffers is None
    assert coach.best_snapshot["edge_buffers"] is None
    params, adjs = coach.best_state()
    assert adjs is first and params["u_embs"].shape == (U, 16)

    again = TCoach(copy.deepcopy(tcfg), host, device="cpu", checkpoint_dir=str(tmp_path))
    assert again.restore_checkpoint()["epoch"] == 0
    assert again.modal_adjs is not None and again.best_snapshot["edge_buffers"] is None
    for a, b in zip(again.modal_adjs, first):
        assert torch.equal(a.ui_cols, b.ui_cols)
    twin = TCoach(copy.deepcopy(tcfg), host, device="cpu")
    twin.total_epochs = 1
    twin.train_epoch(0)
    twin.total_epochs = again.total_epochs = 2
    assert again.train_epoch(1) == twin.train_epoch(1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again.gcn_params), tree_leaves(twin.gcn_params)))
