"""The sparse graph form's serving path against the JAX package: a tiny
synthetic JAX ``Coach(graph_form="sparse")`` and the port's, with the JAX
parameters carried by convert.params_from_jax, run the phase-2 rebuild, the
GCN forward over the same graphs and the ranking eval. The JAX Coach runs
its default XLA scatter route and, with ``DIFFMM_SEGSUM=mxu``, its Pallas
plans in interpret mode (as tests/test_segsum.py runs them); the port runs
K4's plain version and the stacked modal propagation.

Asserted:
* the edge buffers are equal outside the tie band of tests/test_torch_slice.py
  (the rebuild reads its rows from the CSR store on both sides);
* the final embeddings agree within rtol 1e-4, atol 1e-5: f32 throughout,
  only the order of the f32 sums differs, through two propagation hops;
* the metrics are equal when the port ranks the JAX embeddings;
* the port's sparse Coach holds no (U, I) tensor;
* the graph form and the train store follow the settings as the JAX Coach
  decides them, and the log line names them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.config import Config as JConfig
from diffmm_tpu.data.synthetic import make_synthetic_host_data as j_synth
from chip_smoke import tensor_numels
from diffmm_tpu.train.coach import Coach as JCoach
from diffmm_tpu_torch.config import Config as TConfig
from diffmm_tpu_torch.convert import params_from_jax
from diffmm_tpu_torch.data.membership import TrainCSR, gather_rows
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data as t_synth
from diffmm_tpu_torch.diffusion.gaussian import generate_view
from diffmm_tpu_torch.ops.graph import BiAdj
from diffmm_tpu_torch.train.coach import Coach as TCoach

TIE_BAND = 1e-4
U, I, DENSITY = 50, 40, 0.06


class _Lines:
    """A log that keeps its lines."""

    def __init__(self):
        self.lines = []

    def info(self, message):
        self.lines.append(message)


def _configs(**train):
    cfgs = []
    for cls in (JConfig, TConfig):
        cfg = cls()
        cfg.base.seed = 7
        cfg.base.latdim = 16
        cfg.base.denoise_dim = "[32]"
        cfg.train.batch = 16
        cfg.train.test_batch = 8
        cfg.train.graph_form = "sparse"
        cfg.hyper.steps = 5
        cfg.hyper.sampling_step = 0
        for key, value in train.items():
            setattr(cfg.train, key, value)
        cfgs.append(cfg)
    return cfgs


def _coaches(**train):
    jcfg, tcfg = _configs(**train)
    j_host = j_synth(jcfg, user_num=U, item_num=I, density=DENSITY, seed=3)
    t_host = t_synth(tcfg, user_num=U, item_num=I, density=DENSITY, seed=3)
    j_log, t_log = _Lines(), _Lines()
    j_coach = JCoach(jcfg, j_host, log=j_log)
    t_coach = TCoach(tcfg, t_host, device="cpu", log=t_log)
    return j_coach, t_coach, j_log, t_log


def _assert_edges_match(t_coach, t_bufs, j_bufs):
    host = t_coach.host
    x0 = gather_rows(t_coach.data.train_store, torch.arange(host.user_num), host.item_num)
    for m, (tb, jb) in enumerate(zip(t_bufs, j_bufs)):
        tb, jb = tb.numpy(), np.asarray(jb)
        np.testing.assert_array_equal(tb[host.nnz:], jb[host.nnz:])  # sentinel pads
        if np.array_equal(tb, jb):
            continue
        scores = generate_view(t_coach.schedule, t_coach.dn_params[m], x0, 0).numpy()
        for u in range(host.user_num):
            lo, k = host.csr_offsets[u], host.user_degrees[u]
            kth = np.sort(scores[u])[::-1][k - 1]
            for item in set(tb[lo:lo + k]) ^ set(jb[lo:lo + k]):
                assert abs(scores[u, item] - kth) <= TIE_BAND * max(1.0, abs(kth)), (m, u, item)


@pytest.mark.parametrize("route", ["xla", "mxu"])
def test_sparse_slice_matches_jax(monkeypatch, route):
    if route == "mxu":
        monkeypatch.setenv("DIFFMM_SEGSUM", "mxu")
    j_coach, t_coach, _, _ = _coaches()
    assert (j_coach.modal_wide_plan is not None) == (route == "mxu")
    assert isinstance(t_coach.data.adj, BiAdj) and isinstance(t_coach.data.train_store, TrainCSR)
    t_coach.load_params(*params_from_jax(jax.device_get(j_coach.gcn_params),
                                         jax.device_get(j_coach.dn_params)))
    t_bufs = t_coach.rebuild_graphs()
    if route == "xla":  # the rebuild does not depend on the route
        j_bufs = j_coach.steps.rebuild_epoch(
            j_coach.dn_params, j_coach.data.train_store, j_coach._reb_blocks_device(),
            jax.random.split(jax.random.PRNGKey(0), j_coach.n_reb_blocks), jnp.int32(0),
            *j_coach.csr_gather_layout, I,
        )
        _assert_edges_match(t_coach, t_bufs, j_bufs)
        bufs = [np.array(b) for b in j_bufs]
    else:
        bufs = [b.numpy() for b in t_bufs]

    # forward and eval on the same graphs on both sides
    j_coach.edge_buffers = [jnp.asarray(b) for b in bufs]
    j_coach.modal_adjs = [j_coach._make_adj(j_coach.data.train_rows, b) for b in j_coach.edge_buffers]
    t_coach.edge_buffers = [torch.as_tensor(b) for b in bufs]
    t_coach.modal_adjs = [t_coach._make_adj(t_coach.data.train_rows, b) for b in t_coach.edge_buffers]
    ju, ji = j_coach.steps.gcn_forward(j_coach.gcn_params, j_coach.data.adj,
                                       tuple(j_coach.modal_adjs), j_coach.data.raw_feats,
                                       j_coach._hp())
    tu, ti = t_coach.forward()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-4, atol=1e-5)

    want = j_coach.test_epoch()
    got = t_coach.test_epoch(embeddings=(torch.as_tensor(np.asarray(ju)),
                                         torch.as_tensor(np.asarray(ji))))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)

    sizes = tensor_numels(vars(t_coach))
    assert U * I not in sizes and sizes


@pytest.mark.parametrize(
    "graph_form,train_store,budget_gb",
    [("sparse", "auto", 0.0), ("dense", "auto", 0.0), ("auto", "auto", 1e-6),
     ("auto", "auto", 0.0), ("sparse", "dense", 0.0), ("dense", "csr", 0.0)],
)
def test_form_and_store_follow_jax(graph_form, train_store, budget_gb):
    j_coach, t_coach, j_log, t_log = _coaches(
        graph_form=graph_form, train_store=train_store, dense_budget_gb=budget_gb,
    )
    assert t_coach.dense_graphs == j_coach.dense_graphs
    assert t_coach.train_store_form == j_coach.train_store_form
    assert isinstance(t_coach.data.train_store, TrainCSR) == (t_coach.train_store_form == "csr")
    form = "dense" if t_coach.dense_graphs else "sparse"
    j_line = next(line for line in j_log.lines if line.startswith("Graph form:"))
    t_line = next(line for line in t_log.lines if line.startswith("Graph form:"))
    assert j_line.split()[2] == form
    assert t_line.startswith(f"Graph form: {form} | train store: {t_coach.train_store_form} |")
