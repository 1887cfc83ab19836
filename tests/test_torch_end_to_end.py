"""End-to-end smoke of the port, after ``tests/test_end_to_end.py``: the
whole four-phase epoch on a synthetic dataset (made bit-identically to the
JAX package's, ``data/synthetic.py``) on the CPU. The losses are finite and
the BPR loss falls; on the structured (low-rank) synthetic set, whose test
items are the held-out highest-affinity items, the trained model beats the
random-ranking expectation by the JAX test's wide margin; the rebuilt
graphs keep every user's train degree and the normalisation their item
degrees give; ``cl_method=1`` trains; ``run(epochs=N)`` moves the cosine
horizon to N.
"""

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
from diffmm_tpu_torch.train.coach import Coach
from diffmm_tpu_torch.train.optim import cosine_lr
from diffmm_tpu_torch.utils.logging import NullLog


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors: beside the other test
    workers, several threads a process spin against each other (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _coach(cfg, host) -> Coach:
    return Coach(cfg, host, device="cpu", log=NullLog())


@pytest.fixture(scope="module")
def trained_coach():
    cfg = Config()
    cfg.base.seed = 11
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.train.batch = 16
    cfg.train.test_batch = 8
    cfg.train.epoch = 4
    cfg.train.lr = 5e-3
    host = make_synthetic_host_data(cfg, user_num=48, item_num=36, density=0.15, seed=5)
    coach = _coach(cfg, host)
    results = [coach.train_epoch(e) for e in range(3)]
    return coach, results


def test_epoch_losses_finite(trained_coach):
    _, results = trained_coach
    for res in results:
        for key, val in res.items():
            assert np.isfinite(val), f"{key} not finite: {val}"
    assert {"Loss", "BPR Loss", "reg loss", "CL loss", "image loss", "text loss", "audio loss"} <= set(results[0])


def test_bpr_decreases(trained_coach):
    _, results = trained_coach
    assert results[-1]["BPR Loss"] < results[0]["BPR Loss"]


def test_eval_runs_and_is_sane(trained_coach):
    coach, _ = trained_coach
    metrics = coach.test_epoch()
    for k in ("Recall", "NDCG", "Precision"):
        assert 0.0 <= metrics[k] <= 1.0
    assert metrics["Recall"] > 0.0


def test_trained_model_beats_random_ranking():
    """Random E[Recall@k] a user is k over the user's unmasked candidates;
    the trained model must reach 2.5 times it (the JAX test's margin)."""
    cfg = Config()
    cfg.base.seed = 11
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.train.batch = 32
    cfg.train.test_batch = 32
    cfg.train.epoch = 3
    cfg.train.lr = 5e-3
    host = make_synthetic_host_data(cfg, user_num=64, item_num=200, density=0.08, seed=5, structure_rank=4)
    candidates = host.item_num - host.user_degrees
    random_exp = float(np.mean(np.minimum(cfg.base.topk / candidates.astype(np.float64), 1.0)))
    coach = _coach(cfg, host)
    for epoch in range(3):
        coach.train_epoch(epoch)
    metrics = coach.test_epoch()
    assert metrics["Recall"] > 2.5 * random_exp, (metrics, random_exp)


def test_rebuilt_adjacency_edge_counts(trained_coach):
    """Each rebuilt graph keeps every user's train degree; its pad lanes
    hold the ``item_num`` sentinel; its item normalisation is
    ``(deg_i + 1)^-1/2`` of its own item degrees."""
    coach, _ = trained_coach
    assert coach.modal_adjs is not None
    rows_all = coach.data.train_rows.numpy()
    real = rows_all < coach.host.user_num
    assert real.sum() == coach.host.nnz
    for buf, adj in zip(coach.edge_buffers, coach.modal_adjs):
        cols = buf.numpy()
        assert len(cols) == coach.edge_buf_len
        np.testing.assert_array_equal(cols[~real], np.full((~real).sum(), coach.host.item_num))
        np.testing.assert_array_equal(np.bincount(rows_all[real], minlength=coach.host.user_num),
                                      coach.host.user_degrees)
        assert (cols[real] >= 0).all() and (cols[real] < coach.host.item_num).all()
        deg_i = np.bincount(cols[real], minlength=coach.host.item_num)
        np.testing.assert_allclose(adj.s_item.numpy(), (deg_i + 1.0) ** -0.5, rtol=1e-5)


def test_cl_method_pairwise_runs():
    cfg = Config()
    cfg.base.seed = 3
    cfg.base.latdim = 8
    cfg.base.denoise_dim = "[16]"
    cfg.base.cl_method = 1
    cfg.train.batch = 16
    cfg.train.test_batch = 8
    host = make_synthetic_host_data(cfg, user_num=24, item_num=20, seed=9, modalities=["image", "text"],
                                    feat_dims=[12, 10])
    res = _coach(cfg, host).train_epoch(0)
    assert np.isfinite(res["Loss"])
    assert "audio loss" not in res


def test_epochs_override_moves_cosine_horizon():
    """``run(epochs=N)`` anneals the cosine LR over N (reference
    `Main.py:93`: T_max is the epoch count)."""
    cfg = Config()
    cfg.base.seed = 3
    cfg.base.latdim = 8
    cfg.base.denoise_dim = "[16]"
    cfg.train.batch = 16
    cfg.train.test_batch = 8
    cfg.train.epoch = 100
    host = make_synthetic_host_data(cfg, user_num=24, item_num=20, seed=9)
    coach = _coach(cfg, host)
    assert coach.total_epochs == 100
    coach.run(epochs=2)
    assert coach.total_epochs == 2
    assert cosine_lr(1, cfg.train.lr, coach.total_epochs) == pytest.approx(1e-4 + (cfg.train.lr - 1e-4) / 2)
