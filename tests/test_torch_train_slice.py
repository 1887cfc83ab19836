"""The port's training slice end to end on the CPU: ``Coach.run`` on a
synthetic 50 x 40 dataset on both graph forms, the best-epoch capture and
the index served from it, the CLI (``python -m diffmm_tpu_torch``), and
the tiktok_mini accuracy band of tests/test_regression_mini.py.

Asserted: finite losses with the JAX package's keys, the best epoch's
snapshot (host copies, the epoch of the best Recall), the served index
equal to the forward of that snapshot, the trajectory fixed by the seed,
the divergence stop, ``train.epoch_scan`` running its epochs as fused
chunks, and the CLI's refusals (no card without ``--device cpu``, the
multi-device flags). The accuracy band is the JAX package's own,
0.008-0.019 Recall@20 after two epochs (``slow``: two real epochs on the
CPU).
"""

import math
import os

import numpy as np
import pytest
import torch

from diffmm_tpu_torch import cli
from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.loader import load_host_data
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
from diffmm_tpu_torch.eval.serving import build_index, load_index, recommend
from diffmm_tpu_torch.train.coach import Coach
from diffmm_tpu_torch.train.optim import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(form, **train):
    cfg = Config()
    cfg.base.seed = 7
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.train.batch = 16
    cfg.train.test_batch = 8
    cfg.train.epoch = 3
    cfg.train.graph_form = form
    for key, value in train.items():
        setattr(cfg.train, key, value)
    return cfg


class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, message):
        self.lines.append(message)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tests' tiny tensors: beside the other
    test workers on a loaded box, several threads a process spin against
    each other (measured: the sparse three-epoch run 43 s with 8 threads
    under load, 0.5 s with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_run_three_epochs(form):
    cfg = _config(form)
    host = make_synthetic_host_data(cfg, user_num=50, item_num=40, seed=3)
    log = _Lines()
    coach = Coach(cfg, host, device="cpu", log=log)
    before = [p.clone() for p in tree_leaves(coach.gcn_params)]
    best = coach.run()
    assert set(best) == {"best_epoch", "Recall", "NDCG", "Precision"}
    assert 0 < best["Recall"] <= 1 and 0 <= best["best_epoch"] < 3
    train_lines = [line for line in log.lines if "⏩ Train" in line]
    assert len(train_lines) == 3 and len([line for line in log.lines if "🧪 Test" in line]) == 3
    for key in ("Loss=", "BPR Loss=", "reg loss=", "CL loss=", "image loss=", "text loss="):
        assert key in train_lines[0]
    assert all(math.isfinite(float(part.split("=")[1])) for line in train_lines
               for part in line.split(": ", 1)[1].split(", "))
    assert coach.gcn_opt_state.count == 3 * -(-host.nnz // cfg.train.batch)
    assert all(s.count == 3 * -(-host.user_num // cfg.train.batch) for s in coach.dn_opt_states)
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(coach.gcn_params)))

    snap = coach.best_snapshot
    assert snap["epoch"] == best["best_epoch"]
    assert all(p.device.type == "cpu" for p in tree_leaves(snap["gcn_params"]))
    index = build_index(coach)
    params, modal_adjs = coach.best_state()
    want_u, want_i = coach.forward(params, modal_adjs)
    torch.testing.assert_close(index.u_final, want_u, rtol=0, atol=0)
    torch.testing.assert_close(index.i_final, want_i, rtol=0, atol=0)
    # the best Recall is reproduced by the served state
    got = coach.test_epoch(embeddings=(index.u_final, index.i_final))
    assert got["Recall"] == pytest.approx(best["Recall"], abs=1e-7)
    live = build_index(coach, use_best=False)
    if snap["epoch"] != 2:
        assert not torch.equal(live.u_final, index.u_final)
    ids, scores = recommend(index, torch.arange(4), 5)
    assert ids.shape == (4, 5) and torch.isfinite(scores).all()


def test_trajectory_is_fixed_by_the_seed():
    cfg = _config("sparse")
    host = make_synthetic_host_data(cfg, user_num=50, item_num=40, seed=3)
    results = []
    for _ in range(2):
        coach = Coach(cfg, host, device="cpu", log=_Lines())
        results.append((coach.train_epoch(0), coach.train_epoch(1)))
    assert results[0] == results[1]
    cfg.base.seed = 8
    assert Coach(cfg, host, device="cpu", log=_Lines()).train_epoch(0) != results[0][0]


def test_run_stops_on_non_finite_losses():
    cfg = _config("dense")
    host = make_synthetic_host_data(cfg, user_num=50, item_num=40, seed=3)
    coach = Coach(cfg, host, device="cpu", log=_Lines())
    coach.gcn_params["u_embs"][0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="diverged at epoch 0"):
        coach.run(epochs=2)


def test_epoch_scan_runs_epochs_one_at_a_time():
    """``train.epoch_scan=2`` runs ``Coach.run`` in fused chunks of two
    epochs (``train_epochs_fused``), and the last odd epoch alone; 0 is
    refused."""
    cfg = _config("dense", epoch_scan=2)
    host = make_synthetic_host_data(cfg, user_num=50, item_num=40, seed=3)
    log = _Lines()
    coach = Coach(cfg, host, device="cpu", log=log)
    chunks = []
    fused = coach.train_epochs_fused
    coach.train_epochs_fused = lambda e, n, s=None: chunks.append((e, n)) or fused(e, n, s)
    coach.run(epochs=3)
    assert chunks == [(0, 2)]
    assert len([line for line in log.lines if "⏩ Train" in line]) == 3
    assert len([line for line in log.lines if "🧪 Test" in line]) == 3
    cfg.train.epoch_scan = 0
    with pytest.raises(ValueError, match="epoch_scan"):
        Coach(cfg, host, device="cpu", log=log)


def _write_conf(tmp_path):
    conf = tmp_path / "synth.toml"
    conf.write_text(
        '[base]\nlatdim = 8\nseed = 3\ndenoise_dim = "[16]"\n'
        '[data]\nname = "synthetic:40x30"\n'
        "[hyper]\nsteps = 5\n"
        "[train]\nbatch = 16\ntest_batch = 8\nepoch = 2\n"
    )
    return str(conf)


def test_cli_trains_on_the_cpu_and_exports(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the run's log directory
    idx = str(tmp_path / "index.npz")
    rc = cli.main(["-c", _write_conf(tmp_path), "--device", "cpu", "--epochs", "1",
                   "--set", "train.graph_form=sparse", "--export-index", idx])
    assert rc == 0
    index = load_index(idx, device="cpu")
    assert index.u_final.shape == (40, 8) and index.i_final.shape == (30, 8)
    assert np.isfinite(index.u_final.numpy()).all()


def test_cli_refuses_without_a_card_and_slice_four_flags(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    conf = _write_conf(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-c", conf, "--epochs", "1"])
    # the mesh flags run under a launcher (tests/test_torch_distributed_cli.py);
    # in one process without one they stop before any group starts
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for flag, says in ((["--mesh", "4x2"], "under torchrun"), (["--distributed"], "torchrun sets")):
        with pytest.raises(SystemExit):
            cli.main(["-c", conf, "--device", "cpu", *flag])
        assert says in capsys.readouterr().err
    assert cli.main(["-c", str(tmp_path / "missing.toml"), "--device", "cpu"]) == 1


@pytest.mark.slow
@pytest.mark.skipif(not os.path.isdir(os.path.join(REPO, "data", "tiktok_mini")),
                    reason="tiktok_mini slice not present")
def test_tiktok_mini_two_epoch_recall_band():
    """The JAX package's band (tests/test_regression_mini.py:28-51) for the
    port on the CPU; chip_smoke.py path G checks it on the card."""
    cfg = Config()
    cfg.data.name = "tiktok_mini"
    cfg.base.seed = 1818
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[64]"
    cfg.train.batch = 256
    cfg.train.test_batch = 256
    cfg.train.epoch = 2
    host = load_host_data(cfg, data_root=os.path.join(REPO, "data"))
    assert host.user_num == 600 and host.item_num == 6710
    coach = Coach(cfg, host, device="cpu", log=_Lines())
    for epoch in range(2):
        coach.train_epoch(epoch)
    result = coach.test_epoch()
    assert 0.008 <= result["Recall"] <= 0.019, result
