"""Checkpoints, resume and ``reset`` of the port (utils/checkpoint.py and the
Coach's ``save_checkpoint``, ``restore_checkpoint``, ``run`` and ``reset``),
after tests/test_checkpoint.py:28, 79, tests/test_divergence.py:31, 57 and
tests/test_fused_epochs.py:143, and the CLI's ``--checkpoint-dir`` and
``--trace-dir``.

On the CPU every comparison is exact: a resumed run computes what the
uninterrupted one does, on the state it saved (parameters, Adam moments and
counts, edge buffers, the best snapshot, the torch generator's state and
the numpy stream's), so parameters, buffers and metrics are held equal with
no tolerance. The numpy stream is serialised as the JAX package serialises
it (the same JSON).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from diffmm_tpu_torch import cli
from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
from diffmm_tpu_torch.train.coach import Coach
from diffmm_tpu_torch.train.optim import tree_leaves
from diffmm_tpu_torch.utils import checkpoint as tck
from diffmm_tpu_torch.utils.logging import Log


class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, message):
        self.lines.append(message)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny tensors (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(form="dense", **train):
    cfg = Config()
    cfg.base.seed = 7
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.train.batch = 16
    cfg.train.test_batch = 8
    cfg.train.epoch = 3
    cfg.hyper.steps = 5
    cfg.train.graph_form = form
    for key, value in train.items():
        setattr(cfg.train, key, value)
    return cfg


_HOSTS = {}


def _coach(cfg, **kwargs):
    host = _HOSTS.setdefault("h", make_synthetic_host_data(cfg, user_num=50, item_num=40, seed=3))
    return Coach(copy.deepcopy(cfg), host, device="cpu", log=_Lines(), **kwargs)


def _assert_same(a, b):
    for x, y in zip(tree_leaves(a.gcn_params) + tree_leaves(a.dn_params),
                    tree_leaves(b.gcn_params) + tree_leaves(b.dn_params), strict=True):
        assert torch.equal(x, y)
    for sa, sb in zip([a.gcn_opt_state, *a.dn_opt_states], [b.gcn_opt_state, *b.dn_opt_states]):
        assert sa.count == sb.count
        assert all(torch.equal(x, y) for x, y in zip(sa.mu + sa.nu, sb.mu + sb.nu))
    assert all(torch.equal(x, y) for x, y in zip(a.edge_buffers, b.edge_buffers, strict=True))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.np_rng.bit_generator.state == b.np_rng.bit_generator.state


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_resume_matches_uninterrupted(tmp_path, form):
    """A 3-epoch run stopped after epoch 1's checkpoint and resumed by a new
    Coach equals the uninterrupted run (the stopped part keeps the run's
    cosine horizon, as the JAX test drives it)."""
    cfg = _config(form)
    full = _coach(cfg)
    want = full.run(epochs=3)
    ck = str(tmp_path / "ck")
    first = _coach(cfg, checkpoint_dir=ck)
    first.total_epochs = 3
    for epoch in range(2):
        first.train_epoch(epoch)
    first.save_checkpoint(1, {})
    second = _coach(cfg, checkpoint_dir=ck)
    second.run(epochs=3)
    _assert_same(full, second)
    assert second.test_epoch() == full.test_epoch()
    assert any("Resumed from checkpoint at epoch 1" in line for line in second.log.lines)
    assert want["Recall"] > 0


def test_eval_after_restore_without_training(tmp_path):
    """The edge buffers ride in the checkpoint, so a restored Coach
    evaluates at once; the best snapshot and the run's best metrics come
    back too."""
    ck = str(tmp_path / "ck")
    first = _coach(_config(), checkpoint_dir=ck)
    best = first.run(epochs=2)
    metrics = first.test_epoch()
    second = _coach(_config(), checkpoint_dir=ck)
    resumed = second.restore_checkpoint()
    assert resumed["epoch"] == 1
    assert {k: resumed[k] for k in ("Recall", "NDCG", "Precision", "best_epoch")} == {
        k: best[k] for k in ("Recall", "NDCG", "Precision")} | {"best_epoch": best["best_epoch"]}
    assert second.test_epoch() == metrics
    assert second.best_snapshot["epoch"] == first.best_snapshot["epoch"]
    for x, y in zip(tree_leaves(second.best_snapshot["gcn_params"]),
                    tree_leaves(first.best_snapshot["gcn_params"]), strict=True):
        assert torch.equal(x, y)
    assert _coach(_config(), checkpoint_dir=str(tmp_path / "empty")).restore_checkpoint() is None


def test_divergence_resumes_from_last_good_epoch(tmp_path):
    """A NaN learning rate diverges epoch 2; the failed epoch is not saved,
    and a new Coach with the lr repaired resumes from epoch 1."""
    cfg = _config()
    ck = str(tmp_path / "ck")
    coach = _coach(cfg, checkpoint_dir=ck, checkpoint_every=1)
    good = coach.run(epochs=2)
    assert np.isfinite(good["Recall"]) and coach.ckpt.latest_epoch() == 1
    coach.config.train.lr = float("nan")
    with pytest.raises(FloatingPointError, match="diverged at epoch 2"):
        coach.run(epochs=4)
    assert coach.ckpt.latest_epoch() == 1
    again = _coach(cfg, checkpoint_dir=ck, checkpoint_every=1)
    final = again.run(epochs=4)
    assert np.isfinite(final["Recall"]) and np.isfinite(final["NDCG"])
    assert again.ckpt.latest_epoch() == 3
    assert tck.CheckpointManager(ck).epochs() == [1, 2, 3]  # max_to_keep 3


def test_fused_and_single_checkpoints_interchangeable(tmp_path):
    """A single-epoch checkpoint resumes into fused chunks ([2, 3], [4, 5])
    and ends where the all-single run does, exactly."""
    cfg = _config(tstEpoch=2)
    full = _coach(cfg)
    full.run(epochs=6)
    ck = str(tmp_path / "ck")
    first = _coach(cfg, checkpoint_dir=ck)
    first.total_epochs = 6
    for epoch in range(2):
        first.train_epoch(epoch)
    first.save_checkpoint(1, {})
    second = _coach(_config(tstEpoch=2, epoch_scan=2), checkpoint_dir=ck)
    chunks = []
    fused = second.train_epochs_fused
    second.train_epochs_fused = lambda e, n, s=None: chunks.append((e, n)) or fused(e, n, s)
    second.run(epochs=6)
    assert chunks == [(2, 2), (4, 2)]
    _assert_same(full, second)


def test_reset_equals_a_new_coach():
    cfg = _config()
    coach = _coach(cfg)
    coach.train_epoch(0)
    coach.reset(seed=11)
    assert coach.config.base.seed == 11 and coach.modal_adjs is None and coach.best_snapshot is None
    fresh = _coach(_config())
    fresh.config.base.seed = 11
    fresh.reset()
    fresh2 = Coach(copy.deepcopy(fresh.config), fresh.host, device="cpu", log=_Lines())
    for x, y, z in zip(tree_leaves(coach.gcn_params) + tree_leaves(coach.dn_params),
                       tree_leaves(fresh.gcn_params) + tree_leaves(fresh.dn_params),
                       tree_leaves(fresh2.gcn_params) + tree_leaves(fresh2.dn_params), strict=True):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert coach.train_epoch(0) == fresh2.train_epoch(0)
    _assert_same(coach, fresh2)


def test_manager_keeps_the_newest_and_writes_whole_files(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path / "m"), max_to_keep=2)
    assert mgr.latest_epoch() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for epoch in (3, 7, 12):
        mgr.save(epoch, {"x": torch.full((2,), float(epoch)), "l": [torch.zeros(1)]}, {"epoch": epoch})
    assert mgr.epochs() == [7, 12] and mgr.latest_epoch() == 12
    assert sorted(os.listdir(mgr.directory)) == ["ckpt_00000007.pt", "ckpt_00000012.pt"]
    epoch, arrays, aux = mgr.restore()
    assert epoch == 12 and aux == {"epoch": 12} and arrays["x"].tolist() == [12.0, 12.0]
    assert mgr.restore(7)[1]["x"].tolist() == [7.0, 7.0]


def test_rng_state_json_is_the_jax_packages():
    from diffmm_tpu.utils import checkpoint as jck

    rng = np.random.default_rng(5)
    rng.permutation(10)
    assert tck.rng_state_to_json(rng) == jck.rng_state_to_json(rng)
    a, b = tck.rng_state_from_json(tck.rng_state_to_json(rng)), jck.rng_state_from_json(
        jck.rng_state_to_json(rng))
    assert a.permutation(20).tolist() == b.permutation(20).tolist() == rng.permutation(20).tolist()


def _write_conf(tmp_path):
    conf = tmp_path / "synth.toml"
    conf.write_text(
        '[base]\nlatdim = 8\nseed = 3\ndenoise_dim = "[16]"\n'
        '[data]\nname = "synthetic:40x30"\n'
        "[hyper]\nsteps = 5\n"
        "[train]\nbatch = 16\ntest_batch = 8\nepoch = 3\n"
    )
    return str(conf)


def test_cli_checkpoint_dir_saves_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the run's log directory
    # the log file handler is shared by the process and made by its first
    # Log: without this, a test that logged earlier in the same worker
    # process would hold it in its own directory
    monkeypatch.setattr(Log, "_shared_file_handler", None)
    conf, ck = _write_conf(tmp_path), str(tmp_path / "ck")
    args = ["-c", conf, "--device", "cpu", "--checkpoint-dir", ck, "--checkpoint-every", "1"]
    assert cli.main([*args, "--epochs", "2"]) == 0
    assert tck.CheckpointManager(ck).epochs() == [0, 1]
    assert cli.main([*args, "--epochs", "3"]) == 0
    assert tck.CheckpointManager(ck).epochs() == [0, 1, 2]
    _, _, aux = tck.CheckpointManager(ck).restore()
    # three epochs of ceil(40 users / 16) diffusion blocks for each denoiser
    assert aux["epoch"] == 2 and aux["dn_counts"] == [3 * 3] * len(aux["dn_counts"])
    logs = "".join((tmp_path / "logs" / name).read_text() for name in os.listdir(tmp_path / "logs"))
    assert "Resumed from checkpoint at epoch 1" in logs


def test_cli_trace_dir_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trace_dir = tmp_path / "tr"
    assert cli.main(["-c", _write_conf(tmp_path), "--device", "cpu", "--epochs", "1",
                     "--trace-dir", str(trace_dir)]) == 0
    trace = json.loads((trace_dir / "trace.json").read_text())
    names = {event.get("name") for event in trace["traceEvents"]}
    assert {"neg_sampling", "diffusion", "rebuild", "joint", "eval"} <= names
    spans = json.loads((trace_dir / "spans.json").read_text())
    assert {"tables", "neg_sampling", "diffusion", "rebuild", "joint", "readback", "eval"} <= {
        s["name"] for s in spans} <= names
    assert all(s["enter_ns"] <= s["exit_ns"] and s["device_s"] is None for s in spans)
