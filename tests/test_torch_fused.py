"""``train.epoch_scan``: the port's fused chunks (``Coach.train_epochs_fused``,
``_chunk_size``, ``run``'s chunk branch) against its single epochs and the
JAX package's Coach, after tests/test_fused_epochs.py:39, 86, 99, 180, 206.

The contract is the JAX one: a chunk draws the torch generator and the numpy
stream exactly as its epochs one at a time would. On the CPU the two paths
run the same operations in the same order, so they are held exactly equal
(no tolerance), on both graph forms and with the sparse form's bf16 messages: losses, parameters, Adam moments and counts, edge buffers,
eval metrics, the generator's state and the numpy stream's. ``_chunk_size``
gives the JAX Coach's answers on the same cases. The numpy stream after a
fused chunk equals the JAX package's after its own chunk (``slow``: it
compiles the JAX fused program).
"""

import copy

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
from diffmm_tpu_torch.train.coach import Coach
from diffmm_tpu_torch.train.optim import tree_leaves


class _Quiet:
    def info(self, message):
        pass


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


def _host(cfg):
    return make_synthetic_host_data(cfg, user_num=50, item_num=40, seed=3)


def _pair(cfg, **kwargs):
    host = _host(cfg)
    return (Coach(copy.deepcopy(cfg), host, device="cpu", log=_Quiet(), **kwargs),
            Coach(copy.deepcopy(cfg), host, device="cpu", log=_Quiet(), **kwargs))


def _tensors(coach):
    out = tree_leaves(coach.gcn_params) + tree_leaves(coach.dn_params)
    for state in (coach.gcn_opt_state, *coach.dn_opt_states):
        out += state.mu + state.nu
    return out + list(coach.edge_buffers)


def assert_same_state(a, b):
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.np_rng.bit_generator.state == b.np_rng.bit_generator.state
    assert a.gcn_opt_state.count == b.gcn_opt_state.count
    assert [s.count for s in a.dn_opt_states] == [s.count for s in b.dn_opt_states]
    for x, y in zip(_tensors(a), _tensors(b), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("form", ["dense", "sparse", "sparse-bf16"])
def test_fused_equals_single_epochs(form):
    """Also on the sparse form with bf16 messages (``train.segsum_compute``,
    the JAX bench's sparse setting): the casts in the steps' backward run
    alike in both paths."""
    form, _, compute = form.partition("-")
    single, fused = _pair(_config(form, segsum_compute=compute or "f32"))
    single.total_epochs = fused.total_epochs = 4
    want = [single.train_epoch(e) for e in range(3)]
    got = fused.train_epochs_fused(0, 3)
    assert got == want
    assert_same_state(single, fused)
    assert fused.test_epoch() == single.test_epoch()


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_fused_eval_keeps_the_first_best(form):
    """Evals on the chunk's tstEpoch boundaries equal test_epoch after each
    single epoch; the kept state is the first best-Recall epoch's."""
    single, fused = _pair(_config(form, tstEpoch=1))
    single.total_epochs = fused.total_epochs = 3
    want, want_eval, snaps = [], [], []
    for e in range(3):
        want.append(single.train_epoch(e))
        want_eval.append(single.test_epoch())
        single.capture_best(e)
        snaps.append(single.best_snapshot)
    got, got_eval, (best_recall, best_g, best_bufs) = fused.train_epochs_fused(0, 3, "test")
    assert got == want and got_eval == want_eval
    assert_same_state(single, fused)
    recalls = [r["Recall"] for r in want_eval]
    first_best = recalls.index(max(recalls))
    n_test = int(single.data.test_users.shape[0])
    assert float(best_recall) / n_test == max(recalls)
    snap = snaps[first_best]
    for x, y in zip(tree_leaves(best_g), tree_leaves(snap["gcn_params"]), strict=True):
        assert torch.equal(x, y)
    for x, y in zip(best_bufs, snap["edge_buffers"], strict=True):
        assert torch.equal(x, y)


def test_fused_eval_flags_follow_tst_epoch():
    single, fused = _pair(_config(tstEpoch=2))
    fused.total_epochs = 4
    _, evals, bundle = fused.train_epochs_fused(1, 3, "test")
    assert [e is None for e in evals] == [True, False, True]
    assert bundle is not None
    _, evals, bundle = single.train_epochs_fused(1, 1, "test")
    assert evals == [None] and bundle is None


def test_chunk_size_matches_jax(tiny_config, tmp_path):
    """The JAX Coach's ``_chunk_size`` answers (tests/test_fused_epochs.py:
    99) from the port's Coach on the same cases: full windows only, tails
    and checkpoint boundaries inside a window run single. The JAX method
    runs on a stand-in holding what it reads (the config, whether
    checkpoints are on, their interval), which skips building a JAX
    Coach; the port's runs on a Coach made with checkpoints every 4
    epochs."""
    from types import SimpleNamespace

    from diffmm_tpu.train.coach import Coach as JCoach

    cfg = _config()
    t = Coach(cfg, _host(cfg), device="cpu", log=_Quiet(), checkpoint_dir=str(tmp_path / "t"),
              checkpoint_every=4)
    ckpt = t.ckpt
    jcfg = copy.deepcopy(tiny_config)
    cases = [(e, n) for n in (6, 10) for e in range(n)]
    for scan, ck_every in ((3, None), (3, 4), (2, 3), (4, 1), (1, None)):
        jcfg.train.epoch_scan = cfg.train.epoch_scan = scan
        t.ckpt = ckpt if ck_every is not None else None
        t.checkpoint_every = ck_every or 4
        j = SimpleNamespace(config=jcfg, ckpt=t.ckpt, checkpoint_every=t.checkpoint_every)
        assert ([t._chunk_size(e, n) for e, n in cases]
                == [JCoach._chunk_size(j, e, n) for e, n in cases]), (scan, ck_every)


def test_run_fused_every_epoch_picks_the_same_best():
    """tstEpoch=1 (the reference cadence): ``run`` over chunks of 4 picks
    the best epoch of the single-epoch ``run``, with the same metrics and
    the same snapshot."""
    plain, fused = _pair(_config(tstEpoch=1))
    fused.config.train.epoch_scan = 4
    want = plain.run(epochs=4)
    got = fused.run(epochs=4)
    assert got == want
    assert fused.best_snapshot["epoch"] == plain.best_snapshot["epoch"] == want["best_epoch"]
    for x, y in zip(tree_leaves(fused.best_snapshot["gcn_params"]),
                    tree_leaves(plain.best_snapshot["gcn_params"]), strict=True):
        assert torch.equal(x, y)
    assert_same_state(plain, fused)


@pytest.mark.slow
def test_fused_numpy_stream_matches_jax(tiny_config, tiny_data):
    """After a fused chunk of two epochs, the port's numpy stream is where
    the JAX Coach's is after its own chunk: both draw each epoch's user
    permutation, then its interaction permutation."""
    from diffmm_tpu.train.coach import Coach as JCoach

    j = JCoach(copy.deepcopy(tiny_config), tiny_data)
    j.total_epochs = 2
    j.train_epochs_fused(0, 2)
    cfg = _config()
    t = Coach(cfg, _host(cfg), device="cpu", log=_Quiet())
    t.total_epochs = 2
    t.train_epochs_fused(0, 2)
    assert t.np_rng.bit_generator.state == j.np_rng.bit_generator.state
    assert np.isfinite([v for r in t.train_epochs_fused(2, 1) for v in r.values()]).all()
