"""The port's validation-split eval, after ``tests/test_val_split.py``
(additive: the reference ships valMat.pkl but never loads it,
`DataHandler.py:30-31`). A toy dataset with a ``valMat`` loads to the JAX
package's host arrays, validation split included; the port's Coach
evaluates ``split="val"`` and ``"test"`` after an epoch, refuses an
unknown split and a dataset without a ``valMat``; ``missing_modalities=
"drop"`` trains without the unshipped blob.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import scipy.sparse as sp

from diffmm_tpu.config import Config as JConfig
from diffmm_tpu.data import loader as jl
from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data import loader
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
from diffmm_tpu_torch.train.coach import Coach
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


def _write_ds(tmp_path, user_num=30, item_num=24, seed=0):
    rng = np.random.default_rng(seed)
    d = tmp_path / "toyset"
    d.mkdir()

    def mat(density):
        dense = (rng.random((user_num, item_num)) < density).astype(np.float32)
        dense[:, 0] = 1.0  # every user trains on >= 1 item
        return sp.coo_matrix(dense)

    for name, density in (("trnMat.pkl", 0.2), ("valMat.pkl", 0.05), ("tstMat.pkl", 0.05)):
        with open(d / name, "wb") as fh:
            pickle.dump(mat(density), fh)
    np.save(d / "image_feat.npy", rng.standard_normal((item_num, 8)).astype(np.float32))
    np.save(d / "text_feat.npy", rng.standard_normal((item_num, 6)).astype(np.float32))
    return str(tmp_path)


def _toyset(tmp_path, monkeypatch, seed=0) -> str:
    root = _write_ds(tmp_path, seed=seed)
    monkeypatch.setenv("DIFFMM_DATA_ROOT", root)
    monkeypatch.setitem(loader.MODALITIES, "toyset", ["image", "text"])
    monkeypatch.setitem(jl.MODALITIES, "toyset", ["image", "text"])
    return root


def _config(cfg):
    cfg.data.name = "toyset"
    cfg.base.latdim = 8
    cfg.base.denoise_dim = "[16]"
    cfg.train.batch = 16
    cfg.train.test_batch = 8
    return cfg


def test_group_eval_split_basic():
    mat = sp.coo_matrix((np.ones(4, np.float32), ([2, 0, 2, 5], [1, 3, 0, 2])), shape=(6, 4))
    users, items, counts = loader.group_eval_split(mat)
    np.testing.assert_array_equal(users, [0, 2, 5])
    np.testing.assert_array_equal(counts, [1, 2, 1])
    assert items.shape == (3, 2)
    np.testing.assert_array_equal(items[1], [0, 1])
    assert items[0, 1] == -1


def test_val_split_loads_as_jax(tmp_path, monkeypatch):
    _toyset(tmp_path, monkeypatch)
    host = loader.load_host_data(_config(Config()))
    want = jl.load_host_data(_config(JConfig()))
    for name in ("val_users", "val_items", "val_counts", "test_users", "test_items", "test_counts"):
        np.testing.assert_array_equal(getattr(host, name), getattr(want, name), err_msg=name)


def test_val_split_eval(tmp_path, monkeypatch):
    _toyset(tmp_path, monkeypatch)
    cfg = _config(Config())
    host = loader.load_host_data(cfg)
    assert host.val_users is not None
    coach = Coach(cfg, host, device="cpu", log=NullLog())
    coach.train_epoch(0)
    m_test = coach.test_epoch("test")
    m_val = coach.test_epoch("val")
    for m in (m_test, m_val):
        assert 0.0 <= m["Recall"] <= 1.0
    with pytest.raises(ValueError, match="unknown eval split"):
        coach.test_epoch("train")


def test_val_missing_raises():
    cfg = Config()
    cfg.base.latdim, cfg.base.denoise_dim, cfg.train.batch, cfg.train.test_batch = 16, "[32]", 16, 8
    host = make_synthetic_host_data(cfg, user_num=50, item_num=40, seed=3)
    coach = Coach(cfg, host, device="cpu", log=NullLog())
    coach.train_epoch(0)
    with pytest.raises(ValueError, match="no valMat"):
        coach.test_epoch("val")


def test_drop_missing_modalities(tmp_path, monkeypatch):
    """``data.missing_modalities="drop"`` trains without the unshipped blob."""
    root = _toyset(tmp_path, monkeypatch, seed=4)
    os.remove(os.path.join(root, "toyset", "text_feat.npy"))
    cfg = _config(Config())
    cfg.data.missing_modalities = "drop"
    host = loader.load_host_data(cfg)
    assert host.modalities == ["image"]
    assert host.synthesized == ["text (dropped)"]
    res = Coach(cfg, host, device="cpu", log=NullLog()).train_epoch(0)
    assert "text loss" not in res and "image loss" in res
