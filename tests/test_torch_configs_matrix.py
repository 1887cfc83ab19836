"""Every shipped config trains the port one epoch, after
``tests/test_configs_matrix.py``: each ``conf/*.toml`` (loaded strict)
with that config's hyperparameters at a narrow width, on a 40 x 30
synthetic dataset with two modalities, on the CPU: finite losses, and an
eval whose metrics are in [0, 1]. The config loads to the JAX package's
values (``tests/test_torch_config.py``); here it also runs.
"""

import glob
import os

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.config import load_config
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
from diffmm_tpu_torch.train.coach import Coach
from diffmm_tpu_torch.utils.logging import NullLog

CONFS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "conf", "*.toml")))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors: beside the other test
    workers, several threads a process spin against each other (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_every_shipped_config_is_listed():
    assert len(CONFS) >= 8


@pytest.mark.parametrize("path", CONFS, ids=[os.path.basename(p) for p in CONFS])
def test_config_trains_one_epoch(path):
    cfg = load_config(path, strict=True)
    cfg.base.latdim = 8
    cfg.base.denoise_dim = "[16]"
    cfg.train.batch = 16
    cfg.train.test_batch = 8
    host = make_synthetic_host_data(cfg, user_num=40, item_num=30, seed=1, modalities=["image", "text"],
                                    feat_dims=[12, 10])
    coach = Coach(cfg, host, device="cpu", log=NullLog())
    res = coach.train_epoch(0)
    assert all(np.isfinite(v) for v in res.values()), res
    metrics = coach.test_epoch()
    assert all(0.0 <= metrics[k] <= 1.0 for k in ("Recall", "NDCG", "Precision")), metrics
