"""Real-data accuracy regression of the port on the committed baby
subsample, after ``tests/test_regression_baby_mini.py``: ``data/baby_mini``
(the first 2,000 baby users against the whole 7,050-item catalog; both
feature blobs synthesised, svd mode), four epochs with a small model on the
CPU, Recall@20 in the JAX test's band 0.006-0.018 (random ranking is about
20/7050 = 0.003, so the floor fails a no-op joint phase, and the ceiling
flags an inflated eval). The JAX package's random streams cannot be matched
(ROADMAP.md "Rules"), so the band is the comparison; ``chip_smoke.py``
path G runs it on the card and records the seeds around it.
"""

import os

import pytest

from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.loader import load_host_data
from diffmm_tpu_torch.train.coach import Coach
from diffmm_tpu_torch.utils.logging import NullLog

pytestmark = pytest.mark.slow  # four epochs of 2,000 x 7,050 on the CPU take well over 10 s

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "data", "baby_mini")


@pytest.mark.skipif(not os.path.isdir(MINI), reason="baby_mini slice not present")
def test_baby_mini_four_epoch_recall_band():
    cfg = Config()
    cfg.data.name = "baby_mini"
    cfg.data.missing_modalities = "svd"
    cfg.base.seed = 1818
    cfg.base.latdim = 32
    cfg.base.denoise_dim = "[64]"
    cfg.train.batch = 512
    cfg.train.test_batch = 512
    cfg.train.epoch = 4

    host = load_host_data(cfg, data_root=os.path.join(REPO, "data"))
    assert host.user_num == 2000 and host.item_num == 7050
    assert host.synthesized == ["image", "text"]
    coach = Coach(cfg, host, device="cpu", log=NullLog())
    for epoch in range(4):
        coach.train_epoch(epoch)
    result = coach.test_epoch()
    assert 0.006 <= result["Recall"] <= 0.018, result
