"""Accuracy at scale of the port's sparse form, after
``tests/test_scale_accuracy.py``: a sports-shaped (35,598 x 18,357)
structured synthetic (made bit-identically to the JAX package's,
``data/synthetic.py``) trained one epoch on the sparse form on the CPU must
clear the JAX test's floors, Recall@20 > 0.15 and NDCG@20 > 0.07 (random
ranking is 20/18357 = 0.0011; the JAX package lands at 0.28-0.29). A
layout or plan fault that zeroed or misrouted edges of the CSR store, K4's
plain version or the rebuilt graphs would land near random.
"""

import pytest

from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
from diffmm_tpu_torch.train.coach import Coach
from diffmm_tpu_torch.utils.logging import NullLog

SPORTS_USERS, SPORTS_ITEMS = 35_598, 18_357
SPORTS_DENSITY = 256_308 / (SPORTS_USERS * SPORTS_ITEMS)


@pytest.mark.slow  # one epoch at 35,598 x 18,357 on the CPU takes minutes
def test_sports_shape_structured_recall_floor():
    cfg = Config()
    cfg.base.seed = 5
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.hyper.steps = 5
    cfg.train.batch = 4096
    cfg.train.test_batch = 512
    cfg.train.epoch = 1
    cfg.train.graph_form = "sparse"
    host = make_synthetic_host_data(cfg, user_num=SPORTS_USERS, item_num=SPORTS_ITEMS, density=SPORTS_DENSITY,
                                    structure_rank=8, seed=5, modalities=["image", "text"], feat_dims=[32, 32])
    assert host._train_dense is None  # the large structured mode stays O(nnz)
    coach = Coach(cfg, host, device="cpu", log=NullLog())
    assert coach.train_store_form == "csr"
    coach.train_epoch(0)
    result = coach.test_epoch()
    assert result["Recall"] > 0.15, result
    assert result["NDCG"] > 0.07, result
