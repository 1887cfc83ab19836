"""Port host data (diffmm_tpu_torch/data) against diffmm_tpu/data: the host
arrays are bit-identical on tiktok_mini, baby_mini and synthetic shapes,
including the svd/svd_tfidf feature synthesis; to_device keeps them."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from diffmm_tpu.config import Config as JConfig
from diffmm_tpu.data import loader as jl
from diffmm_tpu.data.synthetic import make_synthetic_host_data as j_synth
from diffmm_tpu_torch.config import Config as TConfig
from diffmm_tpu_torch.data import loader as tl
from diffmm_tpu_torch.data.membership import gather_rows
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data as t_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")


def assert_host_equal(t, j, dense: bool = True):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "raw_feats":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    if dense:
        np.testing.assert_array_equal(t.train_dense, j.train_dense)


@pytest.mark.parametrize("name", ["tiktok_mini", "baby_mini"])
def test_real_mini_datasets_match(name):
    tc, jc = TConfig(), JConfig()
    tc.data.name = jc.data.name = name
    t = tl.load_host_data(tc, data_root=DATA)
    j = jl.load_host_data(jc, data_root=DATA)
    assert_host_equal(t, j)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(user_num=50, item_num=40, seed=3),
        dict(user_num=64, item_num=33, density=0.1, seed=11, modalities=["image", "text"],
             feat_dims=[8, 12]),
        dict(user_num=40, item_num=30, density=0.08, seed=2, structure_rank=4),
        # past U·I = 2e8: the edge-wise branch that draws every web-scale shape
        dict(user_num=20_000, item_num=10_001, density=1e-4, seed=4, modalities=["image", "text"],
             feat_dims=[8, 8]),
    ],
    ids=["default", "two_modal", "structured", "edge_wise"],
)
def test_synthetic_is_bit_identical(kwargs):
    t, j = t_synth(TConfig(), **kwargs), j_synth(JConfig(), **kwargs)
    # the edge-wise branch builds no (U, I) matrix; its edges are compared
    edge_wise = kwargs["user_num"] * kwargs["item_num"] > 2 * 10**8
    assert (t._train_dense is None) == (j._train_dense is None) == edge_wise
    assert_host_equal(t, j, dense=not edge_wise)


def test_synthetic_by_name_matches():
    tc, jc = TConfig(), JConfig()
    tc.data.name = jc.data.name = "synthetic:60x45x0.07"
    tc.base.seed = jc.base.seed = 5
    assert_host_equal(tl.load_host_data(tc), jl.load_host_data(jc))


@pytest.mark.parametrize("mode", ["zeros", "randn", "svd", "svd_tfidf"])
def test_feature_synthesis_matches(mode, monkeypatch):
    monkeypatch.setenv("DIFFMM_FEAT_CACHE", "0")
    train = jl.load_interactions(os.path.join(DATA, "baby_mini", "trnMat.pkl"))
    # rank-capped: the Lanczos run is the expensive part
    kw = dict(mode=mode, train=train, svd_rank=8)
    got = tl._synthesize_features("baby", "text", train.shape[1], **kw)
    want = jl._synthesize_features("baby", "text", train.shape[1], **kw)
    assert got.shape == want.shape == (train.shape[1], 1024)
    np.testing.assert_array_equal(got, want)


def test_eval_split_and_pad_edges_match():
    test = jl.load_interactions(os.path.join(DATA, "tiktok_mini", "tstMat.pkl"))
    for a, b in zip(tl.group_eval_split(test), jl.group_eval_split(test)):
        np.testing.assert_array_equal(a, b)
    rows = np.array([0, 0, 1, 2], dtype=np.int32)
    cols = np.array([1, 3, 0, 2], dtype=np.int32)
    for a, b in zip(tl.pad_edges(rows, cols, 3, 4, 8), jl.pad_edges(rows, cols, 3, 4, 8)):
        np.testing.assert_array_equal(a, b)


def test_to_device_and_gather_rows():
    host = t_synth(TConfig(), user_num=50, item_num=40, seed=3)
    dev = tl.to_device(host, "cpu")
    rows_p, cols_p = tl.pad_edges(host.train_rows, host.train_cols, 50, 40)
    np.testing.assert_array_equal(dev.train_rows.numpy(), rows_p)
    np.testing.assert_array_equal(dev.train_cols.numpy(), cols_p)
    assert dev.train_store.dtype == torch.int8
    users = torch.tensor([3, 0, 49, 3])
    got = gather_rows(dev.train_store, users, 40)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), host.train_dense[[3, 0, 49, 3]].astype(np.float32))
    # the CSR store gives the same rows
    csr = tl.to_device(host, "cpu", train_store="csr", with_sparse_adj=True)
    np.testing.assert_array_equal(gather_rows(csr.train_store, users, 40).numpy(), got.numpy())
    assert csr.adj.ui_rows.shape == (len(rows_p),) and dev.adj is None
    with pytest.raises(ValueError, match="dense|csr"):
        tl.to_device(host, "cpu", train_store="coo")
