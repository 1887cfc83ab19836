"""Port config (diffmm_tpu_torch/config.py) against diffmm_tpu/config.py:
every shipped toml loads to the same values, overrides agree, and the
execution knobs the port once refused are accepted and run (their parity
with the JAX package: tests/test_torch_int4.py, _knobs.py, _knn.py)."""

import copy
import dataclasses
import glob
import os

import numpy as np
import pytest

from diffmm_tpu import config as jcfg
from diffmm_tpu_torch import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOMLS = sorted(glob.glob(os.path.join(REPO, "conf", "*.toml")))


@pytest.mark.parametrize("path", TOMLS, ids=[os.path.basename(p) for p in TOMLS])
def test_every_toml_loads_to_the_same_values(path):
    got = dataclasses.asdict(tcfg.load_config(path))
    want = jcfg.config_to_dict(jcfg.load_config(path))
    assert got == want
    assert tcfg.load_config(path).base.denoise_dims() == jcfg.load_config(path).base.denoise_dims()


def test_schema_and_aliases_match():
    for t, j in ((tcfg.BaseConfig, jcfg.BaseConfig), (tcfg.DataConfig, jcfg.DataConfig),
                 (tcfg.HyperConfig, jcfg.HyperConfig), (tcfg.TrainConfig, jcfg.TrainConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(t)] == [
            (f.name, f.default) for f in dataclasses.fields(j)
        ]
    assert tcfg._LEGACY_ALIASES == jcfg._LEGACY_ALIASES
    raw = {"hyper": {"sampling_steps": 3, "e_loss": 0.7, "keepRate": 1}}
    assert dataclasses.asdict(tcfg.config_from_dict(raw)) == jcfg.config_to_dict(
        jcfg.config_from_dict(raw)
    )
    with pytest.raises(ValueError):
        tcfg.config_from_dict({"train": {"nope": 1}}, strict=True)


def test_overrides_match():
    overrides = ["hyper.steps=7", "train.lr=0.01", "seed=3", "train.use_lr_scheduler=false",
                 "noise_scale=0.2", "base.denoise_dim=[64]"]
    got = tcfg.apply_overrides(tcfg.Config(), overrides)
    want = jcfg.apply_overrides(jcfg.Config(), overrides)
    assert dataclasses.asdict(got) == jcfg.config_to_dict(want)
    with pytest.raises(ValueError):
        tcfg.apply_overrides(tcfg.Config(), ["no_equals"])
    with pytest.raises(ValueError):
        tcfg.apply_overrides(tcfg.Config(), ["train.use_lr_scheduler=maybe"])


@pytest.mark.parametrize(
    "section,key,value",
    [
        ("base", "denoise_param_dtype", "bf16"),
        ("train", "rebuild_compute", "bf16"),
        ("train", "dense_store", "int4"),
        ("base", "denoise_dim", "[64, 32]"),
        ("hyper", "use_knn_adj", True),
    ],
)
def test_unported_settings_raise(section, key, value):
    """Each setting the port once refused is accepted by
    ``check_slice_support`` and runs: one epoch and an eval of a tiny Coach
    on the CPU, finite. (The name is the one the refusal test had.)"""
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.train.coach import Coach

    cfg = tcfg.Config()
    tcfg.check_slice_support(cfg)  # defaults are supported
    cfg.base.latdim, cfg.base.denoise_dim = 16, "[32]"
    cfg.train.batch, cfg.train.test_batch = 16, 8
    setattr(getattr(cfg, section), key, value)
    tcfg.check_slice_support(cfg)
    host = make_synthetic_host_data(copy.deepcopy(cfg), user_num=30, item_num=25, seed=1)
    coach = Coach(cfg, host, device="cpu")
    losses = coach.train_epoch(0)
    assert all(np.isfinite(v) for v in losses.values())
    assert 0.0 <= coach.test_epoch()["Recall"] <= 1.0
    if isinstance(value, str) and key != "denoise_dim":
        setattr(getattr(cfg, section), key, value + "x")
        with pytest.raises(ValueError, match=key):
            tcfg.check_slice_support(cfg)
