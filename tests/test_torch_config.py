"""Port config (diffmm_tpu_torch/config.py) against diffmm_tpu/config.py:
every shipped toml loads to the same values, overrides agree, and the
settings this slice cannot honour raise NotImplementedError."""

import dataclasses
import glob
import os

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
    cfg = tcfg.Config()
    tcfg.check_slice_support(cfg)  # defaults are supported
    setattr(getattr(cfg, section), key, value)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcfg.check_slice_support(cfg)
