"""The port's sweep harness (``diffmm_tpu_torch/tools/sweep.py``) after
``tests/test_sweep_tool.py``: the same config resolution, casts,
``DYNAMIC_SAFE`` set, refusals and seed spellings, run on the port's own
``Config``, with the JAX tool's answers beside them where both can give
one.

Then what the JAX test leaves to the end-to-end runs, on the CPU at a tiny
size: a reused-Coach sweep of two values equals two fresh Coaches, one per
value (losses, metrics and parameters, bitwise), for a hyper the steps
read, for ``sampling_step`` and for ``train.lr``; the single-param and
plan modes write the JAX tool's JSON; a ``--forked`` run of two values
completes, and each JSON the tool writes renders in
``tools/plot_sweeps.py``.
"""

import copy
import importlib.util
import json
import os

import pytest
import torch

from diffmm_tpu_torch.config import Config, load_config
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
from diffmm_tpu_torch.tools import sweep as sweep_tool
from diffmm_tpu_torch.train.coach import Coach
from diffmm_tpu_torch.train.optim import tree_leaves
from diffmm_tpu_torch.utils.logging import NullLog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors: beside the other test
    workers, several threads a process spin against each other (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_resolve_bare_defaults_to_hyper():
    cfg = Config()
    obj, key = sweep_tool._resolve(cfg, "noise_degree")
    assert obj is cfg.hyper and key == "noise_degree"


def test_resolve_qualified_sections():
    cfg = Config()
    assert sweep_tool._resolve(cfg, "base.latdim") == (cfg.base, "latdim")
    assert sweep_tool._resolve(cfg, "train.batch") == (cfg.train, "batch")
    assert sweep_tool._resolve(cfg, "data.missing_modalities") == (cfg.data, "missing_modalities")


def test_resolve_unknown_field_exits():
    with pytest.raises(SystemExit):
        sweep_tool._resolve(Config(), "hyper.not_a_knob")


def test_cast_values_uses_field_type():
    cfg = Config()
    assert sweep_tool._cast_values(cfg, "hyper.steps", "3,5") == [3, 5]
    assert sweep_tool._cast_values(cfg, "noise_degree", "0.5,1.5") == [0.5, 1.5]
    assert sweep_tool._cast_values(cfg, "seed", "7,8") == [7, 8]


def test_structural_param_rejected_without_fork():
    """A structural knob swept on a reused Coach would keep its old value:
    the tool refuses before it builds anything."""
    with pytest.raises(SystemExit, match="compile-time"):
        sweep_tool.main(["--param", "steps", "--values", "3,5"])


def test_plan_rejects_structural_param():
    with pytest.raises(SystemExit, match="compile-time"):
        sweep_tool.main(["--plan", "steps=3,5"])


def test_resolve_bare_seed_maps_to_base():
    cfg = Config()
    assert sweep_tool._resolve(cfg, "seed") == (cfg.base, "seed")


def test_resolve_unknown_section_exits_cleanly():
    with pytest.raises(SystemExit, match="unknown config field"):
        sweep_tool._resolve(Config(), "trian.batch")


def test_bool_cast_parses_false():
    assert sweep_tool._cast(bool, "False") is False
    assert sweep_tool._cast(bool, "true") is True
    assert sweep_tool._cast(bool, "0") is False
    with pytest.raises(SystemExit):
        sweep_tool._cast(bool, "maybe")
    cfg = Config()
    assert sweep_tool._cast_values(cfg, "train.use_lr_scheduler", "True,False") == [True, False]


def test_forked_plan_rejected():
    with pytest.raises(SystemExit, match="not supported"):
        sweep_tool.main(["--forked", "--plan", "steps=3,5"])


def test_forked_set_naming_the_swept_param_rejected():
    with pytest.raises(SystemExit, match="names the swept param"):
        sweep_tool.main(["--forked", "--param", "hyper.steps", "--values", "3,5", "--set", "steps=4"])


def test_qualified_dynamic_safe_params_accepted():
    assert "train.lr" in sweep_tool.DYNAMIC_SAFE
    assert sweep_tool._cast_values(Config(), "train.lr", "0.001,0.002") == [0.001, 0.002]


def test_dynamic_safe_set_is_the_jax_tools():
    assert sweep_tool.DYNAMIC_SAFE == _load_tool("sweep").DYNAMIC_SAFE


@pytest.mark.parametrize("param", ["sim_weight", "hyper.sim_weight", "train.lr", "seed", "base.seed",
                                   "steps", "hyper.noise_scale", "base.latdim", "train.batch",
                                   "train.reg", "sampling_step"])
def test_dynamic_safe_is_spelling_independent_as_jax(param):
    from diffmm_tpu.config import Config as JaxConfig

    jax_tool = _load_tool("sweep")
    assert sweep_tool._is_dynamic_safe(Config(), param) == jax_tool._is_dynamic_safe(JaxConfig(), param)
    assert sweep_tool._is_dynamic_safe(Config(), param) == (
        param not in ("steps", "hyper.noise_scale", "base.latdim", "train.batch"))


class _FakeCoach:
    def __init__(self):
        self.reset_seeds = []

    def reset(self, seed=None):
        self.reset_seeds.append(seed)

    def run(self, epochs):
        return {"Recall": 0.1}


@pytest.mark.parametrize("spelling", ["seed", "base.seed"])
def test_sweep_one_reseeds_for_any_seed_spelling(spelling):
    """A qualified seed param ('base.seed') reaches reset(seed=value) like
    the bare 'seed'."""
    coach = _FakeCoach()
    rows = sweep_tool._sweep_one(coach, Config(), NullLog(), spelling, [7, 8], epochs=1, fresh=False)
    assert coach.reset_seeds == [7, 8]
    assert [r[spelling] for r in rows] == [7, 8]


def test_sweep_one_resets_before_every_value_after_the_first():
    coach = _FakeCoach()
    sweep_tool._sweep_one(coach, Config(), NullLog(), "residual_weight", [0.1, 0.2, 0.3], 1, fresh=False)
    assert coach.reset_seeds == [None, None]
    coach = _FakeCoach()
    sweep_tool._sweep_one(coach, Config(), NullLog(), "residual_weight", [0.1, 0.2], 1, fresh=True)
    assert coach.reset_seeds == [None, None]


def test_plan_accepts_qualified_dynamic_param():
    """Qualified spellings of dynamic-safe params are not refused: a bogus
    dataset name makes the data load fail right after the check."""
    with pytest.raises(Exception) as exc:
        sweep_tool.main(["-c", "conf/test.toml", "--device", "cpu", "--set", "data.name=no_such_dataset",
                         "--plan", "hyper.sim_weight=0.01"])
    assert "compile-time" not in str(exc.value)


# ------------------------------------------------------------ the runs
def _config() -> Config:
    cfg = Config()
    cfg.base.seed = 7
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.train.batch = 16
    cfg.train.test_batch = 8
    return cfg


@pytest.fixture(scope="module")
def host():
    return make_synthetic_host_data(_config(), user_num=40, item_num=30, seed=3)


def _recording(coach) -> list:
    """Record each epoch's losses from ``coach.run``'s calls of
    ``train_epoch``."""
    losses = []
    train_epoch = coach.train_epoch

    def record(epoch, fence=False):
        losses.append(train_epoch(epoch, fence))
        return losses[-1]

    coach.train_epoch = record
    return losses


def _params(coach) -> list:
    return tree_leaves([coach.gcn_params, coach.dn_params])


@pytest.mark.parametrize("param, values", [("residual_weight", [0.3, 0.7]), ("sampling_step", [0, 1]),
                                           ("train.lr", [1e-3, 3e-3])])
def test_reused_coach_equals_fresh_coaches(host, param, values):
    cfg = _config()
    coach = Coach(cfg, host, device="cpu", log=NullLog())
    losses = _recording(coach)
    rows = sweep_tool._sweep_one(coach, cfg, NullLog(), param, values, epochs=2, fresh=False)
    for i, value in enumerate(values):
        fresh_cfg = _config()
        obj, key = sweep_tool._resolve(fresh_cfg, param)
        setattr(obj, key, value)
        fresh = Coach(fresh_cfg, host, device="cpu", log=NullLog())
        fresh_losses = _recording(fresh)
        assert rows[i] == {param: value, **fresh.run(epochs=2)}
        assert losses[2 * i:2 * i + 2] == fresh_losses
    assert all(torch.equal(a, b) for a, b in zip(_params(coach), _params(fresh)))
    assert losses[0] != losses[2]  # the value reached the steps


def _argv(tmp_path, *extra) -> list:
    return ["-c", os.path.join(REPO, "conf", "test.toml"), "--device", "cpu", "--epochs", "1",
            "--set", "data.name=synthetic:40x30", "--set", "base.latdim=8", "--set", "base.denoise_dim=[16]",
            "--set", "train.batch=16", "--set", "train.test_batch=8", *extra]


def test_single_param_and_plan_json_render(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    single, plan = str(tmp_path / "single.json"), str(tmp_path / "plan.json")
    assert sweep_tool.main(_argv(tmp_path, "--param", "noise_degree", "--values", "0.5,1.0",
                                 "--out", single)) == 0
    assert sweep_tool.main(_argv(tmp_path, "--plan", "residual_weight=0.3,0.7;seed=1,2", "--out", plan)) == 0
    with open(single) as fh:
        doc = json.load(fh)
    assert doc["param"] == "noise_degree" and [r["noise_degree"] for r in doc["results"]] == [0.5, 1.0]
    assert {"best_epoch", "Recall", "NDCG", "Precision"} <= set(doc["results"][0])
    with open(plan) as fh:
        doc = json.load(fh)
    assert [leg["param"] for leg in doc["legs"]] == ["residual_weight", "seed"]
    assert set(doc["incumbent"]) == {"residual_weight", "seed"}
    out = str(tmp_path / "plot.png")
    assert _load_tool("plot_sweeps").main([single, plan, "--out", out]) == 0
    assert os.path.getsize(out) > 0


def test_forked_sweep_completes_and_renders(tmp_path, monkeypatch, capsys):
    """Two ``--run-once`` children, one per value of a structural knob."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the children's tensors are tiny too
    out = str(tmp_path / "forked.json")
    assert sweep_tool.main(_argv(tmp_path, "--forked", "--param", "hyper.steps", "--values", "5,3",
                                 "--out", out)) == 0
    with open(out) as fh:
        doc = json.load(fh)
    assert doc["forked"] is True and doc["param"] == "hyper.steps"
    assert [r["hyper.steps"] for r in doc["results"]] == [5, 3]
    for row in doc["results"]:
        assert "error" not in row and 0.0 <= row["Recall"] <= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == doc["results"]
    png = str(tmp_path / "forked.png")
    assert _load_tool("plot_sweeps").main([out, "--out", png]) == 0


def test_run_once_applies_the_overrides(tmp_path, monkeypatch):
    """A ``--run-once`` child trains the configuration its ``--set`` makes:
    its best equals an in-process Coach's run of it."""
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "once.json")
    assert sweep_tool.main(_argv(tmp_path, "--run-once", "--set", "hyper.steps=3", "--out", out)) == 0
    cfg = load_config(os.path.join(REPO, "conf", "test.toml"))
    for item in ("data.name=synthetic:40x30", "base.latdim=8", "base.denoise_dim=[16]", "train.batch=16",
                 "train.test_batch=8", "hyper.steps=3"):
        qual, _, raw = item.partition("=")
        obj, key = sweep_tool._resolve(cfg, qual)
        setattr(obj, key, sweep_tool._cast(type(getattr(obj, key)), raw))
    from diffmm_tpu_torch.data.loader import load_host_data

    coach = Coach(copy.deepcopy(cfg), load_host_data(cfg), device="cpu", log=NullLog())
    with open(out) as fh:
        assert json.load(fh) == coach.run(epochs=1)
