"""The port's CLI (``python -m diffmm_tpu_torch``), after
``tests/test_cli.py``: ``--set`` overrides, a bare key going to
``[hyper]``, the fused epoch chunks they turn on; an unknown field stops
with the parser's error; a missing config file exits 1. (The JAX file's
end-to-end run with checkpoints and an exported index:
``tests/test_torch_train_slice.py``, ``tests/test_torch_checkpoint.py``.)"""

import pytest
import torch

from diffmm_tpu_torch.cli import main

CONF = """
[base]
latdim = 8
seed = 3
denoise_dim = "[16]"

[data]
name = "synthetic:40x30"

[hyper]
steps = 5

[train]
batch = 16
test_batch = 8
epoch = 4
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors: beside the other test
    workers, several threads a process spin against each other (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_set_overrides(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    conf = tmp_path / "synth.toml"
    conf.write_text(CONF)
    assert main(["-c", str(conf), "--device", "cpu", "--set", "train.epoch_scan=2", "--set", "train.tstEpoch=2",
                 "--set", "noise_degree=0.4"]) == 0
    out = capsys.readouterr().out
    assert "epoch_scan: 2" in out and "tstEpoch: 2" in out and "noise_degree: 0.4" in out
    assert "Epoch 3/4, ⏩ Train" in out and "fused=" in out  # two chunks of two epochs
    assert "Epoch 2/4, 🧪 Test" in out and "Epoch 1/4, 🧪 Test" not in out  # every second epoch


def test_cli_set_unknown_field(tmp_path, capsys):
    conf = tmp_path / "synth.toml"
    conf.write_text('[data]\nname = "synthetic:40x30"\n')
    with pytest.raises(SystemExit):
        main(["-c", str(conf), "--device", "cpu", "--set", "train.no_such_field=1"])
    assert "unknown config field" in capsys.readouterr().err


def test_cli_bad_config_exit_code(tmp_path):
    assert main(["-c", str(tmp_path / "missing.toml"), "--device", "cpu"]) == 1
