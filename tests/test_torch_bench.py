"""The port's bench (``python -m diffmm_tpu_torch.bench``) against the JAX
package's ``bench.py``.

On the CPU at a tiny synthetic (``--device cpu``, ``BENCH_SET`` of
``data.name=synthetic:64x48`` with a small latdim and hidden width, 2
epochs, fused chunks of 2) it prints one JSON line whose keys, nested keys
included, are the JAX bench's: pinned here from ``bench.py:221-256`` (read
from its source) and, in a ``slow`` test, taken from the line ``bench.py``
prints under ``JAX_PLATFORMS=cpu`` with the same ``BENCH_SET`` (its run
compiles for about half a minute). The sparse rows run the CSR store; the
roofline fraction is the card's only (null on the CPU); the baseline ratio
is null on synthetic data. Without a card and without ``--device cpu`` it
raises, before any data is made.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from diffmm_tpu_torch import bench

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = {
    "BENCH_EPOCHS": "2", "BENCH_FUSED": "2", "BENCH_SPARSE_FUSED": "2",
    "BENCH_SET": "data.name=synthetic:64x48,base.latdim=16,base.denoise_dim=[32],"
                 "train.batch=16,train.test_batch=16",
}
PHASES = {"neg_sampling", "diffusion", "rebuild", "joint"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny tensors (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _key_tree(obj):
    """The nested key structure of a JSON value: dicts by their keys, the
    rest as None."""
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return None


def _jax_bench_keys():
    """The keys of the dict ``bench.py`` dumps (its lines 221-256), read from
    its source: the top level and ``detail``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and isinstance(node.args[0], ast.Dict)):
            top = node.args[0]
            detail = next(v for k, v in zip(top.keys, top.values) if k.value == "detail")
            return {k.value for k in top.keys}, {k.value for k in detail.keys}
    raise AssertionError("bench.py dumps no dict literal")


def _port_line(monkeypatch, capsys):
    for key, value in TINY.items():
        monkeypatch.setenv(key, value)
    sections = {}
    assert bench.main(["--device", "cpu"], sections=sections) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0]), sections


def test_bench_line_on_cpu(monkeypatch, capsys):
    line, sections = _port_line(monkeypatch, capsys)
    top, detail = _jax_bench_keys()
    assert set(line) == top and set(line["detail"]) == detail
    d = line["detail"]
    assert set(d["phase_seconds_median_steady"]) == PHASES == set(d["phase_seconds_fenced"])
    assert d["sparse_train_store"] == "csr"
    assert d["joint_hbm_roofline_fraction"] is None
    assert line["vs_baseline"] is None and d["baseline_epoch_seconds"] == 85.64
    assert d["device"] == "cpu" and line["unit"] == "epochs/hr"
    assert d["headline_path"] in ("single_epoch", "fused_epoch_scan2")
    assert len(d["epoch_seconds_all"]) == 2
    times = [line["value"], d["headline_epoch_seconds"], d["fused_epoch_seconds_median"],
             d["sparse_epoch_seconds_median"], d["sparse_fused_epoch_seconds_median"]]
    assert all(t > 0 for t in times), times
    # the headline is the faster of the single and the fused epoch
    assert d["headline_epoch_seconds"] == min(d["epoch_seconds_median_steady"], d["fused_epoch_seconds_median"])
    assert set(sections) == {"dense", "sparse"}


@pytest.mark.slow  # the JAX bench compiles its programs on the CPU for about 30 s
def test_bench_keys_match_jax_bench(monkeypatch, capsys):
    port, _ = _port_line(monkeypatch, capsys)
    env = {**os.environ, **TINY, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(REPO / "bench.py")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    jax_line = json.loads(out.stdout.strip().splitlines()[-1])
    assert _key_tree(port) == _key_tree(jax_line)


def test_pinned_medians_are_the_jax_formula():
    """sorted(v)[len(v) // 2] (bench.py:182-190), not the mean of the middle
    pair that numpy's median takes for an even count."""
    assert bench._median([4.0, 1.0, 3.0, 2.0]) == 3.0
    assert bench._median_steady([9.0, 4.0, 1.0, 3.0, 2.0]) == 3.0
    assert bench._median_steady([5.0]) == 5.0


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_bench_raises_without_cuda_unless_cpu(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])


def test_synthetic_without_cpu_raises_before_any_data(monkeypatch):
    _no_cuda(monkeypatch)

    def no_data(*args, **kwargs):
        raise AssertionError("data made before the device was resolved")

    monkeypatch.setattr(bench, "host_data", no_data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--synthetic", "tiktok"])


def test_missing_data_names_the_synthetic_option(monkeypatch, tmp_path):
    """conf/test.toml names tiktok, whose files are not in the repository:
    without --synthetic the bench stops, naming the option."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DIFFMM_DATA_ROOT", raising=False)
    monkeypatch.delenv("BENCH_SET", raising=False)
    with pytest.raises(SystemExit, match="--synthetic"):
        bench.main(["--device", "cpu"])
