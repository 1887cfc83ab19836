"""The port's probes (``diffmm_tpu_torch/tools/``: ``scale_probe``,
``store_ab_probe``, ``fused_overhead_probe``, ``joint_profile``) against
the JAX package's tools of the same names.

Each runs on the CPU at a tiny synthetic (64 x 48, latdim 16, hidden 32,
batch 16) and prints what the JAX tool prints: the same JSON keys
(``tools/scale_probe.py:58-66, 82-85, 100-103``; ``tools/store_ab_probe.py:
99-108``; ``tools/joint_profile.py:148-174``, whose ``spmm_scatter_*`` rows
time an XLA route the port does not have), or the same lines
(``tools/fused_overhead_probe.py:55-75``). A ``slow`` test runs each JAX
tool under ``JAX_PLATFORMS=cpu`` at the same size and holds the port's keys
and lines against its output.

``store_ab_probe``'s two arms train one run from one seed: a train store
only answers membership questions (negative sampling, the diffusion rows,
the eval mask), so the dense-store arm and the CSR-store arm give the same
losses, within rtol 1e-6.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.config import apply_overrides, load_config
from diffmm_tpu_torch.data.synthetic import host_data
from diffmm_tpu_torch.tools import fused_overhead_probe, joint_profile, scale_probe, store_ab_probe

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = ["data.name=synthetic:64x48", "base.latdim=16", "base.denoise_dim=[32]", "train.batch=16",
        "train.test_batch=16"]
SETS = [a for s in TINY for a in ("--set", s)]
PHASES = {"neg_sampling", "diffusion", "rebuild", "joint"}

SCALE_KEYS = {"config", "set", "backend", "shape", "nnz", "graph_form", "train_store", "epoch_s_all",
              "epoch_s_median_steady"}
SCALE_FUSED_KEYS = {"fused_compile_chunk_s", "fused_scan", "fused_epoch_s_all", "fused_epoch_s_median"}
STORE_AB_KEYS = {"config", "backend", "scan", "fused_epoch_s", "fenced_phase_s"}
JOINT_KEYS = {"config", "backend", "graph_form", "dense_store", "inner_iters", "dispatch_overhead_ms",
              "spmm_fwd_ms", "spmm_bwd_ms", "gcn_forward_ms", "joint_nocl_ms", "joint_step_ms", "cl_plus_adam_ms"}
JOINT_FORM_KEYS = {"dense": {"adj_pass_roofline_ms"},
                   "sparse": {"spmm_modal_fwd_ms", "spmm_modal_bwd_ms", "sparse_pass_roofline_ms"}}
JAX_ONLY_KEYS = {"spmm_scatter_fwd_ms", "spmm_scatter_bwd_ms"}
# tools/fused_overhead_probe.py's lines, the numbers as patterns
OVERHEAD_LINES = [
    r"upload probe: [\d.]+ MB in [\d.]+s = [\d.]+ MB/s",
    r"compile\+first chunk: [\d.]+s",
    *(rf"chunk {i}: call\(incl\. host prep\+upload\+result fetch\)=[\d.]+s  \+device drain=[\d.]+s  "
      r"-> [\d.]+s/epoch wall" for i in (1, 2, 3)),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny tensors (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _json(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_scale_probe_keys(capsys, form):
    argv = ["-c", "conf/yelp.toml", "--device", "cpu", *SETS, "--set", f"train.graph_form={form}",
            "--epochs", "2", "--scan", "2", "--chunks", "1"]
    assert scale_probe.main(argv) == 0
    line = _json(capsys)
    assert set(line) == SCALE_KEYS | SCALE_FUSED_KEYS
    assert line["backend"] == "cpu" and line["graph_form"] == form and line["shape"] == [64, 48]
    assert line["train_store"] == ("dense" if form == "dense" else "csr")
    assert len(line["epoch_s_all"]) == 2 and len(line["fused_epoch_s_all"]) == 1
    assert line["epoch_s_median_steady"] == line["epoch_s_all"][1]


def test_store_ab_probe_keys(capsys):
    argv = ["--device", "cpu", *SETS, "--fenced", "1", "--chunks", "1", "--scan", "2"]
    assert store_ab_probe.main(argv) == 0
    line = _json(capsys)
    assert set(line) == STORE_AB_KEYS and line["scan"] == 2
    assert set(line["fused_epoch_s"]) == {"dense", "csr"} == set(line["fenced_phase_s"])
    assert all(set(phases) == PHASES for phases in line["fenced_phase_s"].values())


def test_store_ab_arms_train_the_same_run():
    """The two arms (dense store, CSR store) from one seed: the same losses,
    epoch by epoch, within rtol 1e-6."""
    base = load_config(str(REPO / "conf" / "tiktok_tuned.toml"))
    apply_overrides(base, TINY)
    host = host_data(base)
    _, losses = store_ab_probe.measure(base, host, torch.device("cpu"), chunks=1, fenced=1, scan=2)
    dense, csr = losses["dense"], losses["csr"]
    assert len(dense) == len(csr) == 1 + 1 + 2 + 2
    for a, b in zip(dense, csr, strict=True):
        assert a.keys() == b.keys()
        np.testing.assert_allclose([a[k] for k in a], [b[k] for k in a], rtol=1e-6, atol=0)


def test_fused_overhead_probe_lines(capsys):
    assert fused_overhead_probe.main(["conf/tiktok_tuned.toml", "2", "--device", "cpu", *SETS]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(OVERHEAD_LINES)
    for line, pattern in zip(lines, OVERHEAD_LINES):
        assert re.fullmatch(pattern, line), (line, pattern)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_joint_profile_keys(capsys, form):
    extra = ["--set", "train.graph_form=sparse", "--set", "train.segsum_compute=bf16"] if form == "sparse" else []
    argv = ["--device", "cpu", *SETS, *extra, "--inner", "2", "--reps", "2"]
    assert joint_profile.main(argv) == 0
    line = _json(capsys)
    assert set(line) == JOINT_KEYS | JOINT_FORM_KEYS[form]
    assert line["graph_form"] == form and line["inner_iters"] == 2
    assert line["dispatch_overhead_ms"] is None  # no captured graph on the CPU
    assert line["cl_plus_adam_ms"] == round(line["joint_step_ms"] - line["joint_nocl_ms"], 3)


def _tiny_toml(tmp_path, form: str = "dense", segsum: str = "f32") -> str:
    """conf/tiktok_tuned.toml at the tiny size (the JAX tools that take no
    --set read their size from the file)."""
    text = (REPO / "conf" / "tiktok_tuned.toml").read_text()
    text = re.sub(r'(?m)^name = .*$', 'name = "synthetic:64x48"', text)
    text = re.sub(r"(?m)^latdim = .*$", "latdim = 16", text)
    text = re.sub(r'(?m)^denoise_dim = .*$', 'denoise_dim = "[32]"', text)
    text = re.sub(r"(?m)^batch = .*$", "batch = 16", text)
    text = re.sub(r"(?m)^test_batch = .*$", "test_batch = 16", text)
    text += f'graph_form = "{form}"\nsegsum_compute = "{segsum}"\n'
    path = tmp_path / f"tiny_{form}.toml"
    path.write_text(text)
    return str(path)


def _jax_tool(tool: str, *args) -> str:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(REPO / "tools" / f"{tool}.py"), *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.slow  # each JAX tool compiles its programs on the CPU for tens of seconds
@pytest.mark.parametrize("tool", ["scale_probe", "store_ab_probe", "fused_overhead_probe",
                                  "joint_profile_dense", "joint_profile_sparse"])
def test_probe_output_matches_jax_tool(tmp_path, capsys, tool):
    form = "sparse" if tool.endswith("sparse") else "dense"
    conf = _tiny_toml(tmp_path, form, "bf16" if form == "sparse" else "f32")
    if tool == "fused_overhead_probe":
        jax_lines = _jax_tool(tool, conf, "2").strip().splitlines()[-len(OVERHEAD_LINES):]
        for line, pattern in zip(jax_lines, OVERHEAD_LINES, strict=True):
            assert re.fullmatch(pattern, line), (line, pattern)
        return
    if tool == "scale_probe":
        args = ["-c", conf, "--epochs", "2", "--scan", "2", "--chunks", "1"]
        jax_line, port = _jax_tool(tool, *args), scale_probe.main([*args, "--device", "cpu"])
    elif tool == "store_ab_probe":
        args = ["-c", conf, "--fenced", "1", "--chunks", "1", "--scan", "2"]
        jax_line, port = _jax_tool(tool, *args), store_ab_probe.main([*args, "--device", "cpu"])
    else:
        args = ["-c", conf, "--inner", "2", "--reps", "2"]
        jax_line, port = _jax_tool("joint_profile", *args), joint_profile.main([*args, "--device", "cpu"])
    assert port == 0
    want, got = json.loads(jax_line.strip().splitlines()[-1]), _json(capsys)
    assert set(got) == set(want) - JAX_ONLY_KEYS
    for key in ("fused_epoch_s", "fenced_phase_s"):
        if key in want:
            assert set(got[key]) == set(want[key])
