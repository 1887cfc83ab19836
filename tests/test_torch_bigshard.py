"""``python -m diffmm_tpu_torch.tools.bigshard_demo`` against the JAX
package's ``tools/bigshard_demo.py``, both forms, at tiny sizes.

The JAX tool runs on 8 virtual CPU devices, the port's on 8 gloo CPU ranks
(``--device cpu``), each in a subprocess. Their lines must agree with times
masked and the port's per-rank memory and launch lines left out: the same host data
(the synthetic generator is bit-identical), the same table rows in order
with the same factors, sizes and bytes (the MiB columns round to 0.0-0.2
at these sizes, so each row's bytes are held too: the JAX ones from its
arrays' shapes, the port's as it prints them), the same membership-store
line and the same ``ok`` line. The sparse shape is past U·I = 2e8, where the
synthetic generator draws edges without a (U, I) matrix, as every web-scale
shape does (below it the host keeps its dense matrix, and both tools'
contract fails). Each comparison takes 20-35 s here: ``slow``.

One row differs by design: the JAX denoiser's first in-layer is one (I +
d_emb, H) leaf, split by rows; the port keeps its catalog rows (W1x, (I,
H)) on the model axis and its d_emb time rows whole, and its row names that
leaf with the JAX leaf's shape beside it.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMED = re.compile(r"\d+(\.\d+)?s \([^)]*\)|\(\d+s\)")
LOG = re.compile(r"^\d\d/\d\d \d\d:\d\d:\d\d - ")
ROW = re.compile(r"^  (?P<label>.+?)\s+global\s+(?P<g>[\d.]+) MiB\s+per-device\s+(?P<l>[\d.]+) MiB\s+"
                 r"x(?P<f>\d+)(\s+\((?P<gb>\d+) / (?P<lb>\d+) bytes\))?$")
DENSE = ["--users", "600", "--items", "400", "--devices", "8", "--model", "2", "--denoise-dim", "[32]",
         "--batch", "64"]
SPARSE = ["--form", "sparse", "--users", "20480", "--items", "10240", "--density", "5e-5", "--batch", "64",
          "--denoise-dim", "[16]"]


def _run(args, jax: bool) -> list[str]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if jax:
        env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=8")
        cmd = [sys.executable, "tools/bigshard_demo.py", *args]
    else:
        cmd = [sys.executable, "-m", "diffmm_tpu_torch.tools.bigshard_demo", *args, "--device", "cpu"]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return [line for line in out.stdout.splitlines() if not LOG.match(line)]


def _split(lines):
    """(the lines with times masked, the table rows parsed, the peak lines)."""
    text, rows, peaks = [], [], []
    for line in lines:
        if line.startswith("rank ") and "peak card memory" in line:
            peaks.append(line)
        elif line.startswith("rank ") and "kernel launches" in line:
            continue
        elif ROW.match(line):
            rows.append(ROW.match(line).groupdict())
        else:
            text.append(TIMED.sub("<t>", line))
    return text, rows, peaks


def _compare(args):
    j_text, j_rows, j_peaks = _split(_run(args, jax=True))
    t_text, t_rows, t_peaks = _split(_run(args, jax=False))
    assert t_text == j_text and not j_peaks
    assert t_peaks == [f"rank {r} peak card memory: not measured (cpu)" for r in range(8)]
    return j_text, j_rows, t_rows


@pytest.mark.slow
def test_dense_demo_matches_jax():
    U, I, d, H = 600, 400, 64, 32
    text, j_rows, t_rows = _compare(DENSE)
    assert text[-1] == "bigshard demo ok" and text[0] == "host data: 600x400, nnz=686 <t>"
    assert len(j_rows) == len(t_rows) == 5
    d_emb = 10  # base.d_emb_size
    # the JAX leaves' bytes, from their shapes: adjacency and store int8, f32 weights
    j_bytes = [U * I, U * I, I * d * 4, (I + d_emb) * H * 4, H * I * 4]
    t_bytes = [U * I, U * I, I * d * 4, I * H * 4, H * I * 4]
    for k, (j, t, jb, tb) in enumerate(zip(j_rows, t_rows, j_bytes, t_bytes)):
        assert j["f"] == t["f"] == "2", (k, j, t)
        assert j["g"] == f"{jb / 2**20:.1f}" and j["l"] == f"{jb / 2 / 2**20:.1f}", (k, j)
        assert (int(t["gb"]), int(t["lb"])) == (tb, tb // 2), (k, t)
        if k != 3:
            assert t["label"] == j["label"] and (t["g"], t["l"]) == (j["g"], j["l"]), (k, j, t)
    assert j_rows[3]["label"] == "denoiser in w (I+demb, H)"
    assert t_rows[3]["label"] == f"denoiser in w catalog rows (I, H) of JAX's (I+demb, H), demb {d_emb}"


@pytest.mark.slow
def test_sparse_demo_matches_jax():
    text, j_rows, t_rows = _compare(SPARSE)
    assert not j_rows and not t_rows
    assert text[:2] == ["host data: 20480x10240, nnz=22748 <t>", "mesh Coach built <t>; train store: csr"]
    assert "  membership store: 0.2 MiB CSR vs 0.2 GiB dense (U, I) int8 (822x)" in text
    assert text[-1] == "bigshard sparse demo ok"


def test_refuses_a_model_axis_that_does_not_divide(monkeypatch, capsys):
    """make_mesh's refusal, asked before any rank starts: exit 1."""
    from diffmm_tpu_torch.parallel import launch
    from diffmm_tpu_torch.tools import bigshard_demo

    monkeypatch.setattr(launch, "run_ranks", lambda *a, **k: pytest.fail("ranks started"))
    assert bigshard_demo.main(["--devices", "6", "--model", "4", "--device", "cpu"]) == 1
    assert "model_parallel=4 must divide 6 devices" in capsys.readouterr().err
    out = subprocess.run([sys.executable, "-m", "diffmm_tpu_torch.tools.bigshard_demo", "--devices", "3",
                          "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "model_parallel=2 must divide 3 devices" in out.stderr


def test_refuses_without_a_card_unless_cpu(monkeypatch):
    import torch

    from diffmm_tpu_torch.parallel import launch
    from diffmm_tpu_torch.tools import bigshard_demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch, "run_ranks", lambda *a, **k: pytest.fail("ranks started without a device"))
    for argv in ([], ["--form", "sparse"], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bigshard_demo.main(argv)


def test_dense_demo_on_two_ranks(capfd):
    """The port alone, fast: a 1x2 mesh of gloo CPU ranks prints the five
    rows at x2 with their bytes, and ends in its ok line."""
    from diffmm_tpu_torch.tools import bigshard_demo

    assert bigshard_demo.main(["--users", "64", "--items", "48", "--devices", "2", "--model", "2",
                               "--denoise-dim", "[16]", "--latdim", "8", "--device", "cpu"]) == 0
    text, rows, peaks = _split(capfd.readouterr().out.splitlines())
    assert [(int(r["gb"]), int(r["lb"]), r["f"]) for r in rows] == [
        (64 * 48, 64 * 24, "2"), (64 * 48, 64 * 24, "2"), (48 * 8 * 4, 24 * 8 * 4, "2"),
        (48 * 16 * 4, 24 * 16 * 4, "2"), (16 * 48 * 4, 16 * 24 * 4, "2")]
    assert text[-1] == "bigshard demo ok" and len(peaks) == 2
