"""The port's closed-loop HTTP latency bench
(``diffmm_tpu_torch/tools/serve_bench.py``) after
``tests/test_serve_bench_tool.py``: on a tiny synthetic index on the CPU it
spawns the port's ``serve_http`` (one process, or two gloo ranks of
``torch.distributed.run`` for ``--model-shards 2``), drives warmed traffic
and prints percentile latency and throughput as one JSON line. The server
takes a free port, never a fixed one, so the file can run beside others.
"""

import json
import os
import subprocess
import sys

import pytest

from diffmm_tpu_torch.tools import serve_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench(*extra) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "diffmm_tpu_torch.tools.serve_bench", "synthetic:60,40,8", "--device", "cpu",
         "--requests", "30", "--clients", "2", "--k", "5", *extra],
        capture_output=True, text=True, timeout=300, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [(), ("--approx", "--model-shards", "2")], ids=["one", "approx-2shards"])
def test_serve_bench_synthetic_smoke(extra):
    report = _bench(*extra)
    assert (report["users"], report["items"]) == (60, 40)
    assert report["requests"] == 30
    assert report["p99_ms"] >= report["p95_ms"] >= report["p50_ms"] > 0
    assert report["throughput_rps"] > 0
    assert report["device"] == "cpu" and report["approx"] == ("--approx" in extra)
    assert report["model_shards"] == (2 if extra else 1)


def test_server_command():
    one = serve_bench.server_command("/x/idx.npz", 9000, 20, None, False, 1)
    assert one == [sys.executable, "-m", "diffmm_tpu_torch.eval.serve_http", "/x/idx.npz", "--port", "9000",
                   "--warmup", "20"]
    two = serve_bench.server_command("/x/idx.npz", 9000, 5, "cpu", True, 2)
    assert two[:8] == [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                       "--master_addr", "127.0.0.1", "--master_port"]
    assert two[9:] == ["-m", "diffmm_tpu_torch.eval.serve_http", "/x/idx.npz", "--port", "9000", "--warmup", "5",
                       "--device", "cpu", "--approx", "--model-shards", "2"]


def test_synthetic_index_is_the_jax_tools():
    """The same ``synthetic:U,I,d`` index as ``tools/serve_bench.py``'s."""
    import importlib.util
    import shutil

    import numpy as np

    spec = importlib.util.spec_from_file_location("jax_serve_bench", os.path.join(REPO, "tools", "serve_bench.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    paths = [tool._synthesize_index("synthetic:30,20,4") for tool in (serve_bench, jax_tool)]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert set(a.files) == set(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
    for path in paths:
        shutil.rmtree(os.path.dirname(path))
