"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program: each module's top-level name is
compared whole (``diffmm_tpu_torch`` is not ``diffmm_tpu``)."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

from benchmark import run as bench

FORBIDDEN = {"jax", "jaxlib", "flax", "diffmm_tpu"}
ROOT = pathlib.Path(bench.HERE)


def imported_tops(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_anywhere_in_the_benchmark():
    for path in ROOT.rglob("*.py"):
        assert not imported_tops(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        assert not imported_tops(path) & (FORBIDDEN | {"diffmm_tpu_torch", "benchmark"}), path


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process leaves no JAX module loaded."""
    code = (
        "import json, sys\n"
        "from benchmark import run as bench\n"
        "from benchmark.tests.tiny import tiny_run\n"
        "bench.run_cell(tiny_run('tiktok.train'))\n"
        "print(json.dumps(bench.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
