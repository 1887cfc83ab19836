"""Guards of the port: it imports neither jax nor diffmm_tpu, its entry points
and kernel wrappers refuse to run on the CPU unless asked to, its source
holds no torch.compile, no scaled_dot_product_attention and no ``except``
around a kernel launch (nor around a training step, whose backward
launches the kernels), and importing it turns TF32 off for f32 matmuls."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "diffmm_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def test_port_imports_no_jax_and_no_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'diffmm_tpu' or m.startswith('diffmm_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 20


def test_module_walk_finds_the_training_slice():
    for name in ("diffmm_tpu_torch.cli", "diffmm_tpu_torch.__main__", "diffmm_tpu_torch.train.optim",
                 "diffmm_tpu_torch.train.steps", "diffmm_tpu_torch.data.sampling",
                 "diffmm_tpu_torch.utils.profiling", "diffmm_tpu_torch.ops.gather",
                 "diffmm_tpu_torch.train.graphs", "diffmm_tpu_torch.utils.checkpoint",
                 "diffmm_tpu_torch.ops.knn", "diffmm_tpu_torch.eval.serve_http"):
        assert name in MODULES


def test_training_path_keeps_tf32_off():
    """The diffusion training's f32 matmuls run in full f32 on the card, as
    the JAX package's do (``ops/kernels/spmm_dual.py`` sets this on import,
    and the training path imports it)."""
    import diffmm_tpu_torch.train.coach  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch, tmp_path):
    from diffmm_tpu_torch.config import Config
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.eval import serving
    from diffmm_tpu_torch.train.coach import Coach

    _no_cuda(monkeypatch)
    cfg = Config()
    cfg.base.latdim, cfg.base.denoise_dim, cfg.train.batch = 16, "[32]", 16
    host = make_synthetic_host_data(cfg, user_num=20, item_num=15, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Coach(cfg, host)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Coach(cfg, host, device="cuda")
    coach = Coach(cfg, host, device="cpu")
    coach.rebuild_graphs()
    path = str(tmp_path / "idx.npz")
    serving.save_index(serving.build_index(coach), path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.load_index(path)
    assert serving.load_index(path, device="cpu").u_final.device.type == "cpu"
    cfg.train.graph_form = "sparse"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Coach(cfg, host)
    sparse = Coach(cfg, host, device="cpu")
    assert not sparse.dense_graphs and sparse.train_store_form == "csr"
    sparse.rebuild_graphs()
    assert serving.build_index(sparse).u_final.device.type == "cpu"


def test_kernel_wrappers_raise_off_cuda_and_cpu():
    """On a CUDA tensor a wrapper launches or raises; on the CPU it takes the
    plain version; any other device raises."""
    from diffmm_tpu_torch.ops.kernels.denoise_mlp import denoise_layer1, denoise_layer1_partial, denoise_layer2
    from diffmm_tpu_torch.ops.kernels.segsum import segsum
    from diffmm_tpu_torch.ops.kernels.spmm_dual import spmm_dual

    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        spmm_dual(torch.empty((4, 3), dtype=torch.int8, device=meta),
                  torch.empty((4, 16), device=meta), torch.empty((3, 16), device=meta))
    with pytest.raises(ValueError, match="denoise_layer1: unsupported device"):
        denoise_layer1(*(torch.empty(s, device=meta) for s in ((2, 3), (3, 4), (2, 4))))
    with pytest.raises(ValueError, match="denoise_layer1_partial: unsupported device"):
        denoise_layer1_partial(*(torch.empty(s, device=meta) for s in ((2, 3), (3, 4))))
    with pytest.raises(ValueError, match="denoise_layer2: unsupported device"):
        denoise_layer2(*(torch.empty(s, device=meta) for s in ((2, 4), (4, 3), (3,))))
    with pytest.raises(ValueError, match="segsum: unsupported device"):
        segsum(torch.empty((5, 64), device=meta), torch.zeros(4, dtype=torch.int64, device=meta))


def _sources():
    return [p for p in PKG.rglob("*.py")] + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("needle", ["torch.compile", "scaled_dot_product_attention"])
def test_no_library_stand_ins(needle):
    hits = [str(p) for p in _sources() if needle in p.read_text()]
    assert not hits, hits


def _calls_inside_try(path, allowed=()):
    """Names of the calls inside each try block of ``path`` whose handlers
    are not all of the ``allowed`` exception names."""
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Try):
            continue
        if node.handlers and all(isinstance(h.type, ast.Name) and h.type.id in allowed
                                 for h in node.handlers):
            continue
        for sub in ast.walk(ast.Module(body=node.body, type_ignores=[])):
            if isinstance(sub, ast.Call):
                fn = sub.func
                yield fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")


def test_no_except_around_a_kernel_launch():
    """No try block in the port encloses a kernel wrapper or C entry call."""
    launches = {"spmm_dual", "denoise_forward_fused", "_launch", "spmm_dual_forward",
                "denoise_layer1", "denoise_layer1_partial", "denoise_layer2", "load_library",
                "segsum", "segsum_gather", "segsum_forward"}
    for path in _sources():
        for name in _calls_inside_try(path):
            assert name not in launches, f"{path}: {name} inside try"


def test_training_path_catches_no_kernel_failure():
    """The training path's source holds no try around anything that reaches
    a kernel: the autograd Functions (``apply``: forward and backward
    launches), the steps and phases, the propagations, the Coach's entry
    points, the gather and the captured-graph runner (a failed capture
    raises, it never falls back to eager). The one handler allowed is
    ``Coach.run``'s for ``KeyboardInterrupt`` (the JAX package's), which no
    kernel raises."""
    reaches_a_kernel = {
        "apply", "backward", "grad", "spmm_bi", "spmm_bi_modal_stacked", "gcn_mm", "gcn_forward",
        "diffusion_block", "diffusion_epoch", "joint_block", "joint_epoch", "rebuild_epoch",
        "rebuild_block_tables", "train_epoch", "_joint_phase", "rebuild_graphs", "test_epoch",
        "forward", "run", "build_index", "negative_sampling", "contains", "adam_update",
        "gather", "run_step", "train_epochs_fused", "_epoch_on_device", "set_edge_buffers",
        "restore_checkpoint", "_eval_sums", "replay", "step", "knn_prototypes", "knn_edges",
        "build_knn_adj", "_knn_adjs", "rebuild_forward",
    }
    paths = [PKG / "cli.py", PKG / "train" / "coach.py", PKG / "train" / "steps.py",
             PKG / "train" / "optim.py", PKG / "ops" / "graph.py", PKG / "ops" / "losses.py",
             PKG / "data" / "sampling.py", PKG / "data" / "membership.py",
             PKG / "diffusion" / "gaussian.py", PKG / "models" / "gcn.py", PKG / "eval" / "serving.py",
             PKG / "ops" / "kernels" / "spmm_dual.py", PKG / "ops" / "kernels" / "segsum.py",
             PKG / "ops" / "gather.py", PKG / "train" / "graphs.py", PKG / "ops" / "knn.py",
             PKG / "eval" / "serve_http.py", REPO / "chip_smoke.py"]
    for path in paths:
        for name in _calls_inside_try(path, allowed=("KeyboardInterrupt",)):
            assert name not in reaches_a_kernel, f"{path}: {name} inside try"
