"""The per-layer metrics' counters, reckoned by hand at one small shape, and
their readers on a made-up trace."""

from __future__ import annotations

import importlib.util
import os

import pytest

from benchmark import run as bench
from benchmark.harness.peaks import HBM_BYTES_S, TF32_FLOPS
from benchmark.harness.trace import TraceSummary


def reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(bench.HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHAPE = {"users": 10, "items": 6, "nnz": 20, "feat_dims": [3, 5], "latdim": 4, "hidden": [8], "d_emb": 2,
         "steps": 2, "batch": 4, "test_batch": 4, "topk": 2, "cl_method": 0, "graph_form": "dense",
         "dense_store": "int8", "tst_epoch": 1, "epoch_scan": 1}


def test_k1_bytes():
    # one launch: 10 x 6 int8 cells, z read and y written, f32, (10 + 6) rows of 4
    assert reader("k1_roofline").launch_bytes(10, 6, 4, "int8") == 60 + 2 * 4 * 16 * 4
    assert reader("k1_roofline").launch_bytes(10, 6, 4, "int4") == 30 + 2 * 4 * 16 * 4


def test_denoise_bound():
    # users 10 in blocks of 4: rows 4, 4, 2; I 6, H 8; per block-step the larger
    # of 4·rows·I·H operations at the TF32 rate and its f32 bytes at HBM's
    want = 0.0
    for rows in (4, 4, 2):
        ops = 4 * rows * 6 * 8
        nbytes = 4 * (2 * rows * 6 + 2 * 6 * 8 + 2 * rows * 8)
        want += max(ops / TF32_FLOPS, nbytes / HBM_BYTES_S)
    got = reader("denoise_roofline").epoch_bound_s(10, 6, 8, 4, 2, 2)
    assert got == pytest.approx(want * 2 * 2)


def test_epoch_flops():
    """Reckoned by hand at SHAPE (U 10, I 6, nnz 20, d 4, H 8, batch 4,
    two modalities of widths 3 and 5, 2 steps, eval every epoch)."""
    # diffusion, a row and modality: layer 1 fwd + weight grad 2·(2·6·8) = 192,
    # layer 2 fwd + weight + input grads 3·(2·8·6) = 288, similarity
    # 3·(2·6·4) = 144: 624; 10 rows x 2 modalities
    diffusion = 20 * 624  # 12,480
    # rebuild: 2 steps of (2·6·8 + 2·8·6) = 192 a row and modality
    rebuild = 20 * 2 * 192  # 7,680
    # a joint block: projections 4·6·8·4 = 768; 6 propagations of 2·2·20·4
    # forward and as much backward (1,920 each way, 3,840 in all); InfoNCE
    # (2 + 2·2) x 6·4·4·4 = 2,304
    block = 768 + 3840 + 2304  # 6,912, five blocks for 20 edges
    # eval: projections 2·6·8·4 = 384, 4 propagations 4·(4·20·4) = 1,280,
    # scores 2·10·6·4 = 480
    evals = 384 + 1280 + 480  # 2,144
    assert reader("mfu.train").epoch_flops(SHAPE) == 12480 + 7680 + 5 * 6912 + 2144
    # pairwise modality CL (cl_method 1): 2 + 2·1 InfoNCE terms, 1,536
    assert reader("mfu.train").epoch_flops(dict(SHAPE, cl_method=1)) == 12480 + 7680 + 5 * 6144 + 2144
    # three modalities under cl_method 1: 2 + 3·2 = 8 InfoNCE terms
    three = dict(SHAPE, feat_dims=[3, 5, 2], cl_method=1)
    block3 = 4 * 6 * 10 * 4 + 2 * 7 * 4 * 20 * 4 + 8 * 6 * 4 * 4 * 4
    evals3 = 2 * 6 * 10 * 4 + 5 * 4 * 20 * 4 + 2 * 10 * 6 * 4
    assert reader("mfu.train").epoch_flops(three) == 30 * 624 + 30 * 192 * 2 + 5 * block3 + evals3


def _trace():
    # two kernels busy 0-3 us and 5-6 us of a 10 us window; the host in
    # "aten::copy_" from 2 to 9 us
    dev = [("dual_kernel<64>", 0, 3000), ("gemm_3xtf32<1>", 5000, 6000)]
    host = [("aten::copy_", 2000, 9000), ("cudaLaunchKernel", 3000, 3500)]
    return TraceSummary(10e-6, dev, host)


def test_trace_summary_and_readers():
    t = _trace()
    assert t.busy_s == pytest.approx(4e-6)
    assert t.kernel_s("dual_kernel") == (pytest.approx(3e-6), 1)
    assert t.idle_gaps() == [["cudaLaunchKernel", pytest.approx(2e-6)]]
    layer = {"kind": "train", "trace": t, "shape": SHAPE, "trace_epochs": 1, "train_epoch_s": 2.0,
             "phases": {"joint": [3.0, 1.0, 2.0]}}
    assert reader("idle_share.train").read(layer) == pytest.approx(60.0)
    assert reader("idle_share.serve").read(layer) is None
    k1 = reader("k1_roofline")
    assert k1.read(layer) == pytest.approx(100 * k1.launch_bytes(10, 6, 4, "int8") / HBM_BYTES_S / 3e-6)
    assert reader("phase_s.joint").read(layer) == 2.0
    assert reader("phase_s.rebuild").read(layer) is None
    # nothing to read: no trace, or no launch of the kernel
    assert k1.read({**layer, "trace": TraceSummary(1.0, [], [])}) is None
    assert reader("denoise_roofline").read({**layer, "trace": None}) is None
