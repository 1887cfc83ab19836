"""The control comes out not correct: the reference in the nearest precision
below the configuration's (TF32 products for float32) put in the program's
place, and the program's own lower-precision path where it has one (bf16
messages on the sparse form), judged by each cell's own limits, on a card,
at a size a test run holds (``tools/calibrate.py`` reads them at the cells'
own sizes)."""

from __future__ import annotations

import pytest
import torch

from benchmark import run as bench
from benchmark.harness import checks, serve, train
from benchmark.reference import serving as ref_serving
from benchmark.tests.tiny import manifest
from benchmark.tools import calibrate


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda", 0)


SMALL = {"tiktok": {"config.data.users": 2000, "config.data.items": 1500,
                    "config.data.graph": {"kind": "uniform", "train_edges": 13000, "test_edges": 1340,
                                          "degrees": {"min": 3, "sigma": 1.25}}},
         "sports": {"config.data.users": 3000, "config.data.items": 2000,
                    "config.data.graph": {"kind": "latent", "rank": 8, "train_edges": 21600, "test_edges": 2220,
                                          "degrees": {"min": 3, "sigma": 1.25}}}}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [101, 102, 103])
@pytest.mark.parametrize("workload", ["tiktok.train", "sports.train"])
def test_training_control_fails(workload, seed, card):
    r = bench.Run(manifest(), workload, seed, 1, False, card, overrides=SMALL[workload.split(".")[0]])
    spec = r.config["program"]
    inputs = train.make_inputs(r.config["data"], r.seed, card)
    scan = max(1, int(spec["train"].get("epoch_scan", 1)))
    steps = int(r.traffic["checked_steps"])
    truth = train.reference_records(spec, inputs, r.seed, card, 1, scan)
    control = train.reference_records(spec, inputs, r.seed, card, steps, scan, tf32=True)
    follower = train.Reference(spec, inputs, r.seed, card)
    correct, judged = checks.judge(checks.train_numbers(control, truth, follower, inputs), r.limits)
    assert correct is False, judged


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_program_bf16_messages_fail(seed, card):
    r = bench.Run(manifest(), "sports.train", seed, 1, False, card, overrides=SMALL["sports"])
    ((_, numbers),) = calibrate.train_readings(r, ["program"], {"config.program.train.segsum_compute": "bf16"})
    correct, judged = checks.judge(numbers, r.limits)
    assert correct is False, judged


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_serving_control_fails(seed, card):
    r = bench.Run(manifest(), "sports.serve", seed, 2, False, card)
    inputs, u_emb, i_emb, _, _ = serve.build(r)
    _, users = serve.schedule(r.traffic, r.seconds, r.seed, inputs.user_num)
    k = int(r.traffic["k"])
    ids, scores = ref_serving.answers(u_emb, i_emb, inputs.rows, inputs.cols, users, k, tf32=True)
    numbers = ref_serving.answer_numbers(u_emb, i_emb, inputs.rows, inputs.cols, users, ids, scores, k)
    correct, judged = checks.judge(numbers, r.limits)
    assert correct is False, judged
