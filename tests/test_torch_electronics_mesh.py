"""The ``web.train_mesh4`` cell's configuration (``benchmark/configs/
electronics.json``: two modalities of unequal width, a catalog larger than
the users, a ``latent`` graph, one epoch a step, a 4x1 data mesh) at a tiny
size on four gloo ranks, run as the benchmark runs it: ``benchmark.run``
starts the ranks, which join through the program's ``init_distributed``
and train the port's Coach on ``make_mesh(4, model_parallel=1)``; rank 0
then holds the first epoch against the plain reference
(``benchmark/reference/diffmm.py``, which imports neither JAX nor the
port's kernels) on the same seeded random weights and inputs."""

from __future__ import annotations

import json
import multiprocessing as mp

import torch

from benchmark import run as bench

# electronics.json's shape, cut to tens of rows: image wider than text, more
# items than users, the published 8.78 interactions a user and TikTok's
# test-to-train ratio; a batch of 64 gives each of the four ranks 16 rows
TINY = {
    "config.data.users": 64, "config.data.items": 96,
    "config.data.modalities": [["image", 24], ["text", 8]],
    "config.data.graph": {"kind": "latent", "rank": 4, "train_edges": 562, "test_edges": 58,
                          "degrees": {"min": 3, "sigma": 1.25}},
    "config.program.train.batch": 64, "config.program.train.test_batch": 64,
    "config.program.base.denoise_dim": "[16]",
}

# Each number of the check (benchmark/harness/checks.py) with its tolerance
# here, and why:
# - the first epoch's losses (diffusion, total, BPR, L2, CL), relative: the
#   ranks sum f32 partials (their rows' losses, K4's edge slices, the
#   gradients) in another order than the reference's single sums, and the
#   epoch's few Adam steps carry that rounding to about 2e-7 here;
# - `rebuild`: how far the rebuilt edges lie below the top items that the
#   program's own denoisers give in the reference, relative to the scores;
#   only f32 rounding between near-equal scores moves it (0 here);
# - `eval`, relative gap of Recall and NDCG: hits are whole, so only the
#   sums' order moves it (about 1e-7); one flipped hit among the tens of
#   test users would read 1e-2 or more;
# - `embed`, the ranked embeddings against the reference's forward of the
#   same parameters over the same graphs, over the table's largest
#   magnitude: f32 sums in another order (about 2e-7).
TOLERANCES = {"loss.diffusion": 1e-5, "loss.total": 1e-5, "loss.bpr": 1e-5, "loss.reg": 1e-5,
              "loss.cl": 1e-5, "rebuild": 1e-5, "eval": 1e-5, "embed": 1e-5}


def test_the_config_is_the_cells_and_on_a_4x1_mesh():
    with open(bench.ROOT + "/BENCHMARK.json") as fh:
        manifest = json.load(fh)
    cell = {w["name"]: w for w in manifest["workloads"]}["web.train_mesh4"]
    r = bench.Run(manifest, "web.train_mesh4", 1, 1, False, torch.device("cpu"))
    assert cell["chips"] == 4 and r.layout == (4, 1) and r.world == 4
    data, program = r.config["data"], r.config["program"]
    dims = [d for _, d in data["modalities"]]
    assert data["items"] > data["users"] and dims[0] != dims[1] and data["graph"]["kind"] == "latent"
    assert program["train"]["epoch_scan"] == 1 and program["train"]["graph_form"] == "sparse"
    assert program["train"]["batch"] % 4 == 0


def test_electronics_on_a_4x1_gloo_mesh_matches_the_reference(capsys):
    with open(bench.ROOT + "/BENCHMARK.json") as fh:
        manifest = json.load(fh)
    r = bench.Run(manifest, "web.train_mesh4", 2**31 + 99, 0.5, False, torch.device("cpu"), overrides=TINY)
    assert r.layout == (4, 1)
    line = json.loads(json.dumps(bench.run_cell(r)))
    assert line["device"]["count"] == 4 and line["attempted"] > 0 and line["failed"] == 0
    checks = {k: v["value"] for k, v in line["checks"].items()}
    over = {k: (checks[k], tol) for k, tol in TOLERANCES.items() if not checks[k] <= tol}
    assert not over, over
    assert line["correct"] is True, line["checks"]
    assert capsys.readouterr().out == ""  # the ranks print nothing to standard output
    assert not mp.active_children()

