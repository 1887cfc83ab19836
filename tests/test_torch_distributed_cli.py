"""The port's multi-device entry points on CPU ranks (gloo): ``python -m
diffmm_tpu_torch --mesh ... --distributed`` and ``serve_http
--model-shards`` (``cli.py``, ``eval/serve_http.py``), after the JAX
package's tests/test_distributed_smoke.py.

``--mesh 1x1`` runs in one process (a group of one, no launcher). Two ranks
come from ``parallel/launch.py::run_ranks``, which sets the launcher's
environment as ``torchrun --nproc_per_node 2`` would: they train a tiny
synthetic config on a 2x1 mesh with checkpoints, and rank 0 alone writes
the log, the checkpoints and the exported index; a second run resumes; a
1x2 mesh refuses training (ROADMAP.md A7b). The sharded HTTP server's
answers over two catalog shards give a direct ``recommend`` on the whole
index's items, and its scores within 1e-5 (each shard's product is another
matmul call over the same dot products).
"""

import glob
import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.parallel.launch import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_conf(directory):
    conf = os.path.join(directory, "synth.toml")
    with open(conf, "w") as fh:
        fh.write('[base]\nlatdim = 8\nseed = 3\ndenoise_dim = "[16]"\n'
                 '[data]\nname = "synthetic:40x30"\n'
                 "[hyper]\nsteps = 5\n"
                 "[train]\nbatch = 16\ntest_batch = 8\nepoch = 3\n")
    return conf


def test_cli_mesh_1x1_runs_in_one_process(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "diffmm_tpu_torch", "-c", _write_conf(str(tmp_path)), "--device", "cpu",
         "--mesh", "1x1", "--epochs", "1", "--set", "train.graph_form=sparse"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Mesh: data=1, model=1 | backend gloo | steps eager" in proc.stdout
    assert "Best epoch: 0" in proc.stdout


def _cli_ranks(directory):
    """On each rank: the 1x2 mesh's refusal, then two epochs with
    checkpoints and an exported index, then a third epoch resumed."""
    import torch.distributed as dist

    from diffmm_tpu_torch import cli

    torch.set_num_threads(1)
    os.chdir(directory)
    conf, ck = _write_conf(directory), os.path.join(directory, "ck")
    refusal = None
    try:
        cli.main(["-c", conf, "--device", "cpu", "--mesh", "1x2", "--distributed", "--epochs", "1"])
    except NotImplementedError as e:
        refusal = str(e)
    args = ["-c", conf, "--device", "cpu", "--mesh", "2x1", "--distributed", "--checkpoint-dir", ck,
            "--checkpoint-every", "1", "--set", "train.graph_form=sparse"]
    rc = [cli.main([*args, "--epochs", "2", "--export-index", os.path.join(directory, "idx.npz")])]
    dist.barrier()
    rc.append(cli.main([*args, "--epochs", "3"]))
    return {"refusal": refusal, "rc": rc}


def test_cli_two_ranks_train_checkpoint_and_resume(tmp_path):
    from diffmm_tpu_torch.eval.serving import load_index
    from diffmm_tpu_torch.utils.checkpoint import CheckpointManager

    outs = run_ranks(_cli_ranks, 2, (str(tmp_path),))
    for out in outs:
        assert out["rc"] == [0, 0]
        assert "A7b" in out["refusal"]
    logs = glob.glob(str(tmp_path / "logs" / "*.log"))
    assert len(logs) == 1  # rank 0's (one file a process); rank 1 logs nothing
    text = "".join(open(p).read() for p in logs)
    assert "Mesh: data=2, model=1 | backend gloo | steps eager" in text
    assert "Resumed from checkpoint at epoch 1" in text
    assert CheckpointManager(str(tmp_path / "ck")).epochs() == [0, 1, 2]
    assert not glob.glob(str(tmp_path / "ck" / "*.tmp*"))
    index = load_index(str(tmp_path / "idx.npz"), device="cpu")
    assert index.u_final.shape == (40, 8) and np.isfinite(index.i_final.numpy()).all()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _serve_ranks(path):
    """Rank 0: the sharded server on a free port, 20 requests and /health,
    then the stop; rank 1: the follower loop."""
    import torch.distributed as dist

    from diffmm_tpu_torch.eval.serve_http import ShardedRecommender, follow, make_server
    from diffmm_tpu_torch.eval.serving import load_index
    from diffmm_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(2, model_parallel=2)
    index = load_index(path, device="cpu", mesh=mesh)
    if dist.get_rank() != 0:
        return {"served": follow(index, mesh), "rows": index.i_final.shape[0]}
    recommender = ShardedRecommender(index, mesh)
    server = make_server(index, "127.0.0.1", 0, recommender=recommender)
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    answers = []
    try:
        for j in range(20):
            user, k, mask = (7 * j) % 40, 1 + j % 12, j % 3 != 0
            answers.append(((user, k, mask), _get(f"{base}/recommend?user={user}&k={k}&mask_seen={int(mask)}")))
        health = _get(f"{base}/health")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        recommender.stop()
    return {"answers": answers, "health": health, "rows": index.i_final.shape[0]}


def test_serve_http_model_shards_answers_equal_direct_calls(tmp_path):
    from diffmm_tpu_torch.eval.serving import RecIndex, load_index, recommend, save_index, seen_csr_from_edges

    rng = np.random.default_rng(4)
    rows = rng.integers(0, 40, 200)
    cols = rng.integers(0, 30, 200)
    pairs = np.unique(np.stack([rows, cols], 1), axis=0)
    indptr, indices, width = seen_csr_from_edges(pairs[:, 0], pairs[:, 1], 40)
    path = str(tmp_path / "idx.npz")
    save_index(RecIndex(torch.as_tensor(rng.standard_normal((40, 8)).astype(np.float32)),
                        torch.as_tensor(rng.standard_normal((30, 8)).astype(np.float32)),
                        torch.as_tensor(indptr), torch.as_tensor(indices), width), path)
    rank0, rank1 = run_ranks(_serve_ranks, 2, (path,))
    assert rank1 == {"served": 20, "rows": 15} and rank0["rows"] == 15
    assert rank0["health"] == {"status": "ok", "users": 40, "items": 30}
    whole = load_index(path, device="cpu")
    for (user, k, mask), body in rank0["answers"]:
        ids, scores = recommend(whole, torch.tensor([user]), k, mask)
        assert body["user"] == user and body["items"] == ids[0].tolist()
        np.testing.assert_allclose(body["scores"], scores[0].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("argv, says", [
    (["--mesh", "2x1", "--distributed"], "needs 2 ranks, the group has 1"),
    (["--mesh", "0x1"], "at least 1"),
    (["--mesh", "two"], "DATAxMODEL"),
])
def test_cli_mesh_argument_errors(tmp_path, monkeypatch, capsys, argv, says):
    """Malformed or mismatched --mesh stops with the parser's message (the
    first under a launcher of one rank, in a spawned rank)."""
    from diffmm_tpu_torch import cli

    if "--distributed" in argv:
        with pytest.raises(RuntimeError, match=says):
            run_ranks(_cli_main, 1, (str(tmp_path), argv))
        return
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        cli.main(["-c", _write_conf(str(tmp_path)), "--device", "cpu", *argv])
    assert says in capsys.readouterr().err


def _cli_main(directory, argv):
    import contextlib
    import io

    from diffmm_tpu_torch import cli

    os.chdir(directory)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            cli.main(["-c", _write_conf(directory), "--device", "cpu", *argv])
        except SystemExit:
            raise RuntimeError(err.getvalue()) from None
