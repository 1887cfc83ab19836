"""Serving's ``approx`` top-k in the port (``eval/serving.py::recommend``,
``warmup``; ``eval/serve_http.py --approx``) against the JAX package's
``recommend(approx=True)`` (``diffmm_tpu/eval/serving.py:107-170``), which
takes ``jax.lax.approx_max_k`` at ``recall_target=0.95``.

Off the TPU, ``approx_max_k`` is the exact top-k, and the port serves the
exact top-k: on the same index npz the two packages' ``approx=True``
answers agree, replicated and at model 2 (the port on two gloo ranks, the
JAX package on the conftest's virtual CPU devices), ids exactly (the
random scores have no ties), scores within 1e-5; the port's ``approx=True``
is bitwise its ``approx=False``.

JAX is imported inside the tests only: the spawned ranks import this module
to find their function, and need torch alone.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.parallel.launch import run_ranks
from diffmm_tpu_torch.parallel.mesh import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U, I, D = 48, 40, 16
USERS = np.array([0, 5, 11, 11, 23, 47], np.int32)
CASES = [(k, mask) for k in (1, 5, 16) for mask in (True, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny tensors: beside the other test
    workers, several threads a process spin against each other (see
    tests/test_torch_train_slice.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def index_path(tmp_path_factory):
    """An index npz written by the JAX package: random embeddings and 4
    seen items a user."""
    import jax.numpy as jnp

    from diffmm_tpu.eval import serving as js

    rng = np.random.default_rng(21)
    rows = np.repeat(np.arange(U), 4)
    cols = np.stack([rng.choice(I, 4, replace=False) for _ in range(U)]).reshape(-1)
    indptr, indices, width = js.seen_csr_from_edges(rows, cols, U)
    index = js.RecIndex(jnp.asarray(rng.standard_normal((U, D)).astype(np.float32)),
                        jnp.asarray(rng.standard_normal((I, D)).astype(np.float32)),
                        jnp.asarray(indptr), jnp.asarray(indices), width)
    path = str(tmp_path_factory.mktemp("approx") / "index.npz")
    js.save_index(index, path)
    return path


def _jax_answers(path, model: int = 1) -> dict:
    import jax.numpy as jnp

    from diffmm_tpu.eval import serving as js
    from diffmm_tpu.parallel import make_mesh

    mesh = None if model == 1 else make_mesh(8, model_parallel=model)
    index = js.load_index(path, mesh=mesh)
    out = {}
    for k, mask in CASES:
        ids, scores = js.recommend(index, jnp.asarray(USERS), k, mask, approx=True, mesh=mesh)
        out[(k, mask)] = (np.asarray(ids), np.asarray(scores))
    return out


def _port_answers(path, mesh=None, approx: bool = True) -> dict:
    from diffmm_tpu_torch.eval import serving

    index = serving.load_index(path, device="cpu", mesh=mesh)
    out = {}
    for k, mask in CASES:
        ids, scores = serving.recommend(index, torch.as_tensor(USERS), k, mask, mesh=mesh, approx=approx)
        out[(k, mask)] = (ids.numpy(), scores.numpy())
    return out


def _assert_same(got: dict, want: dict) -> None:
    for case, (ids, scores) in want.items():
        np.testing.assert_array_equal(got[case][0], ids, err_msg=str(case))
        np.testing.assert_allclose(got[case][1], scores, rtol=1e-5, atol=1e-5, err_msg=str(case))


def test_recommend_approx_matches_jax(index_path):
    _assert_same(_port_answers(index_path), _jax_answers(index_path))


def test_recommend_approx_is_the_exact_call(index_path):
    exact, approx = _port_answers(index_path, approx=False), _port_answers(index_path)
    for case in CASES:
        assert np.array_equal(exact[case][0], approx[case][0])
        assert np.array_equal(exact[case][1], approx[case][1])  # bitwise


def test_warmup_runs_the_jax_variants(index_path, monkeypatch):
    """``warmup(approx=True)`` makes the calls JAX's ``warmup`` makes: each
    k, both mask modes, a single user, ``approx`` passed on."""
    from diffmm_tpu.eval import serving as js
    from diffmm_tpu_torch.eval import serving

    calls = {"jax": [], "port": []}

    def spy(name, real):
        def call(index, users, k, mask_seen=True, **kwargs):
            calls[name].append((tuple(users.shape), k, mask_seen, kwargs.get("approx")))
            return real(index, users, k, mask_seen, **kwargs)
        return call

    monkeypatch.setattr(js, "recommend", spy("jax", js.recommend))
    monkeypatch.setattr(serving, "recommend", spy("port", serving.recommend))
    js.warmup(js.load_index(index_path), [3, 20], approx=True)
    serving.warmup(serving.load_index(index_path, device="cpu"), [3, 20], approx=True)
    assert calls["port"] == calls["jax"] == [((1,), 3, True, True), ((1,), 3, False, True),
                                             ((1,), 20, True, True), ((1,), 20, False, True)]


def _rank_answers(path):
    from diffmm_tpu_torch.eval import serving
    from diffmm_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(2, model_parallel=2)
    serving.warmup(serving.load_index(path, device="cpu", mesh=mesh), [5], mesh, approx=True)
    return _port_answers(path, mesh)


def test_recommend_approx_at_model_2_matches_jax(index_path):
    want = _jax_answers(index_path, model=2)
    _assert_same(want, _jax_answers(index_path))  # JAX's sharded call is its replicated one
    for got in run_ranks(_rank_answers, 2, (index_path,)):
        _assert_same(got, want)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_serve_http_approx_serves_the_jax_answers(index_path):
    """``python -m diffmm_tpu_torch.eval.serve_http --approx --device cpu``
    answers each request with the JAX package's ``approx=True`` answer."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "diffmm_tpu_torch.eval.serve_http", index_path, "--device", "cpu",
         "--approx", "--port", str(port), "--warmup", "5"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                code, health = _get(base + "/health")
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "server never became healthy"
                time.sleep(0.2)
        assert code == 200 and health == {"status": "ok", "users": U, "items": I}
        want = _jax_answers(index_path)
        for (k, mask), (ids, scores) in want.items():
            for row, user in enumerate(USERS):
                code, body = _get(base + f"/recommend?user={user}&k={k}&mask_seen={int(mask)}")
                assert code == 200 and body["items"] == ids[row].tolist()
                np.testing.assert_allclose(body["scores"], scores[row], rtol=1e-5, atol=1e-5)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
