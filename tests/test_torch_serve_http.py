"""The port's HTTP front end (``diffmm_tpu_torch/eval/serve_http.py``)
after ``tests/test_serve_http.py:64-118``: health, recommendations, error
paths, concurrent cold requests and the warmup, on the CPU.

Every response must equal a direct ``recommend`` on the same index: the
same ids and the same scores bit for bit (JSON carries an f32 score as the
float64 it widens to exactly). An index that the JAX package exported
serves the JAX ``recommend``'s ids, outside ties, with scores within rtol
1e-5 (f32 products summed in another order).
"""

import copy
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.eval import serving as j_serving
from diffmm_tpu_torch.config import Config
from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
from diffmm_tpu_torch.eval import serve_http, serving
from diffmm_tpu_torch.train.coach import Coach

USERS, ITEMS = 50, 40


@pytest.fixture(scope="module")
def index():
    cfg = Config()
    cfg.base.seed, cfg.base.latdim, cfg.base.denoise_dim = 7, 16, "[32]"
    cfg.train.batch, cfg.train.test_batch = 16, 8
    host = make_synthetic_host_data(copy.deepcopy(cfg), user_num=USERS, item_num=ITEMS, seed=3)
    coach = Coach(cfg, host, device="cpu")
    coach.train_epoch(0)
    return serving.build_index(coach)


@pytest.fixture(scope="module")
def server(index):
    srv = serve_http.make_server(index, "127.0.0.1", 0, warmup_ks=[5])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join()


def _get(url):
    try:
        with urllib.request.urlopen(url) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _direct(index, user, k, mask_seen=True):
    ids, scores = serving.recommend(index, torch.tensor([user], dtype=torch.int32), k, mask_seen)
    return ids[0].tolist(), scores[0]


def _assert_same(body, index, user, k, mask_seen=True):
    ids, scores = _direct(index, user, k, mask_seen)
    assert body["user"] == user and body["items"] == ids
    got = torch.tensor(body["scores"], dtype=torch.float64).to(torch.float32)
    assert torch.equal(got, scores)  # bitwise


def test_health(server):
    code, body = _get(server + "/health")
    assert code == 200
    assert body == {"status": "ok", "users": USERS, "items": ITEMS}


def test_recommend_equals_a_direct_call(server, index):
    seen_ptr, seen = index.seen_indptr.numpy(), index.seen_indices.numpy()
    for user, k in ((3, 5), (0, 1), (USERS - 1, ITEMS)):
        code, body = _get(server + f"/recommend?user={user}&k={k}")
        assert code == 200 and len(body["items"]) == k
        _assert_same(body, index, user, k)
        if k < ITEMS - seen_ptr[user + 1] + seen_ptr[user]:
            assert not set(body["items"]) & set(seen[seen_ptr[user]:seen_ptr[user + 1]].tolist())
    code, body = _get(server + "/recommend?user=3&k=5&mask_seen=0")
    assert code == 200
    _assert_same(body, index, 3, 5, mask_seen=False)
    code, body = _get(server + "/recommend?user=4")  # k defaults to 20
    assert code == 200 and len(body["items"]) == 20


def test_error_paths(server):
    assert _get(server + "/recommend")[0] == 400  # missing user
    assert _get(server + "/recommend?user=abc")[0] == 400  # not an int
    assert _get(server + f"/recommend?user={USERS}&k=5")[0] == 400  # out of range
    assert _get(server + "/recommend?user=-1&k=5")[0] == 400
    assert _get(server + "/recommend?user=1&k=0")[0] == 400  # bad k
    assert _get(server + f"/recommend?user=1&k={ITEMS + 1}")[0] == 400
    code, body = _get(server + "/nope")
    assert code == 404 and "unknown path" in body["error"]


def test_concurrent_cold_requests(server, index):
    """Concurrent requests with distinct k values and both mask modes, each
    on its own handler thread, all answer what a direct call answers."""
    cases = [(1, 3, 1), (2, 5, 1), (3, 9, 1), (4, 17, 1), (5, 3, 0), (6, 5, 0), (7, 3, 1),
             (8, 3, 1), (9, 5, 1), (10, 9, 0), (11, 17, 0), (12, 3, 0)]
    urls = [server + f"/recommend?user={u}&k={k}&mask_seen={m}" for u, k, m in cases]
    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(_get, urls))
    for (code, body), (u, k, m) in zip(results, cases):
        assert code == 200, body
        assert len(set(body["items"])) == k
        _assert_same(body, index, u, k, mask_seen=bool(m))


def test_warmup_runs_each_k_and_mask_mode(monkeypatch, index):
    calls = []
    real = serving.recommend

    def spy(idx, users, k, mask_seen=True):
        calls.append((tuple(users.shape), k, mask_seen))
        return real(idx, users, k, mask_seen)

    monkeypatch.setattr(serving, "recommend", spy)
    serving.warmup(index, [7, 20])
    assert calls == [((1,), 7, True), ((1,), 7, False), ((1,), 20, True), ((1,), 20, False)]
    calls.clear()
    serving.warmup(index)
    assert calls == [((1,), 20, True), ((1,), 20, False)]


def test_main_refuses_what_the_port_lacks(tmp_path, index, monkeypatch):
    path = str(tmp_path / "idx.npz")
    serving.save_index(index, path)
    with pytest.raises(NotImplementedError, match="A5"):
        serve_http.main([path, "--device", "cpu", "--approx"])
    with pytest.raises(NotImplementedError, match="A7"):
        serve_http.main([path, "--device", "cpu", "--model-shards", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):  # no quiet move to the CPU
        serve_http.main([path])


def test_a_jax_exported_index_serves_the_jax_answers(tmp_path):
    """The JAX package's npz export, loaded by the port's server: the JAX
    ``recommend``'s ids outside ties, scores within rtol 1e-5."""
    rng = np.random.default_rng(11)
    u_final = rng.standard_normal((USERS, 16)).astype(np.float32)
    i_final = rng.standard_normal((ITEMS, 16)).astype(np.float32)
    rows = np.repeat(np.arange(USERS), 3)
    cols = np.stack([rng.choice(ITEMS, 3, replace=False) for _ in range(USERS)]).reshape(-1)
    j_index = j_serving.RecIndex(jnp.asarray(u_final), jnp.asarray(i_final),
                                 *map(jnp.asarray, j_serving.seen_csr_from_edges(rows, cols, USERS)[:2]),
                                 3)
    path = str(tmp_path / "jax_index.npz")
    j_serving.save_index(j_index, path)
    index = serving.load_index(path, device="cpu")
    srv = serve_http.make_server(index, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    scores_all = u_final @ i_final.T
    for user in (0, 17, USERS - 1):
        code, body = _get(base + f"/recommend?user={user}&k=10")
        want_ids, want_scores = j_serving.recommend(j_index, jnp.asarray([user], dtype=jnp.int32), 10)
        want_ids, want_scores = np.asarray(want_ids[0]), np.asarray(want_scores[0])
        assert code == 200
        np.testing.assert_allclose(body["scores"], want_scores, rtol=1e-5)
        kth = want_scores[-1]
        for item in set(body["items"]) ^ set(want_ids.tolist()):
            assert abs(scores_all[user, item] - kth) <= 1e-5 * abs(kth), (user, item)
    srv.shutdown()
    srv.server_close()
    thread.join()
