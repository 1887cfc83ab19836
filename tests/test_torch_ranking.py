"""Port ranking eval (diffmm_tpu_torch/eval/ranking.py) against
diffmm_tpu/eval/ranking.py on the same embeddings: the dcg table, the masked
top-k (integers, exactly, on tie-free scores) and the metric sums (f32,
rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import torch

from diffmm_tpu.eval import ranking as jr
from diffmm_tpu_torch.eval import ranking as tr


def _case(rng, U=40, I=60, d=8, B=16, maxT=4, topk=10):
    u = rng.standard_normal((U, d)).astype(np.float32)
    i = rng.standard_normal((I, d)).astype(np.float32)
    store = (rng.random((U, I)) < 0.1).astype(np.int8)
    users = rng.integers(0, U, B).astype(np.int32)
    counts = rng.integers(0, maxT + 1, B).astype(np.int32)
    items = np.full((B, maxT), -1, np.int32)
    for b, c in enumerate(counts):
        items[b, :c] = rng.choice(I, c, replace=False)
    valid = np.arange(B) < B - 3
    return u, i, store, users, valid, items, counts, topk


def test_dcg_table_matches():
    for k in (1, 10, 20):
        np.testing.assert_array_equal(tr.dcg_table(k).numpy(), np.asarray(jr.dcg_table(k)))


def test_score_topk_and_metric_sums_match(rng):
    u, i, store, users, valid, items, counts, topk = _case(rng)
    got_idx = tr._plain_score_topk(torch.as_tensor(u[users]), torch.as_tensor(i),
                                   torch.as_tensor(store), torch.as_tensor(users), topk)
    want_idx = jr._plain_score_topk(jnp.asarray(u[users]), jnp.asarray(i), jnp.asarray(store),
                                    jnp.asarray(users), topk)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    got = tr._metric_sums(got_idx, torch.as_tensor(valid), torch.as_tensor(items),
                          torch.as_tensor(counts), tr.dcg_table(topk), topk)
    want = jr._metric_sums(want_idx, jnp.asarray(valid), jnp.asarray(items),
                           jnp.asarray(counts), jr.dcg_table(topk), topk)
    np.testing.assert_allclose(np.array([float(x) for x in got]),
                               np.array([float(x) for x in want]), rtol=1e-6)


def test_eval_epoch_matches(rng):
    u, i, store, _, _, _, _, topk = _case(rng)
    nb, B = 3, 8
    users = rng.integers(0, u.shape[0], (nb, B)).astype(np.int32)
    valid = np.ones((nb, B), bool)
    valid[-1, 5:] = False
    counts = rng.integers(1, 4, (nb, B)).astype(np.int32)
    items = np.full((nb, B, 3), -1, np.int32)
    for b in range(nb):
        for r in range(B):
            items[b, r, : counts[b, r]] = rng.choice(i.shape[0], counts[b, r], replace=False)
    got = tr.eval_epoch(torch.as_tensor(u), torch.as_tensor(i), torch.as_tensor(users),
                        torch.as_tensor(valid), torch.as_tensor(store), torch.as_tensor(items),
                        torch.as_tensor(counts), tr.dcg_table(topk), topk)
    want = jr.make_eval_epoch(topk)(jnp.asarray(u), jnp.asarray(i), jnp.asarray(users),
                                    jnp.asarray(valid), jnp.asarray(store), jnp.asarray(items),
                                    jnp.asarray(counts), jr.dcg_table(topk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
