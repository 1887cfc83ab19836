"""Plain top-k serving: the reference that the serving cells are held to.

A request's answer is the k items of the catalog with the highest inner
product with the user's embedding, the user's train items excluded, in
descending order. The seen lists are made here from the train edges; the
products run in float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

_CHUNK = 4096


def _seen(rows: np.ndarray, cols: np.ndarray, users: np.ndarray, item_num: int):
    """(n, width) seen items of each request's user, padded with -1."""
    order = np.argsort(rows, kind="stable")
    r, c = rows[order], cols[order]
    starts = np.searchsorted(r, users, side="left")
    ends = np.searchsorted(r, users, side="right")
    width = max(int((ends - starts).max()), 1)
    lanes = np.arange(width)
    pos = np.minimum(starts[:, None] + lanes[None, :], len(c) - 1)
    return np.where(lanes[None, :] < (ends - starts)[:, None], c[pos], -1)


def scores_of(u_emb: torch.Tensor, i_emb: torch.Tensor, rows, cols, users: np.ndarray, tf32: bool = False):
    """(n, I) f32 scores of the requests' users, seen items at -inf."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        dev = u_emb.device
        s = u_emb[torch.as_tensor(users, device=dev)] @ i_emb.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    seen = torch.as_tensor(_seen(rows, cols, users, i_emb.shape[0]), device=s.device)
    r = torch.arange(len(users), device=s.device)[:, None].expand_as(seen)
    keep = seen >= 0
    s[r[keep], seen[keep]] = -torch.inf
    return s


def answers(u_emb, i_emb, rows, cols, users: np.ndarray, k: int, tf32: bool = False):
    """The reference's (ids, scores) of each request, (n, k) numpy."""
    ids, vals = [], []
    for lo in range(0, len(users), _CHUNK):
        s = scores_of(u_emb, i_emb, rows, cols, users[lo:lo + _CHUNK], tf32)
        v, i = torch.topk(s, k, dim=1)
        ids.append(i.cpu().numpy())
        vals.append(v.cpu().numpy())
    return np.concatenate(ids), np.concatenate(vals)


def answer_numbers(u_emb, i_emb, rows, cols, users: np.ndarray, ids: np.ndarray, scores: np.ndarray,
                   k: int) -> dict:
    """The serving cells' numbers over every answer: ``score_gap`` the
    widest gap between a served score and the reference's score of the
    served item, ``rank_gap`` the widest gap by which the r-th served item
    lies below the reference's r-th best; both over the user's bound on a
    score, ``|u| * max_i |i|``. A seen item served, or a row short of k,
    reads inf."""
    i_max = float(torch.linalg.vector_norm(i_emb, dim=1).max())
    score_gap = rank_gap = 0.0
    for lo in range(0, len(users), _CHUNK):
        hi = min(lo + _CHUNK, len(users))
        s = scores_of(u_emb, i_emb, rows, cols, users[lo:hi])
        best = torch.topk(s, k, dim=1).values
        served = torch.as_tensor(ids[lo:hi], device=s.device).long()
        if served.shape[1] != k or bool(((served < 0) | (served >= s.shape[1])).any()):
            return {"score_gap": float("inf"), "rank_gap": float("inf")}
        at = torch.gather(s, 1, served)
        scale = torch.linalg.vector_norm(u_emb[torch.as_tensor(users[lo:hi], device=s.device)], dim=1)[:, None] * i_max
        got = torch.as_tensor(scores[lo:hi], device=s.device)
        score_gap = max(score_gap, float(((got - at).abs() / scale).max()))
        rank_gap = max(rank_gap, float(((best - at) / scale).max()))
    return {"score_gap": score_gap, "rank_gap": rank_gap}
