"""A run whose timed path is broken underneath comes out not correct: each
fault a cell can have, planted in the program on the CPU at a tiny shape,
with the cell's own limits. (One chip: no exchange between chips to leave
out.)"""

from __future__ import annotations

import pytest
import torch

from benchmark import run as bench
from benchmark.tests.tiny import tiny_run

TRAIN = ["tiktok.train", "sports.train"]


def _correct(workload: str) -> bool:
    return bench.run_cell(tiny_run(workload, seed=99))["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_state_left_unchanged(workload, monkeypatch):
    from diffmm_tpu_torch.train import steps

    monkeypatch.setattr(steps, "adam_update", lambda params, grads, state, lr: state)
    assert _correct(workload) is False


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch(workload, monkeypatch):
    """Each block's losses over its first half, the mean over the rest."""
    from diffmm_tpu_torch.train import steps

    joint, diffusion = steps.joint_block, steps.diffusion_block

    def half_joint(params, state, adj, modal, feats, users, pos, neg, *args, **kwargs):
        h = users.shape[0] // 2
        return joint(params, state, adj, modal, feats, users[:h], pos[:h], neg[:h], *args, **kwargs)

    def half_diffusion(schedule, dn, states, feats, i_embs, store, users, weights, *args, **kwargs):
        weights = weights.clone()
        weights[weights.shape[0] // 2:] = 0.0
        return diffusion(schedule, dn, states, feats, i_embs, store, users, weights, *args, **kwargs)

    monkeypatch.setattr(steps, "joint_block", half_joint)
    monkeypatch.setattr(steps, "diffusion_block", half_diffusion)
    assert _correct(workload) is False


def test_sound_runs_are_correct():
    assert all(_correct(w) for w in TRAIN + ["sports.serve"])


def test_answer_altered(monkeypatch):
    """One served item of each answer replaced, where the answer is made."""
    from diffmm_tpu_torch.eval import serving

    original = serving.recommend

    def altered(index, users, k, *args, **kwargs):
        ids, scores = original(index, users, k, *args, **kwargs)
        worst = torch.argmin(index.u_final[users.long()] @ index.i_final.T, dim=1)
        ids = ids.clone()
        ids[:, -1] = worst.to(ids.dtype)
        return ids, scores

    monkeypatch.setattr(serving, "recommend", altered)
    assert _correct("sports.serve") is False
