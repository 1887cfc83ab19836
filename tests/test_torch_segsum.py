"""K4's plain version (diffmm_tpu_torch/ops/kernels/segsum.py) against the
JAX package's four sorted reductions on the same messages: the Pallas kernel
through ``sorted_segment_sum``, ``sorted_segment_sum_planned`` and
``ranked_segment_sum`` (interpret mode, as tests/test_segsum.py runs them)
and ``jax.ops.segment_sum``.

The ids have gaps (empty segments), a hub segment and sentinel pads
(id == n, zero messages, as the JAX contract asks). Tolerance for f32: rtol
1e-5, atol 1e-6. The plain version adds each segment's messages in edge
order; the Pallas kernel adds per-chunk one-hot products into its
accumulator, so the sums differ only in f32 association. bf16 messages are
exact in f32, so the same tolerance holds for them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.ops.pallas.segsum import (
    make_ranked_plan,
    make_segsum_plan,
    ranked_segment_sum,
    sorted_segment_sum,
    sorted_segment_sum_planned,
)
from diffmm_tpu_torch.ops.kernels.segsum import LAUNCHES, segment_offsets, segsum, segsum_plain

N, PADS, HUB, CHUNK = 60, 24, 17, 64


def _ids(rng):
    """Ascending ids: 0-3 edges for most segments, none for some (gaps), 90
    for the hub, then the sentinel pads."""
    counts = rng.integers(0, 4, N)
    counts[rng.choice(N, 12, replace=False)] = 0
    counts[HUB] = 90
    ids = np.repeat(np.arange(N, dtype=np.int32), counts)
    return np.concatenate([ids, np.full(PADS, N, np.int32)]), counts


def _msgs(rng, nnz, d, dtype):
    msgs = rng.standard_normal((nnz, d)).astype(np.float32)
    msgs[nnz - PADS:] = 0.0  # the JAX contract: pads carry zero messages
    if dtype == "bf16":
        msgs = np.array(jnp.asarray(msgs, jnp.bfloat16).astype(jnp.float32))
    return msgs


def _jax_msgs(msgs, dtype):
    return jnp.asarray(msgs, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _torch_msgs(msgs, dtype):
    return torch.as_tensor(msgs).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 192])
@pytest.mark.parametrize("reduction", ["kernel", "planned", "ranked", "xla"])
def test_plain_matches_jax_reductions(rng, reduction, d, dtype):
    ids, counts = _ids(rng)
    msgs = _msgs(rng, len(ids), d, dtype)
    jm, jids = _jax_msgs(msgs, dtype), jnp.asarray(ids)
    if reduction == "kernel":
        want = sorted_segment_sum(jm, jids, N, CHUNK, True)
    elif reduction == "planned":
        plan = make_segsum_plan(ids, N, d, chunk=CHUNK)
        assert plan is not None
        want = sorted_segment_sum_planned(jm, jids, N, plan, interpret=True)
    elif reduction == "ranked":
        want = ranked_segment_sum(jm, jids, N, make_ranked_plan(len(ids), d, chunk=CHUNK),
                                  interpret=True)
    else:  # JAX's _reduce_sorted promotes bf16 messages to f32 first
        want = jax.ops.segment_sum(jm.astype(jnp.float32), jids, num_segments=N,
                                   indices_are_sorted=True)
    got = segsum_plain(_torch_msgs(msgs, dtype), segment_offsets(torch.as_tensor(ids), N))
    assert got.dtype == torch.float32 and got.shape == (N, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    empty = counts == 0
    assert empty.any() and not got.numpy()[empty].any()


def test_offsets_and_cpu_dispatch(rng):
    ids, counts = _ids(rng)
    t_ids = torch.as_tensor(ids)
    offsets = segment_offsets(t_ids, N)
    assert offsets.dtype == torch.int64
    np.testing.assert_array_equal(offsets.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    assert offsets[-1] == len(ids) - PADS  # the pads lie past offsets[n]
    # the pads' messages are ignored, whatever they hold
    msgs = torch.as_tensor(_msgs(rng, len(ids), 16, "f32"))
    noisy = msgs.clone()
    noisy[-PADS:] = float("nan")
    before = LAUNCHES["segsum"]
    got = segsum(noisy, offsets)
    assert LAUNCHES["segsum"] == before  # the CPU takes the plain version
    torch.testing.assert_close(got, segsum_plain(msgs, offsets), rtol=0, atol=0)


def test_plain_cuts_offsets_to_the_messages():
    """Boundaries outside [0, nnz] take only the edges inside: what the
    kernel reads (csrc/segsum.cu cuts them the same way)."""
    msgs = torch.as_tensor(np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32))
    offsets = torch.tensor([-3, 2, 2, 5, 9])
    want = torch.stack([msgs[0:2].sum(0), torch.zeros(8), msgs[2:5].sum(0), msgs[5:6].sum(0)])
    torch.testing.assert_close(segsum(msgs, offsets), want, rtol=1e-6, atol=1e-6)
