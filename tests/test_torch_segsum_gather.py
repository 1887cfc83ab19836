"""K4's gather-fused entry (diffmm_tpu_torch/ops/kernels/segsum.py,
``segsum_gather``) against the JAX package's composition on the same
inputs: ``sorted_segment_sum`` (the Pallas kernel in interpret mode, as
tests/test_segsum.py runs it) over ``jnp.where(valid, cast(z).take(clip(src)),
0)``, the gather and mask of ``_get_propagator``
(``diffmm_tpu/ops/graph.py:339-392``), one call a modality, side by side.

The inputs have gaps (empty segments), a hub of 300 edges (longer than the
kernel's 256-edge piece), sentinel pads (id == n, their index one past the
table) and indices >= R (zero rows, as the JAX backward masks
``src_rows < n_out``), one modality and three, f32 and bf16 tables.
Tolerance as tests/test_torch_segsum.py, rtol 1e-5 and atol 1e-6, with the
rtol taken of the sum of the terms' magnitudes (K4's rule,
tests/test_torch_segsum_split.py): the same terms summed in another f32
order, which moves a sum that cancels (the 300-edge hub) by more than 1e-5
of its value; bf16 rows are exact in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmm_tpu.ops.pallas.segsum import sorted_segment_sum
from diffmm_tpu_torch.ops.kernels.segsum import (
    LAUNCHES, MAX_MODAL, segment_offsets, segsum_gather, segsum_gather_plain, segsum_plain,
)

N, R, PADS, HUB, CHUNK = 60, 45, 24, 17, 64


def _inputs(rng, M, d, dtype):
    """ids (ascending, gaps, a hub, pads), M index vectors (a tenth of them
    past the table, the pads' one past it) and M tables."""
    counts = rng.integers(0, 4, N)
    counts[rng.choice(N, 12, replace=False)] = 0
    counts[HUB] = 300
    ids = np.concatenate([np.repeat(np.arange(N, dtype=np.int32), counts), np.full(PADS, N, np.int32)])
    nnz, real = len(ids), len(ids) - PADS
    srcs = []
    for _ in range(M):
        src = rng.integers(0, R, nnz).astype(np.int32)
        src[rng.choice(real, real // 10, replace=False)] = R + rng.integers(0, 3, real // 10)
        src[real:] = R
        srcs.append(src)
    tables = rng.standard_normal((M, R, d)).astype(np.float32)
    if dtype == "bf16":
        tables = np.asarray(jnp.asarray(tables, jnp.bfloat16).astype(jnp.float32))
    return ids, counts, srcs, tables


def _jax(ids, srcs, tables, dtype):
    out = []
    for src, table in zip(srcs, tables):
        z = jnp.asarray(table, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
        jsrc = jnp.asarray(src)
        msgs = z.take(jnp.clip(jsrc, 0, R - 1), axis=0)
        valid = (jsrc < R) & (jnp.asarray(ids) < N)
        msgs = jnp.where(valid[:, None], msgs, 0.0)
        out.append(np.asarray(sorted_segment_sum(msgs, jnp.asarray(ids), N, CHUNK, True), np.float32))
    return np.concatenate(out, axis=1)


def _torch(ids, srcs, tables, dtype):
    t = torch.from_numpy(np.array(tables)).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    s = [torch.as_tensor(x) for x in srcs]
    offsets = segment_offsets(torch.as_tensor(ids), N)
    return (t[0], s[0]) if len(srcs) == 1 else (t, s), offsets


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("M", [1, 3])
def test_plain_matches_jax_composition(rng, M, d, dtype):
    ids, counts, srcs, tables = _inputs(rng, M, d, dtype)
    want = _jax(ids, srcs, tables, dtype)
    (table, src), offsets = _torch(ids, srcs, tables, dtype)
    got = segsum_gather_plain(table, src, offsets)
    assert got.dtype == torch.float32 and got.shape == (N, M * d)
    scale = segsum_gather_plain(table.abs(), src, offsets).numpy()
    assert (np.abs(got.numpy() - want) <= 1e-5 * scale + 1e-6).all()
    assert not got.numpy()[counts == 0].any()
    assert (np.diff(offsets.numpy()) > 256).any()  # the hub is longer than a piece


def test_cpu_entry_is_the_plain_version(rng):
    """On CPU tensors the entry runs the plain version and launches nothing;
    it equals the unfused route on explicitly gathered rows, bit for bit."""
    ids, _, srcs, tables = _inputs(rng, 3, 16, "f32")
    (table, src), offsets = _torch(ids, srcs, tables, "f32")
    before = dict(LAUNCHES)
    got = segsum_gather(table, src, offsets)
    assert LAUNCHES == before
    padded = torch.cat([table, torch.zeros((3, 1, 16))], dim=1)
    msgs = torch.cat([padded[m].index_select(0, s.clamp_max(R).long()) for m, s in enumerate(src)], dim=1)
    assert torch.equal(got, segsum_plain(msgs, offsets))
    # the three modalities side by side are three one-modality calls
    parts = [segsum_gather(table[m], s, offsets) for m, s in enumerate(src)]
    assert torch.equal(got, torch.cat(parts, dim=1))


def test_pads_and_rows_past_the_table_add_nothing(rng):
    """The pads' rows (a NaN row only they name) are never read; an index
    past the table adds a zero row."""
    table = torch.randn((5, 8))
    table[4] = float("nan")
    src = torch.tensor([0, 7, 2, 5, 1, 4, 4], dtype=torch.int32)  # 7 and 5: past the table
    offsets = torch.tensor([0, 2, 2, 5], dtype=torch.int64)  # the last two edges are pads
    got = segsum_gather(table, src, offsets)
    want = torch.stack([table[0], torch.zeros(8), table[2] + table[1]])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_modality_limit_is_refused(rng):
    M = MAX_MODAL + 1
    table = torch.zeros((M, 4, 8))
    src = [torch.zeros(6, dtype=torch.int32)] * M
    with pytest.raises(ValueError, match=f"1 to {MAX_MODAL}"):
        segsum_gather(table, src, torch.tensor([0, 3, 6]))
    # at the limit it runs
    assert segsum_gather(table[:MAX_MODAL], src[:MAX_MODAL], torch.tensor([0, 3, 6])).shape == (2, MAX_MODAL * 8)


def test_what_the_entry_does_not_take_is_refused():
    table = torch.zeros((4, 8))
    offsets = torch.tensor([0, 3, 6])
    with pytest.raises(TypeError, match="int32"):
        segsum_gather(table, torch.zeros(6, dtype=torch.int64), offsets)
    with pytest.raises(TypeError, match="f32 or bf16"):
        segsum_gather(table.to(torch.int32), torch.zeros(6, dtype=torch.int32), offsets)
    with pytest.raises(ValueError, match="index vectors"):
        segsum_gather(table, [torch.zeros(6, dtype=torch.int32)] * 2, offsets)
    with pytest.raises(TypeError, match="one length"):
        segsum_gather(torch.zeros((2, 4, 8)), [torch.zeros(6, dtype=torch.int32),
                                               torch.zeros(5, dtype=torch.int32)], offsets)
