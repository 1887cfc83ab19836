"""K4's piece-wise summation order on the CPU.

``csrc/segsum.cu`` sums a segment of at most one piece (256 edges) in one
warp, in edge order. A longer segment (a hub) is cut at the piece
boundaries: the piece where it starts leaves the partial of its edges up to
the next boundary, every later piece the partial of its own edges, each
summed in edge order in f32; the last piece to finish adds the partials in
piece order. The emulation below repeats that order in numpy float32 (a
float32 ``cumsum`` adds in sequence) and holds it against the plain version
(``segsum_plain``, ``index_add_``) within K4's tolerance, and against a
float64 sum, on a 38,400-edge hub among 307,200 edges (path C's rebuilt item
direction) and on the yelp-shape user layout."""

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.ops.kernels.segsum import segsum_plain

PIECE = 256  # kPiece of csrc/segsum.cu


def kernel_order_sum(msgs: np.ndarray, offsets: np.ndarray, piece: int = PIECE) -> np.ndarray:
    """(n, d) float32 segment sums in the kernel's order (see the module
    docstring); boundaries cut to [0, nnz] as the kernel cuts them."""
    nnz, d = msgs.shape
    n = offsets.shape[0] - 1
    cut = np.clip(offsets, 0, nnz)
    out = np.zeros((n, d), dtype=np.float32)

    def seq(a: int, b: int) -> np.ndarray:
        return np.cumsum(msgs[a:b], axis=0, dtype=np.float32)[-1]

    for s in range(n):
        lo, hi = int(cut[s]), int(cut[s + 1])
        if hi <= lo:
            continue
        if hi - lo <= piece:
            out[s] = seq(lo, hi)
            continue
        q0, q1 = lo // piece, (hi - 1) // piece
        parts = [seq(lo, (q0 + 1) * piece)]
        parts += [seq(q * piece, min(hi, (q + 1) * piece)) for q in range(q0 + 1, q1 + 1)]
        out[s] = np.cumsum(np.stack(parts), axis=0, dtype=np.float32)[-1]
    return out


def _offsets(ids: np.ndarray, n: int) -> np.ndarray:
    return np.searchsorted(ids, np.arange(n + 1), side="left").astype(np.int64)


def _layout(kind: str, rng) -> tuple[np.ndarray, int]:
    """Ascending segment ids of 307,200 edges (the last 20 are pads, id n)
    and n: path C's rebuilt item direction (one hub of 38,400 edges among
    20,000 items) or the yelp-shape user direction (38,403 users)."""
    nnz, pads = 307_200, 20
    if kind == "item_hub":
        n, hub = 20_000, 38_400
        hub_id = int(rng.integers(0, n))
        others = rng.integers(0, n - 1, nnz - pads - hub)
        others = others + (others >= hub_id)
        ids = np.concatenate([others, np.full(hub, hub_id)])
    else:
        n = 38_403
        ids = rng.integers(0, n, nnz - pads)
    return np.concatenate([np.sort(ids), np.full(pads, n)]), n


def _close(got: np.ndarray, want: np.ndarray, scale: np.ndarray) -> bool:
    """K4's tolerance (``tests/test_torch_gpu.py::segsum_close``): the
    summation order only, 1e-6 of the sum of the terms' magnitudes + 1e-6."""
    return bool((np.abs(got.astype(np.float64) - want) <= 1e-6 * scale + 1e-6).all())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["item_hub", "user"])
def test_kernel_order_within_tolerance(kind, dtype):
    rng = np.random.default_rng(1818)
    ids, n = _layout(kind, rng)
    offsets = _offsets(ids, n)
    msgs = rng.standard_normal((ids.shape[0], 16)).astype(np.float32)
    if dtype == "bf16":
        msgs = torch.from_numpy(msgs).to(torch.bfloat16).to(torch.float32).numpy()
    msgs[-20:] = np.nan  # the pads are never read
    real = int(offsets[-1])
    seg = np.repeat(np.arange(n), np.diff(offsets))
    exact = np.zeros((n, msgs.shape[1]))
    np.add.at(exact, seg, msgs[:real].astype(np.float64))
    scale = np.zeros((n, msgs.shape[1]))
    np.add.at(scale, seg, np.abs(msgs[:real]).astype(np.float64))

    got = kernel_order_sum(msgs, offsets)
    plain = segsum_plain(torch.from_numpy(msgs), torch.from_numpy(offsets)).numpy()
    assert np.isfinite(got).all()
    assert _close(got, plain.astype(np.float64), scale)
    assert _close(got, exact, scale)
    if kind == "item_hub":
        # the hub spans 151 pieces: its sum really is a sum of partials
        hub = int(np.argmax(np.diff(offsets)))
        lo, hi = offsets[hub], offsets[hub + 1]
        assert (hi - 1) // PIECE - lo // PIECE >= 150


# segment edge counts: segments straddling piece boundaries, one starting
# on a boundary, runs of empty segments, one longer than a piece by one edge
@pytest.mark.parametrize("counts", [[100, 300, 256, 1, 511, 2, 254, 600, 7],
                                    [256, 257, 0, 0, 513, 0, 3, 0, 0],
                                    [0, 0, 5, 0, 2000, 0]])
def test_kernel_order_edge_layouts(counts):
    rng = np.random.default_rng(7)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    msgs = rng.standard_normal((int(offsets[-1]) + 3, 8)).astype(np.float32)
    msgs[-3:] = np.nan
    got = kernel_order_sum(msgs, offsets)
    want = np.stack([msgs[a:b].astype(np.float64).sum(0) for a, b in zip(offsets[:-1], offsets[1:])])
    scale = np.stack([np.abs(msgs[a:b]).astype(np.float64).sum(0) for a, b in zip(offsets[:-1], offsets[1:])])
    assert _close(got, want, scale)
    assert not got[np.diff(offsets) == 0].any()
    # a segment of at most one piece is one sequential f32 sum, so the order
    # changes only the longer ones
    short = np.diff(offsets) <= PIECE
    for s in np.flatnonzero(short & (np.diff(offsets) > 0)):
        a, b = offsets[s], offsets[s + 1]
        assert np.array_equal(got[s], np.cumsum(msgs[a:b], axis=0, dtype=np.float32)[-1])
