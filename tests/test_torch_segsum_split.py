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

from diffmm_tpu_torch.ops.kernels.segsum import merge_group, segsum_plain

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


# ---------------------------------------------------------------- work split
# csrc/segsum.cu hands the segments to warps by a plan (segsum_plan): segment
# warp w takes the segments whose merge key s + offsets[s] lies in
# [w * group, (w + 1) * group) and walks their edges as one stream, except a
# last segment longer than a piece, which the piece warps sum (each piece
# warp its share of the long segment that holds its first edge, folded in
# piece order). The emulation below builds the plan as the plan's threads
# do and splits the work as the warps do; it must write every row once and
# give kernel_order_sum's bits.


def plan(offsets: np.ndarray, nnz: int, group: int, piece: int = PIECE):
    """segsum_plan's (first, pseg), one emulated thread per s in [0, n]."""
    n = offsets.shape[0] - 1
    cut = np.clip(offsets, 0, nnz)
    groups = -(-(n + nnz) // group)
    first = np.full(groups + 1, -2, dtype=np.int64)  # -2: never written
    pseg = np.full(-(-nnz // piece), -2, dtype=np.int64)
    for s in range(n + 1):
        lo, hi = int(cut[s]), int(cut[s + 1]) if s < n else nnz
        key_before = -1 if s == 0 else s - 1 + int(cut[s - 1])
        key = s + lo if s < n else groups * group
        w = (key_before + group) // group
        while w * group <= key and w <= groups:
            first[w] = s
            w += 1
        hub = s < n and hi - lo > piece
        q = ((0 if s == 0 else lo) + piece - 1) // piece
        while q * piece < hi:
            pseg[q] = s if hub and lo < q * piece else -1
            q += 1
    return first, pseg


def split_order_sum(msgs: np.ndarray, offsets: np.ndarray, group: int, piece: int = PIECE):
    """(n, d) float32 sums made warp by warp as csrc/segsum.cu splits the
    work, and the number of times each row was written."""
    nnz, d = msgs.shape
    n = offsets.shape[0] - 1
    cut = np.clip(offsets, 0, nnz)
    first, pseg = plan(offsets, nnz, group, piece)
    assert (first >= 0).all() and (pseg >= -1).all()  # the plan writes every entry
    keys = np.arange(n) + cut[:n]
    assert np.array_equal(first, np.searchsorted(keys, np.arange(len(first)) * group))
    out = np.zeros((n, d), dtype=np.float32)
    writes = np.zeros(n, dtype=np.int64)

    def put(s, acc):
        out[s] = acc
        writes[s] += 1

    for s0, s1 in zip(first[:-1], first[1:]):  # segment warps
        if s1 <= s0:
            continue
        hub = cut[s1] - cut[s1 - 1] > piece
        end = int(cut[s1 - 1] if hub else cut[s1])
        s1 -= int(hub)
        if s1 <= s0:
            continue
        acc, s, hi = np.zeros(d, np.float32), s0, int(cut[s0 + 1])
        for e in range(int(cut[s0]), end):
            while e >= hi:
                put(s, acc)
                acc, s = np.zeros(d, np.float32), s + 1
                hi = int(cut[s + 1])
            acc = acc + msgs[e]
        while s < s1:
            put(s, acc)
            acc, s = np.zeros(d, np.float32), s + 1

    def seq(a, b):
        return np.cumsum(msgs[a:b], axis=0, dtype=np.float32)[-1]

    parts = {}
    for w, s in enumerate(pseg):  # piece warps
        if s < 0:
            continue
        e0, e1 = w * piece, min((w + 1) * piece, nnz)
        lo, hi = int(cut[s]), int(cut[s + 1])
        if lo >= e0 - piece:
            parts[s, w - 1] = seq(lo, e0)
        parts[s, w] = seq(e0, min(hi, e1))
    for s in sorted({s for s, _ in parts}):
        lo, hi = int(cut[s]), int(cut[s + 1])
        acc = np.zeros(d, np.float32)
        for q in range(lo // piece, (hi - 1) // piece + 1):
            acc = acc + parts.pop((s, q))
        put(s, acc)
    assert not parts
    return out, writes


def _gather_layout(rng) -> tuple[np.ndarray, int]:
    """The loss gather's backward: 1,024 sorted indices over 9,308 rows, one
    index 300 times (mostly empty segments, one hub)."""
    idx = rng.integers(0, 9_308, 1_024)
    idx[:300] = 17
    return np.sort(idx), 9_308


# "wrapper": the group the wrapper picks for the layout (merge_group)
@pytest.mark.parametrize("group", ["wrapper", 64, 256, 1])
@pytest.mark.parametrize("kind", ["item_hub", "user", "gather"])
def test_work_split_gives_the_kernel_order(kind, group):
    rng = np.random.default_rng(1818)
    ids, n = _gather_layout(rng) if kind == "gather" else _layout(kind, rng)
    offsets = _offsets(ids, n)
    nnz = ids.shape[0]
    if group == "wrapper":
        group = merge_group(n, nnz)
    if group == 1 and kind != "gather":
        # a group per segment and per edge is slow in Python: the first
        # segments of the layout and their edges, and 20 edges past them
        offsets = offsets[: n // 16 + 1]
        nnz = int(offsets[-1]) + 20
    msgs = rng.standard_normal((nnz, 4)).astype(np.float32)
    msgs[int(offsets[-1]):] = np.nan  # past the last segment: never read
    got, writes = split_order_sum(msgs, offsets, group)
    assert (writes == 1).all()
    assert np.array_equal(got, kernel_order_sum(msgs, offsets))


@pytest.mark.parametrize("counts", [[100, 300, 256, 1, 511, 2, 254, 600, 7],
                                    [256, 257, 0, 0, 513, 0, 3, 0, 0],
                                    [0, 0, 5, 0, 2000, 0], [0] * 40 + [3] + [0] * 40, [257]])
@pytest.mark.parametrize("group", [64, 256, 1, 7])
def test_work_split_edge_layouts(counts, group):
    rng = np.random.default_rng(7)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    msgs = rng.standard_normal((int(offsets[-1]) + 3, 8)).astype(np.float32)
    msgs[-3:] = np.nan
    got, writes = split_order_sum(msgs, offsets, group)
    assert (writes == 1).all()
    assert np.array_equal(got, kernel_order_sum(msgs, offsets))
