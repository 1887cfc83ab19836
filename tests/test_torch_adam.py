"""Adam's one pass (``ops/kernels/adam.py``, ``csrc/adam.cu``) and where
``train/optim.py::adam_update`` sends each tree.

On the CPU: f32 trees keep ``_adam_f32``'s ``_foreach`` passes and bf16
trees their op-by-op step, as before; the pass counts 28 bytes a
parameter, and a captured step's counts come back at each replay. On a card
(``gpu``; the ``cuda`` fixture skips without one): the pass bit for bit
``_adam_f32`` over 20 steps at each benchmark configuration's trees, at
leaves of 1 and 63,001 elements and on misaligned views of one flat buffer,
inside a captured CUDA graph too, one launch a tree a step on a training
epoch, and a refusal of what it does not take.

Run the card's tests with ``python -m pytest tests/test_torch_adam.py -q
--noconftest -p no:cacheprovider``."""

import contextlib
import pathlib

import pytest
import torch

from diffmm_tpu_torch.ops.kernels import add_work, count, work_counts
from diffmm_tpu_torch.ops.kernels import adam as kernel
from diffmm_tpu_torch.train import optim
from diffmm_tpu_torch.train.optim import AdamState, _adam_f32, adam_init, adam_scalars, adam_update, tree_leaves


def _tree(gen, dtype=torch.float32, device="cpu"):
    return {"w": torch.randn((7, 5), generator=gen).to(device, dtype),
            "b": [torch.randn((5,), generator=gen).to(device, dtype),
                  torch.randn((1,), generator=gen).to(device, dtype)]}


def _grads(gen, leaves, scale=1e-2):
    return [(torch.randn(p.shape, generator=gen) * scale).to(p.device, p.dtype) for p in leaves]


def _clone_state(state: AdamState) -> AdamState:
    return AdamState(state.count, [m.clone() for m in state.mu], [v.clone() for v in state.nu])


def _refuse(*_, **__):
    raise AssertionError("the wrong route took the step")


@pytest.mark.parametrize("rows", [False, True], ids=["float_lr", "scalar_rows"])
def test_cpu_f32_tree_takes_the_foreach_passes(monkeypatch, rows):
    """A CPU f32 tree goes to ``_adam_f32`` (never to the card's pass),
    with the results ``_adam_f32`` gives on copies."""
    gen = torch.Generator().manual_seed(0)
    params = _tree(gen)
    state = adam_init(params)
    twin, twin_state = [p.clone() for p in tree_leaves(params)], _clone_state(state)
    calls = []

    def spy(*args):
        calls.append(len(args[0]))
        return _adam_f32(*args)

    monkeypatch.setattr(optim, "_adam_f32", spy)
    monkeypatch.setattr(optim, "fused_adam", _refuse)
    sc = torch.as_tensor(adam_scalars(3e-3, 0, 4))
    for k in range(4):
        grads = _grads(gen, twin)
        adam_update(params, grads, state, sc[k] if rows else 3e-3)
        _adam_f32(twin, grads, twin_state.mu, twin_state.nu, sc[k, 0], sc[k, 1], sc[k, 2])
    assert calls == [3] * 4
    assert state.count == (0 if rows else 4)
    for a, b in zip([*tree_leaves(params), *state.mu, *state.nu], [*twin, *twin_state.mu, *twin_state.nu]):
        assert torch.equal(a, b)


def test_cpu_bf16_tree_keeps_its_op_by_op_step(monkeypatch):
    """A bf16 tree takes neither f32 route: each operation rounds to bf16,
    its constants cast as JAX casts a weak scalar, the update applied in
    f32 and rounded once."""
    monkeypatch.setattr(optim, "_adam_f32", _refuse)
    monkeypatch.setattr(optim, "fused_adam", _refuse)
    gen = torch.Generator().manual_seed(1)
    params = _tree(gen, torch.bfloat16)
    state = adam_init(params)
    want = [p.clone() for p in tree_leaves(params)]
    mu, nu = [m.clone() for m in state.mu], [v.clone() for v in state.nu]

    def c(x):
        return float(torch.tensor(x, dtype=torch.float64).to(torch.bfloat16))

    for k in range(3):
        grads = _grads(gen, want)
        adam_update(params, grads, state, 2e-3)
        lr, bc1, bc2 = torch.as_tensor(adam_scalars(2e-3, k, 1)[0])
        for p, g, m, v in zip(want, grads, mu, nu):
            m.copy_(g * c(1 - 0.9) + m * c(0.9))
            v.copy_(torch.square(g) * c(1 - 0.999) + v * c(0.999))
            u = (m / bc1.to(p.dtype)) / (torch.sqrt(v / bc2.to(p.dtype)) + c(1e-8))
            p.copy_(p.float() - lr * u.float())
    for a, b in zip([*tree_leaves(params), *state.mu, *state.nu], [*want, *mu, *nu]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 63001, 258_000_000])
def test_adam_bytes_are_28_a_parameter(n):
    """p, g and both moments read once, p and both moments written once."""
    assert kernel.least_bytes(n) == 28 * n == (4 + 3) * 4 * n
    work = work_counts()
    assert "adam" in work and "adam.bytes" in work
    count("adam", kernel.least_bytes(n))
    after = work_counts()
    assert after["adam"] == work["adam"] + 1 and after["adam.bytes"] == work["adam.bytes"] + 28 * n
    add_work({"adam": -1, "adam.bytes": -28 * n})
    assert work_counts() == work


class _Stream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


class _Graph:
    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass


def test_captured_step_counts_come_back_on_replay(monkeypatch):
    """``train/graphs.py`` takes the capture's Adam launch and bytes back
    and adds them at every replay (the capture machinery stubbed: a CPU has
    no graphs), so the counters read one launch and 28 bytes a parameter
    for every step the graph ran."""
    from diffmm_tpu_torch.train.graphs import BlockGraph

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    n = 63001

    def step(x):  # where the wrapper counts a launch over n parameters
        count("adam", kernel.least_bytes(n))

    graph = BlockGraph(step, torch.Generator(), _Stream(), phase="diffusion")
    before = work_counts()
    for _ in range(6):  # the eager step and its capture, then 5 replays
        graph(torch.zeros(1))
    after = work_counts()
    assert graph.work == {"adam": 1, "adam.bytes": 28 * n} and graph.replays == 5
    assert after["adam"] - before["adam"] == 6 and after["adam.bytes"] - before["adam.bytes"] == 6 * 28 * n


# ------------------------------------------------------------------ the card
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# the benchmark's configurations: (users, items, feature widths), hidden
# 1,024, time embedding 10, latdim 64
CELLS = {"tiktok": (9308, 6710, [128, 768, 128]), "sports": (35598, 18357, [4096, 1024]),
         "electronics": (48101, 63001, [4096, 1024])}


def _cell_trees(name, which, device):
    from diffmm_tpu_torch.models.denoise import init_denoise_params
    from diffmm_tpu_torch.models.gcn import init_gcn_params

    U, I, feats = CELLS[name]
    gen = torch.Generator(device=device).manual_seed(5)
    if which == "denoisers":
        return [tree_leaves(init_denoise_params(gen, I, [1024], 10, 64, device)) for _ in feats]
    return [tree_leaves(init_gcn_params(gen, U, I, 64, feats, device))]


def _flat_views(gen, shapes, device, offset=0, scale=1e-3):
    """Views of one flat buffer cut at the shapes' boundaries after
    ``offset`` floats (a mesh's summed gradients)."""
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    flat = torch.randn(offset + sum(sizes), generator=gen, device=device) * scale
    return [part.view(s) for part, s in zip(flat[offset:].split(sizes), shapes)]


def _twenty_steps(trees, grads_of, device):
    """20 steps of the card's pass and of ``_adam_f32`` on copies, from zero
    moments, one row of ``adam_scalars`` a step; True where every leaf and
    moment is bitwise equal after each step."""
    mus = [[torch.zeros_like(p) for p in t] for t in trees]
    nus = [[torch.zeros_like(p) for p in t] for t in trees]
    twins = ([[p.clone() for p in t] for t in trees], [[m.clone() for m in t] for t in mus],
             [[v.clone() for v in t] for t in nus])
    rows = torch.as_tensor(adam_scalars(1e-3, 0, 20), device=device)
    for k in range(20):
        for i, (t, mu, nu, tp, tm, tn) in enumerate(zip(trees, mus, nus, *twins)):
            g = grads_of(k, i)
            kernel.fused_adam(t, g, mu, nu, rows[k])
            _adam_f32(tp, g, tm, tn, rows[k, 0], rows[k, 1], rows[k, 2])
        torch.cuda.synchronize()
        for xs, ys in zip((trees, mus, nus), twins):
            for x, y in zip(xs, ys):
                for a, b in zip(x, y):
                    if not torch.equal(a, b):
                        return False
    return True


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["denoisers", "gcn"])
@pytest.mark.parametrize("name", list(CELLS))
def test_fused_adam_is_foreach_bit_for_bit_at_the_cells_trees(cuda, name, which):
    """Each configuration's trees (electronics's two 129 M denoisers, its
    gradients views of one flat buffer as a mesh sums them), 20 steps."""
    trees = _cell_trees(name, which, cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    flat = name == "electronics" and which == "denoisers"
    if flat:
        grads = _flat_views(gen, [p.shape for t in trees for p in t], cuda)
        per_tree, at = [], 0
        for t in trees:
            per_tree.append(grads[at:at + len(t)])
            at += len(t)
        grads_of = lambda k, i: [g.mul_(0.9).add_(1e-4 * (k + 1)) for g in per_tree[i]]  # noqa: E731
    else:
        grads = [[torch.randn(p.shape, generator=gen, device=cuda) * 1e-2 for p in t] for t in trees]
        grads_of = lambda k, i: [g.mul_(-0.9).add_(1e-4 * (k + 1)) for g in grads[i]]  # noqa: E731
    before = kernel.LAUNCHES["adam"]
    assert _twenty_steps(trees, grads_of, cuda)
    assert kernel.LAUNCHES["adam"] - before == 20 * len(trees)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_fused_adam_at_odd_leaves_and_misaligned_views(cuda, offset):
    """Leaves of 1 and 63,001 elements and others; gradients views of one
    flat buffer at every alignment; leaves and moments themselves
    misaligned views (16-byte body after a head, or single elements where p,
    mu and nu differ in alignment); a tree over 48 leaves (two launches)."""
    gen = torch.Generator(device=cuda).manual_seed(11 + offset)
    shapes = [(1,), (63001,), (3,), (1024, 7), (5,), (63001, 3), (2,), (64,)]
    grads = _flat_views(gen, shapes, cuda, offset)
    trees = [[p.clone() * 10 for p in _flat_views(gen, shapes, cuda, offset, scale=1.0)]]
    assert _twenty_steps(trees, lambda k, i: [g.mul_(0.5).add_(1e-3) for g in grads], cuda)
    # leaves, moments and gradients each at their own alignment
    leaves = _flat_views(gen, shapes, cuda, offset, scale=1.0)
    mu = [m.zero_() for m in _flat_views(gen, shapes, cuda, (offset + 1) % 4)]
    nu = [v.zero_() for v in _flat_views(gen, shapes, cuda, (offset + 2) % 4)]
    g = _flat_views(gen, shapes, cuda, (offset + 3) % 4)
    twin = [p.clone() for p in leaves], [m.clone() for m in mu], [v.clone() for v in nu]
    for row in torch.as_tensor(adam_scalars(1e-2, 0, 5), device=cuda):
        kernel.fused_adam(leaves, g, mu, nu, row)
        _adam_f32(*twin[:1], g, *twin[1:], row[0], row[1], row[2])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for xs, ys in zip((leaves, mu, nu), twin) for a, b in zip(xs, ys))
    many = [torch.randn((k + 1,), generator=gen, device=cuda) for k in range(100)]
    before = kernel.LAUNCHES["adam"]
    assert _twenty_steps([many], lambda k, i: [p * 1e-2 + k for p in many], cuda)
    assert kernel.LAUNCHES["adam"] - before == 20 * 3  # 100 leaves: launches of 48, 48 and 4


@pytest.mark.gpu
def test_fused_adam_in_a_captured_graph_replayed(cuda):
    """One step captured with the scalars in a slot, replayed 5 times with
    each step's row: bitwise ``_adam_f32``'s 6 steps, and the counters read
    6 launches and their bytes (the capture's taken back, each replay's
    added: ``train/graphs.py``)."""
    from diffmm_tpu_torch.train.graphs import BlockGraph

    trees = _cell_trees("tiktok", "denoisers", cuda)[:1]
    (leaves,) = trees
    gen = torch.Generator(device=cuda).manual_seed(3)
    grads = [torch.randn(p.shape, generator=gen, device=cuda) * 1e-2 for p in leaves]
    state = adam_init({"t": leaves})
    twin = [p.clone() for p in leaves], _clone_state(state)
    rows = torch.as_tensor(adam_scalars(1e-3, 0, 6), device=cuda)

    def step(row):
        for g in grads:
            g.mul_(0.99)
        adam_update({"t": leaves}, grads, state, row)

    before = work_counts()
    graph = BlockGraph(step, torch.Generator(device=cuda), torch.cuda.Stream(cuda), phase="diffusion")
    for k in range(6):
        graph(rows[k])
    torch.cuda.synchronize()
    after = work_counts()
    n = sum(p.numel() for p in leaves)
    assert graph.replays == 5 and graph.work == {"adam": 1, "adam.bytes": 28 * n}
    assert after["adam"] - before["adam"] == 6 and after["adam.bytes"] - before["adam.bytes"] == 6 * 28 * n
    gen = torch.Generator(device=cuda).manual_seed(3)
    g_ref = [torch.randn(p.shape, generator=gen, device=cuda) * 1e-2 for p in leaves]
    # the graph's first call ran the step eagerly, then captured it (running
    # nothing): 6 steps in all, the gradients decayed once a step
    for k in range(6):
        for g in g_ref:
            g.mul_(0.99)
        _adam_f32(twin[0], g_ref, twin[1].mu, twin[1].nu, rows[k, 0], rows[k, 1], rows[k, 2])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip([*leaves, *state.mu, *state.nu],
                                                 [*twin[0], *twin[1].mu, *twin[1].nu]))


@pytest.mark.gpu
def test_fused_adam_refuses_what_it_does_not_take(cuda):
    leaves = [torch.randn((8, 4), device=cuda)]
    g, mu, nu = [torch.randn_like(leaves[0])], [torch.zeros_like(leaves[0])], [torch.zeros_like(leaves[0])]
    row = torch.as_tensor(adam_scalars(1e-3, 0, 1)[0], device=cuda)
    kernel.fused_adam(leaves, g, mu, nu, row)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.fused_adam([leaves[0].t()], [g[0].t()], [mu[0].t()], [nu[0].t()], row)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.fused_adam(leaves, [torch.randn((4, 8), device=cuda).t()], mu, nu, row)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.fused_adam([p.cpu() for p in leaves], [x.cpu() for x in g], [x.cpu() for x in mu],
                          [x.cpu() for x in nu], row.cpu())
    with pytest.raises(ValueError, match="on cuda"):
        kernel.fused_adam(leaves, [g[0].cpu()], mu, nu, row)
    with pytest.raises(ValueError, match="f32"):
        kernel.fused_adam(leaves, [g[0].bfloat16()], mu, nu, row)
    with pytest.raises(ValueError, match="is \\(4, 8\\)"):
        kernel.fused_adam(leaves, [g[0].reshape(4, 8)], mu, nu, row)
    with pytest.raises(ValueError, match="scalars"):
        kernel.fused_adam(leaves, g, mu, nu, row[:2])


@pytest.mark.gpu
def test_an_epoch_launches_one_pass_a_tree_a_step(cuda):
    """A tiktok-shaped Coach's second epoch (its steps replayed from
    graphs): Adam's launches are the diffusion blocks times the denoisers
    plus the joint blocks, and each counts 28 bytes a parameter."""
    from diffmm_tpu_torch.config import load_config
    from diffmm_tpu_torch.data.synthetic import synthesize_shape
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import NullLog

    cfg = load_config(str(pathlib.Path(__file__).resolve().parent.parent / "conf" / "tiktok.toml"))
    coach = Coach(cfg, synthesize_shape(cfg, "tiktok"), device=cuda, log=NullLog())
    coach.train_epoch(0)
    before = work_counts()
    coach.train_epoch(1)
    after = work_counts()
    n_diff = -(-coach.host.user_num // cfg.train.batch)
    n_joint = -(-coach.host.nnz // cfg.train.batch)
    dn = sum(p.numel() for t in coach.dn_params for p in tree_leaves(t))
    gcn = sum(p.numel() for p in tree_leaves(coach.gcn_params))
    assert after["adam"] - before["adam"] == n_diff * len(coach.dn_params) + n_joint
    assert after["adam.bytes"] - before["adam.bytes"] == 28 * (n_diff * dn + n_joint * gcn)
