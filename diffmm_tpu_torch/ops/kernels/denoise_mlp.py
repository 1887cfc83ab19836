"""K2 and K3: the single-hidden-layer denoiser forward.

Counterpart of ``diffmm_tpu/ops/pallas/denoise_mlp.py``
(``fused_denoise_mlp``; kernels ``_layer1_kernel`` and ``_layer2_kernel``):

    K2: h   = tanh(x @ W1x + temb_proj)      (b1 folded into temb_proj)
    K3: out = h @ W2 + b2

with f32 accuracy. On one device K2 applies the tanh in its epilogue, as
the TPU kernel does (:func:`denoise_layer1`). On a mesh W1x is cut by its
catalog rows and W2 by its catalog columns (``parallel/sharding.py``); the
tanh cannot be cut, so K2 then runs as :func:`denoise_layer1_partial`, the
raw product ``x_s @ W1x_s`` of the rank's catalog columns, the ranks'
products are summed over the model axis, and the tanh follows
(:func:`denoise_forward_fused`); K3 runs on the rank's columns as it
stands. A mesh runs the partial form at any model axis, 1 included, so that
every model-axis collective runs wherever there is a mesh; the kernel's
epilogue and the tanh after it are the same f32 add and ``tanhf``, so a
mesh of one rank computes what one device does, bit for bit. The hand
kernels are ``csrc/denoise_mlp.cu``: 3xTF32
products on the tensor cores, whose source note gives their design and
bound. Each entry runs one of two forms of the kernel, picked by
:func:`denoise_form` from the contraction depth alone: the gemm form for a
deep contraction (the rebuild's K2 over the catalog, K3 at a hidden width
of 1,024), the strip form for one of at most 64 (K3 at web scale's hidden
width of 64), where the output's store sets the time; both compute the
same bits. They take the weights in their own layout, :class:`KernelWeight`,
made by :func:`prepare_weight`: transposed, padded, split into TF32 hi and
lo halves and swizzled. The weights do not change during a rebuild, so the
rebuild prepares each denoiser once (:func:`prepare_denoiser`) and
:func:`denoise_forward_fused`, the counterpart of ``denoise_forward_pallas``,
runs every step and block on the prepared form. The wrappers
:func:`denoise_layer1`, :func:`denoise_layer1_partial` and
:func:`denoise_layer2` also take the JAX layouts and then prepare per call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from diffmm_tpu_torch.models.denoise import timestep_embedding
from diffmm_tpu_torch.ops.kernels import check_launch, load_library, round_up, sm_count
from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"denoise_layer1": 0, "denoise_layer1_partial": 0, "denoise_layer2": 0}

KT = 32  # contraction depth of a kernel tile (kBK in csrc/denoise_mlp.cu)
NT = 128  # N padding of the prepared weights (kPadN)
STRIP_MAX_K = 64  # the strip form's deepest contraction (kStripMaxKt slabs)
STRIP_N = 128  # the strip form's strip width (kStripN)
FORMS = ("gemm", "strip")


def denoise_form(k: int) -> str:
    """The kernel form for a product over a contraction ``k`` deep:
    ``"strip"`` where ``k <= 64``, ``"gemm"`` otherwise. At 64 deep and
    less a tile's products are two 32-deep steps and its store sets its
    time, so the strip form (a persistent grid that stages each tile in
    shared memory and stores it while the next one computes) runs; deeper,
    the tensor cores set it, and the gemm form (split-K, a weight ring) runs.
    The two forms compute the same bits; the choice is by shape alone."""
    return "strip" if k <= STRIP_MAX_K else "gemm"


def strip_blocks(m: int, n: int, n_sm: int) -> int:
    """The strip form's persistent grid for an (m, n) output: one block an
    SM, at most one a (strip, 128-row tile) unit."""
    return min(n_sm, -(-n // STRIP_N) * -(-m // 128))


def layer1_plain(x: torch.Tensor, w1x: torch.Tensor, temb_proj: torch.Tensor) -> torch.Tensor:
    """Plain K2: ``tanh(x @ w1x + temb_proj)``."""
    return torch.tanh(x @ w1x + temb_proj)


def layer1_partial_plain(x: torch.Tensor, w1x: torch.Tensor) -> torch.Tensor:
    """Plain K2 partial: ``x @ w1x``."""
    return x @ w1x


def layer2_plain(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain K3: ``h @ w2 + b2``."""
    return h @ w2 + b2


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi`` = f32 ``w`` rounded to TF32 (10 mantissa
    bits, to nearest, ties away from zero: the kernel's ``cvt.rna.tf32.f32``)
    and ``lo = w - hi``, exact in f32, so ``hi + lo == w`` bit for bit."""
    bits = w.view(torch.int32)
    mag = bits & 0x7FFFFFFF
    # add half of the 13 dropped bits to the magnitude, then drop them
    # (inf and NaN kept as they are)
    rounded = torch.where(mag < 0x7F800000, (mag + 0x1000) & -0x2000, mag)
    hi = (rounded | (bits & -0x80000000)).view(torch.float32)
    lo = w - hi
    # a zero lo takes w's sign, so that hi + lo gives back -0 too
    return hi, torch.where(lo == 0, torch.copysign(lo, w), lo)


@dataclasses.dataclass(frozen=True)
class KernelWeight:
    """A (k, n) f32 weight in K2/K3's layout: ``data`` (2, ceil(k / 32),
    round_up(n, 128), 32) holds the TF32 hi half of the transpose in [0] and
    the lo half in [1], as 32-deep slabs with zeros past k and n, each row
    permuted and swizzled as ``csrc/denoise_mlp.cu`` describes."""

    data: torch.Tensor
    k: int
    n: int


@functools.cache
def _slab_columns(device: torch.device) -> torch.Tensor:
    """(8, 32): the slab column that each stored position of a row holds,
    for each row class n % 8. Position t holds p = ((t / 4) ^ r) * 4 + t % 4
    (the 128-byte swizzle), and p holds column 8 (p % 4) + 2 (p / 8) +
    (p % 8) / 4, which gives each thread's wgmma fragment of a tile in 8
    consecutive columns of x."""
    cols = [
        [8 * (p % 4) + 2 * (p // 8) + (p % 8) // 4
         for p in (((t // 4) ^ r) * 4 + t % 4 for t in range(KT))]
        for r in range(8)
    ]
    return torch.tensor(cols, dtype=torch.long, device=device)


def prepare_weight(w: torch.Tensor) -> KernelWeight:
    """A (k, n) f32 weight in the kernels' layout (:class:`KernelWeight`),
    on ``w``'s device."""
    k, n = w.shape
    kt, n_pad = -(-k // KT), round_up(n, NT)
    wt = torch.zeros((n_pad, kt * KT), dtype=torch.float32, device=w.device)
    wt[:n, :k] = w.T
    slabs = torch.empty_like(wt)
    base = KT * torch.arange(kt, device=w.device)[:, None]
    cols = _slab_columns(w.device)
    for r in range(8):
        slabs[r::8] = wt[r::8].index_select(1, (base + cols[r]).view(-1))
    hi, lo = tf32_split(slabs.view(n_pad, kt, KT).transpose(0, 1))
    return KernelWeight(torch.stack([hi, lo]), k, n)


def _lib():
    lib = load_library("denoise_mlp")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.denoise_layer1, lib.denoise_layer2):
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
            fn.restype = i
        lib.denoise_layer1_partial.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.denoise_layer1_partial.restype = i
        for fn in (lib.denoise_splits, lib.denoise_tile_n):
            fn.argtypes = [i, i, i, i]
            fn.restype = i
        lib._typed = True
    return lib


@functools.cache
def _plan(m: int, n: int, k: int, form: str, device: torch.device) -> tuple[int, int, int]:
    """``(splits, tile_n, blocks)`` for an (M, K) x (K, N) product in
    ``form`` on this card: the gemm form's split-K count and tile width
    (ctypes calls once per shape) and blocks 0, or the strip form's
    persistent grid (``blocks`` > 0)."""
    n_sm = sm_count(device)
    if form == "strip":
        return 1, STRIP_N, strip_blocks(m, n, n_sm)
    lib = _lib()
    splits = lib.denoise_splits(m, n, k, n_sm)
    return splits, lib.denoise_tile_n(m, n, splits, n_sm), 0


def _on_cuda(what: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one
    (the kernel runs); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def _check(what: str, name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: {name} must be f32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want {shape}")
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
    return t.contiguous()


def _out_dim(w) -> int:
    return w.n if isinstance(w, KernelWeight) else w.shape[1]


def _weight(what: str, name: str, w, k: int, n: int, device: torch.device) -> KernelWeight:
    """``w`` as the kernel takes it: a (k, n) f32 tensor prepared here, or
    a :class:`KernelWeight` checked against the layout."""
    if not isinstance(w, KernelWeight):
        return prepare_weight(_check(what, name, w, (k, n), device))
    if (w.k, w.n) != (k, n):
        raise ValueError(f"{what}: {name} was prepared for ({w.k}, {w.n}), want ({k}, {n})")
    _check(what, name, w.data, (2, -(-k // KT), round_up(n, NT), KT), device)
    if not w.data.is_contiguous():
        raise ValueError(f"{what}: {name} is not in the kernel's layout (not contiguous)")
    return w


def _form(what: str, k: int, form: str | None) -> str:
    """``form`` checked for a contraction ``k`` deep (None:
    :func:`denoise_form`'s); checked on the CPU too, where the plain
    version runs whatever the form."""
    if form is None:
        return denoise_form(k)
    if form not in FORMS or (form == "strip" and k > STRIP_MAX_K):
        raise ValueError(f"{what}: no {form!r} form for a contraction {k} deep")
    return form


def _launch(what: str, a: torch.Tensor, w: KernelWeight, e: torch.Tensor | None, form: str) -> torch.Tensor:
    """``epilogue(a (M, K) @ w (K, N), e)`` by kernel ``what`` (no ``e``:
    the raw product) in ``form``, with the split-K scratch the gemm form
    asks for."""
    lib = _lib()
    (m, k), n, dev = a.shape, w.n, a.device
    splits, tile_n, blocks = _plan(m, n, k, form, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=dev) if splits > 1 else None
    ptrs = (a.data_ptr(), w.data.data_ptr()) + (() if e is None else (e.data_ptr(),))
    check_launch(
        getattr(lib, what)(
            *ptrs, out.data_ptr(), None if part is None else part.data_ptr(),
            m, k, n, splits, tile_n, blocks, torch.cuda.current_stream(dev).cuda_stream,
        ),
        what,
    )
    LAUNCHES[what] += 1
    return out


def _plain_weight(what: str, w) -> torch.Tensor:
    if isinstance(w, KernelWeight):
        raise ValueError(f"{what}: a prepared weight is for the card; on the CPU pass the tensor")
    return w


def denoise_layer1(x: torch.Tensor, w1x, temb_proj: torch.Tensor, form: str | None = None) -> torch.Tensor:
    """K2, ``tanh(x @ w1x + temb_proj)``: the hand kernel for CUDA tensors,
    the plain version for CPU tensors (only there). x (B, K), temb_proj (B,
    H) with b1 folded in, f32; w1x a (K, H) f32 tensor or, on the card, its
    :class:`KernelWeight`. ``form`` names the kernel's form where a caller
    holds one against the other (default: :func:`denoise_form`'s)."""
    form = _form("denoise_layer1", x.shape[1], form)
    if not _on_cuda("denoise_layer1", x):
        return layer1_plain(x, _plain_weight("denoise_layer1", w1x), temb_proj)
    (B, K), H, dev = x.shape, _out_dim(w1x), x.device
    return _launch(
        "denoise_layer1",
        _check("denoise_layer1", "x", x, (B, K), dev),
        _weight("denoise_layer1", "w1x", w1x, K, H, dev),
        _check("denoise_layer1", "temb_proj", temb_proj, (B, H), dev),
        form,
    )


def denoise_layer1_partial(x: torch.Tensor, w1x, form: str | None = None) -> torch.Tensor:
    """K2's partial product ``x @ w1x`` (the ``kNone`` epilogue: no tanh, no
    addend), the part of one catalog shard: the hand kernel for CUDA
    tensors, the plain version for CPU tensors (only there). x (B, K) f32;
    w1x a (K, H) f32 tensor or, on the card, its :class:`KernelWeight`;
    ``form`` as for :func:`denoise_layer1`. A build or launch that fails
    raises."""
    form = _form("denoise_layer1_partial", x.shape[1], form)
    if not _on_cuda("denoise_layer1_partial", x):
        return layer1_partial_plain(x, _plain_weight("denoise_layer1_partial", w1x))
    (B, K), H, dev = x.shape, _out_dim(w1x), x.device
    return _launch(
        "denoise_layer1_partial",
        _check("denoise_layer1_partial", "x", x, (B, K), dev),
        _weight("denoise_layer1_partial", "w1x", w1x, K, H, dev),
        None,
        form,
    )


def denoise_layer2(h: torch.Tensor, w2, b2: torch.Tensor, form: str | None = None) -> torch.Tensor:
    """K3, ``h @ w2 + b2``: the hand kernel for CUDA tensors, the plain
    version for CPU tensors (only there). h (B, H), b2 (N,), f32; w2 an
    (H, N) f32 tensor or, on the card, its :class:`KernelWeight`; ``form``
    as for :func:`denoise_layer1`."""
    form = _form("denoise_layer2", h.shape[1], form)
    if not _on_cuda("denoise_layer2", h):
        return layer2_plain(h, _plain_weight("denoise_layer2", w2), b2)
    (B, H), N, dev = h.shape, _out_dim(w2), h.device
    return _launch(
        "denoise_layer2",
        _check("denoise_layer2", "h", h, (B, H), dev),
        _weight("denoise_layer2", "w2", w2, H, N, dev),
        _check("denoise_layer2", "b2", b2, (N,), dev),
        form,
    )


@dataclasses.dataclass(frozen=True)
class PreparedDenoiser:
    """A single-hidden-layer denoiser as the rebuild runs it: the time
    embedding's layer and W1's time rows in the JAX layout, W1x and W2 as
    :class:`KernelWeight` on the card (the plain (I, H) and (H, I) tensors
    on the CPU)."""

    emb_w: torch.Tensor
    emb_b: torch.Tensor
    w1_time: torch.Tensor
    b1: torch.Tensor
    w1x: torch.Tensor | KernelWeight
    w2: torch.Tensor | KernelWeight
    b2: torch.Tensor


def prepare_denoiser(params) -> PreparedDenoiser:
    """A denoiser's params (the JAX layout) in the form K2/K3 take."""
    if len(params["in_layers"]) != 1 or len(params["out_layers"]) != 1:
        raise NotImplementedError(
            "the denoise_mlp kernels take a single hidden layer; a deeper "
            "denoiser's rebuild runs the plain f32 forward instead "
            "(train/steps.py::rebuild_forward, ROADMAP.md A4)"
        )
    w1 = params["in_layers"][0]["w"]  # (I + d_emb, H)
    item_num = w1.shape[0] - params["emb"]["w"].shape[0]
    w2 = params["out_layers"][0]["w"]
    prep = prepare_weight if w1.device.type == "cuda" else (lambda w: w)
    return PreparedDenoiser(
        params["emb"]["w"], params["emb"]["b"], w1[item_num:], params["in_layers"][0]["b"],
        prep(w1[:item_num]), prep(w2), params["out_layers"][0]["b"],
    )


def denoise_forward_fused(params, x_t: torch.Tensor, timesteps: torch.Tensor, group=None) -> torch.Tensor:
    """The denoiser forward without modality conditioning, through K2/K3.

    Counterpart of ``denoise_forward_pallas`` with ``modal_feat=None``, the
    only form the rebuild reaches (``p_mean`` passes no modality features).
    ``params`` is a :class:`PreparedDenoiser` (the rebuild's) or, for a
    single call as the tests make one, a params dict, prepared here per
    call. The time embedding's projection ``t @
    W1[I:] + b1`` is a (B, d_emb) x (d_emb, H) product computed here,
    outside the kernels.

    Without a model axis ``group`` K2 applies the tanh in its epilogue
    (:func:`denoise_layer1`). With one (x_t and the prepared weights are
    then the rank's catalog columns and rows, and so is the output) K2 runs
    as its partial product (:func:`denoise_layer1_partial`), summed over
    the axis, then ``tanh(s + temb_proj)``. K3 gives the output columns."""
    p = params if isinstance(params, PreparedDenoiser) else prepare_denoiser(params)
    emb = timestep_embedding(timesteps, p.emb_w.shape[0])
    time_emb = emb @ p.emb_w + p.emb_b
    temb_proj = time_emb @ p.w1_time + p.b1
    if group is None:
        h = denoise_layer1(x_t, p.w1x, temb_proj)
    else:
        s = all_reduce_sum_(denoise_layer1_partial(x_t, p.w1x), group)
        h = torch.tanh(s + temb_proj)
    return denoise_layer2(h, p.w2, p.b2)
